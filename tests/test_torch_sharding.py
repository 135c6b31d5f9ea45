"""The port's sharding sanitizer (``mxnet_tpu_torch.analysis.sharding``)
against the JAX package's, on the CPU.

- **The project rule on the JAX tests' trees.**  Every ``tmp_path``
  tree that ``tests/test_sharding.py`` writes goes through both
  packages' ``audit_sharding`` (the tree, and each file alone) and
  ``declared_axes``: the same (rule, file, line, severity, message).
  The per-file rules run on the same sources in ``tests/
  test_torch_analysis.py``'s corpus.  The port's own tree is clean, as
  the JAX test holds the JAX package's.
- **The collective contract.**  One 4-rank gloo world
  (``test_torch_mesh.spawn_world``) with ``MXNET_TPU_SHARD_CHECK=1``
  trains the JAX test's LeNet with ``TrainStep`` over ``{"dp": 4}``;
  the walk of its warm-up gives the step's collectives by kind
  (all-reduce only: the gradient bucket), saved as the JAX package's
  ``mxshard.collectives.v1`` artifact; a seeded spec mismatch (the two
  Dense layers split over ``dp`` as a column/row pair) adds
  collectives, which ``diff_contract``
  and ``--collective-diff`` flag naming the step -- with the same
  diagnostics and exit codes as the JAX package's on the same
  artifacts.
- ``transfer_guard``/``install_transfer_guard``, the env registry and
  ``runtime.Features()``'s ``SHARD_CHECK`` row.
"""
import ast
import json
import os
from pathlib import Path

import pytest

from mxnet_tpu import analysis as jan
from mxnet_tpu import env as jenv
from mxnet_tpu.analysis import sharding as jsh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.analysis import sharding as tsh
from mxnet_tpu_torch.base import MXNetError

from test_torch_mesh import WORKER_HEAD, load_ranks, spawn_world

REPO = Path(__file__).resolve().parent.parent


def _trees():
    """``(test name, {file name: source})`` of every tree a test of
    ``tests/test_sharding.py`` writes with ``(tmp_path / name)
    .write_text(source)``."""
    tree = ast.parse((REPO / "tests" / "test_sharding.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        files = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) \
                    and node.func.attr == "write_text" \
                    and isinstance(node.func.value, ast.BinOp) \
                    and isinstance(node.func.value.right, ast.Constant) \
                    and node.args:
                try:
                    src = ast.literal_eval(node.args[0])
                except ValueError:
                    continue
                if isinstance(src, str):
                    files[node.func.value.right.value] = src
        if files and all(n.endswith(".py") for n in files):
            out.append((fn.name, files))
    return out


TREES = _trees()


def _quads(diags):
    return sorted((d.rule, os.path.basename(d.file or ""), d.line,
                   d.severity, d.message) for d in diags)


def test_the_jax_tests_write_trees():
    assert len(TREES) >= 4


@pytest.mark.parametrize("case", TREES, ids=[c[0] for c in TREES])
def test_audit_sharding_agrees_on_the_jax_tests_trees(case, tmp_path):
    _name, files = case
    for fname, src in files.items():
        (tmp_path / fname).write_text(src)
    paths = [str(tmp_path)]
    assert _quads(tsh.audit_sharding(paths)) == \
        _quads(jsh.audit_sharding(paths))
    assert tsh.declared_axes(paths) == jsh.declared_axes(paths)
    for fname in files:
        one = [str(tmp_path / fname)]
        assert _quads(tsh.audit_sharding(one)) == \
            _quads(jsh.audit_sharding(one))


def test_the_ports_axes_are_all_declared():
    assert tsh.audit_sharding([str(REPO / "mxnet_tpu_torch")]) == []
    from mxnet_tpu_torch.parallel.mesh import AXIS_ROLES
    from mxnet_tpu.parallel.mesh import AXIS_ROLES as JAXIS_ROLES
    assert list(AXIS_ROLES) == list(JAXIS_ROLES)


def test_the_cli_runs_the_project_rule(tmp_path):
    (tmp_path / "a.py").write_text("from jax.sharding import "
                                   "PartitionSpec as P\nbad = P('dpp')\n")
    args = [str(tmp_path), "--json"]
    assert tan.main(args) == jan.main(args) == 1


_WORKER = WORKER_HEAD + r"""
from mxnet_tpu_torch import profiling, runtime
from mxnet_tpu_torch.analysis import sharding
from mxnet_tpu_torch.parallel import (PartitionSpec, TrainStep, make_mesh)
from mxnet_tpu_torch.parallel.tensor_parallel import place_param

values["profiling"] = profiling.enabled()
values["shard_check_row"] = runtime.Features().is_enabled("SHARD_CHECK")
with mx.cpu():
    mesh = make_mesh({"dp": 4}, device="cpu")
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(6, 5, padding=2, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Conv2D(16, 3, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(32, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(ctx=mx.cpu(), generator=torch.Generator().manual_seed(0))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=None)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                     mesh=mesh)
    x, y = inp["x"][rank * 4:(rank + 1) * 4], inp["y"][rank * 4:(rank + 1) * 4]
    step(x, y)
    base = os.path.join(out_dir, "baseline%d.json" % rank)
    sharding.save_contract(base)

    # a seeded spec mismatch: the two Dense layers split over dp (the
    # batch axis) as a column/row pair, where they must be replicated
    place_param(net[5].weight, mesh, PartitionSpec("dp", None))
    place_param(net[5].bias, mesh, PartitionSpec("dp"))
    place_param(net[6].weight, mesh, PartitionSpec(None, "dp"))
    profiling.store.clear()
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                     mesh=mesh)
    step(x, y)
    sharding.save_contract(os.path.join(out_dir, "current%d.json" % rank))
finish()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import numpy as np
    tmp = tmp_path_factory.mktemp("shard")
    rng = np.random.RandomState(0)
    np.savez(str(tmp / "inputs.npz"),
             x=rng.rand(16, 1, 16, 16).astype(np.float32),
             y=rng.randint(0, 10, (16,)).astype(np.float32))
    spawn_world(tmp, _WORKER, env={"MXNET_TPU_SHARD_CHECK": "1"})
    return {"ranks": load_ranks(tmp), "tmp": tmp}


LABEL = "train_step:HybridSequential"


def test_shard_check_arms_the_walk(world):
    for _arrays, vals in world["ranks"]:
        assert vals["profiling"] is True
        assert vals["shard_check_row"] is True
    assert tmx.runtime.Features().is_enabled("SHARD_CHECK") is False


def test_the_contract_blesses_the_gradient_all_reduce(world):
    for r in range(4):
        base = tsh.load_contract(str(world["tmp"] / ("baseline%d.json" % r)))
        assert base["schema"] == "mxshard.collectives.v1"
        assert base["n_devices"] == 4
        assert set(base["executables"]) == {LABEL}
        assert set(base["executables"][LABEL]) == {"all-reduce"}
        assert base["executables"][LABEL]["all-reduce"]["count"] == 1
        # the JAX package reads the port's artifact
        assert jsh.load_contract(str(world["tmp"] / ("baseline%d.json"
                                                      % r))) == base


def test_contract_self_diff_is_clean_in_both_packages(world):
    path = str(world["tmp"] / "baseline0.json")
    base = tsh.load_contract(path)
    assert tsh.diff_contract(base, base) == jsh.diff_contract(base, base) \
        == []
    assert tan.main(["--collective-diff", path, path]) == \
        jan.main(["--collective-diff", path, path]) == 0


def test_a_seeded_spec_mismatch_is_flagged_as_by_jax(world):
    bpath = str(world["tmp"] / "baseline0.json")
    cpath = str(world["tmp"] / "current0.json")
    base, cur = tsh.load_contract(bpath), tsh.load_contract(cpath)
    assert cur["executables"][LABEL]["all-reduce"]["count"] > \
        base["executables"][LABEL]["all-reduce"]["count"]
    got = tsh.diff_contract(base, cur)
    assert got and any(LABEL in d.message for d in got)
    want = jsh.diff_contract(base, cur)
    assert [(d.rule, d.node, d.severity) for d in got] == \
        [(d.rule, d.node, d.severity) for d in want]
    assert tan.main(["--collective-diff", bpath, cpath]) == \
        jan.main(["--collective-diff", bpath, cpath]) == 1


def test_diff_contract_agrees_on_the_jax_tests_artifacts():
    """Same findings (rule, step, severity; the wording names the
    port's captured step where the JAX package's names GSPMD)."""
    base = {"schema": tsh.CONTRACT_SCHEMA, "executables": {
        "step": {"all-reduce": {"count": 2, "bytes": 100}}}}
    for cur in ({"step": {"all-reduce": {"count": 3, "bytes": 150}}},
                {"other": {"all-gather": {"count": 1, "bytes": 10}}},
                {"step": {"all-reduce": {"count": 1, "bytes": 50}}},
                {"step": {"all-reduce": {"count": 2, "bytes": 400}}}):
        cur = {"schema": tsh.CONTRACT_SCHEMA, "executables": cur}
        got, want = tsh.diff_contract(base, cur), jsh.diff_contract(base,
                                                                   cur)
        assert [(d.rule, d.node, d.severity) for d in got] == \
            [(d.rule, d.node, d.severity) for d in want]


def test_contract_load_rejects_foreign_json(tmp_path):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"schema": "other", "executables": {}}))
    with pytest.raises(ValueError, match="mxshard.collectives.v1"):
        tsh.load_contract(str(p))
    assert tan.main(["--collective-diff", str(p), str(p)]) == \
        jan.main(["--collective-diff", str(p), str(p)]) == 2


@pytest.mark.parametrize("op,kind", [
    ("allreduce_", "all-reduce"),
    ("_allgather_base_", "all-gather"),
    ("allgather_into_tensor_coalesced_", "all-gather"),
    ("_reduce_scatter_base_", "reduce-scatter"),
    ("reduce_scatter_tensor_coalesced_", "reduce-scatter"),
    ("alltoall_base_", "all-to-all"),
    ("send", "collective-permute"), ("recv_", "collective-permute"),
    ("broadcast_", "broadcast")])
def test_collective_profile_names_c10d_calls_by_jax_kind(op, kind):
    """The walk charges a c10d call to the JAX package's HLO kind, with
    its payload (the real world's profiles are tests/
    test_torch_mesh.py's)."""
    import torch
    from mxnet_tpu_torch.profiling import aten
    walk = aten.Walk()
    walk._count_collective(op, ([torch.ones(8)], None))
    assert tsh.collective_profile(walk) == {kind: {"count": 1, "bytes": 32}}


def test_transfer_guard_modes():
    for mode in ("allow", "log", "disallow", "log_explicit",
                 "disallow_explicit"):
        with tsh.transfer_guard(mode):
            pass
    with pytest.raises(MXNetError, match="not one of"):
        tsh.install_transfer_guard("sometimes")
    assert tsh.install_transfer_guard("") is None


def test_env_vars_registered_as_jaxs():
    for name in ("MXNET_TPU_SHARD_CHECK", "MXNET_TPU_TRANSFER_GUARD"):
        t, j = tenv.REGISTRY[name], jenv.REGISTRY[name]
        assert (t.type, t.default) == (j.type, j.default)


def test_sharding_rules_registered_and_listed():
    ids = {r.id for r in tan.list_rules()}
    assert {"mesh-axis-unknown", "shard-map-spec-arity",
            "undonated-train-state", "donated-reuse", "implicit-reshard",
            "collective-drift"} <= ids
