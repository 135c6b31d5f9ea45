"""Checkpoints restored onto a mesh (``CheckpointManager.restore(
sharding=)``, ``checkpoint.sharded.restore_sharded(sharding=)``),
resharding 4 -> 2 -> 1, against the JAX package's restore, on the CPU.

One 4-rank gloo world (``test_torch_mesh.spawn_world``) places a
``TensorParallelMLP`` with the JAX package's weights over ``{"tp": 4}``
and saves it as a sharded step (each rank writes its shards); then
restores it onto ``{"dp": 2, "tp": 2}`` -- through ``restore(sharding=)``
and ``restore_sharded(sharding=)``, each rank keeping its shard, and
through ``restore_training`` into the block placed at ``tp=2`` -- and
at one rank (every array whole).  Every parameter must equal its full
array: the JAX package's values, and what the JAX package's own
``restore(sharding=)`` puts on its ``tp=2`` mesh from the same step.
"""
import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as jmx
from mxnet_tpu.checkpoint import CheckpointManager as JCheckpointManager
from mxnet_tpu.parallel import (TensorParallelMLP as JTensorParallelMLP,
                                make_mesh as jmake_mesh)

from mxnet_tpu_torch.checkpoint import CheckpointManager

from test_torch_mesh import WORKER_HEAD, load_ranks, spawn_world

SPECS = {"up.weight": ("tp", None), "up.bias": ("tp",),
         "down.weight": (None, "tp"), "down.bias": ()}

_WORKER = WORKER_HEAD + r"""
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.checkpoint import sharded
from mxnet_tpu_torch.parallel import (NamedSharding, PartitionSpec,
                                      TensorParallelMLP, make_mesh)

SPECS = {"up.weight": ("tp", None), "up.bias": ("tp",),
         "down.weight": (None, "tp"), "down.bias": ()}
root = os.path.join(out_dir, "ckpt")


def mlp_on(mesh):
    mlp = TensorParallelMLP(32, 16, mesh=mesh)
    mlp.initialize(ctx=mx.cpu())
    with autograd.pause():
        mlp(torch.zeros(1, 16))
    return mlp


with mx.cpu():
    m4 = make_mesh({"tp": 4}, device="cpu")
    mlp = mlp_on(m4)
    params_from_numpy(mlp, weights_in("mlp."))
    mlp.shard(m4)
    for k, p in mlp._collect_params_with_prefix().items():
        arrays["tp4." + k] = p.data()._data.detach().numpy().copy()
    mgr = CheckpointManager(root)
    values["sharded_save"] = mgr._use_sharded()
    mgr.save_training(1, mlp)

    m2 = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    values["tp2_index"] = m2.axis_index("tp")

    def to_m2(item, key, shape):
        return NamedSharding(m2, PartitionSpec(*SPECS[key]))
    ckpt = CheckpointManager(root).restore(sharding=to_m2)
    for k, v in ckpt.items["params"].items():
        arrays["restore." + k] = v._data.numpy()
    items, _n = sharded.restore_sharded(
        mgr.step_dir(1), mgr._verify_step(1), sharding=to_m2)
    for k, v in items["params"].items():
        arrays["restore_sharded." + k] = v._data.numpy()

    mlp2 = mlp_on(m2)
    mlp2.shard(m2)
    CheckpointManager(root).restore_training(mlp2)
    for k, p in mlp2._collect_params_with_prefix().items():
        arrays["training." + k] = p.data()._data.detach().numpy().copy()

    whole = CheckpointManager(root).restore()
    for k, v in whole.items["params"].items():
        arrays["whole." + k] = v._data.numpy()
finish()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    jmx.random.seed(0)
    mlp = JTensorParallelMLP(32, 16)
    mlp.initialize()
    mlp(jmx.nd.zeros((1, 16)))
    full = {k: p.data().asnumpy()
            for k, p in mlp._collect_params_with_prefix().items()}
    np.savez(str(tmp / "inputs.npz"),
             **{"mlp." + k: v for k, v in full.items()})
    spawn_world(tmp, _WORKER)
    return {"ranks": load_ranks(tmp), "full": full, "root": tmp / "ckpt"}


def _slice(full, spec, index, n):
    spec = tuple(spec) + (None,) * (full.ndim - len(spec))
    out = full
    for d, a in enumerate(spec):
        if a == "tp":
            step = full.shape[d] // n
            out = np.take(out, range(index * step, (index + 1) * step),
                          axis=d)
    return out


def test_saved_at_tp4_as_each_ranks_shard(world):
    for r, (arrays, vals) in enumerate(world["ranks"]):
        assert vals["sharded_save"] is True
        for k, spec in SPECS.items():
            np.testing.assert_array_equal(
                arrays["tp4." + k], _slice(world["full"][k], spec, r, 4))


@pytest.mark.parametrize("route", ["restore", "restore_sharded", "training"])
def test_restored_at_tp2(world, route):
    for arrays, vals in world["ranks"]:
        for k, spec in SPECS.items():
            np.testing.assert_array_equal(
                arrays[route + "." + k],
                _slice(world["full"][k], spec, vals["tp2_index"], 2))


def test_restored_whole_at_one_rank(world):
    for arrays, _vals in world["ranks"]:
        for k in SPECS:
            np.testing.assert_array_equal(arrays["whole." + k],
                                          world["full"][k])
    # this (world-less) process restores the sharded step whole
    ckpt = CheckpointManager(str(world["root"])).restore()
    for k in SPECS:
        np.testing.assert_array_equal(ckpt.items["params"][k].asnumpy(),
                                      world["full"][k])


def test_jax_restores_the_ports_step_onto_its_tp2_mesh(world):
    mesh = jmake_mesh({"dp": 2, "tp": 2}, devices=jax.devices("cpu")[:4])
    ckpt = JCheckpointManager(str(world["root"])).restore(
        sharding=lambda item, key, shape: NamedSharding(mesh,
                                                        P(*SPECS[key])))
    for k in SPECS:
        arr = ckpt.items["params"][k]._data
        np.testing.assert_array_equal(np.asarray(arr), world["full"][k])
        assert arr.sharding.spec == P(*SPECS[k])
