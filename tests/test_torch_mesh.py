"""The port's meshes and data-parallel step against the JAX package's
(``mxnet_tpu_torch.parallel``: ``make_mesh``, ``shard_batch``,
``split_and_load``, ``replicate_block``, ``TrainStep(mesh=)``,
``run_steps`` on a mesh, the feed's and ``DataLoader``'s mesh route),
on the CPU.

One 4-rank gloo world (``spawn_world``: four ``python`` processes of a
worker that imports no JAX) runs every case once for the module, each
rank writing its results; the cases read them and hold them against
the JAX package on 4 of its 8 forced CPU devices, at the JAX tests'
tolerances (``rtol=2e-4, atol=1e-5``, ``tests/test_parallel.py``).
Each rank's batch is its process-local slice of the JAX step's global
batch, so the mesh step must equal the single-program step on the
global batch -- BatchNorm's statistics (running statistics included)
are the global batch's, not each rank's.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.parallel import (TrainStep as JTrainStep,
                                make_mesh as jmake_mesh,
                                shard_batch as jshard_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

RANKS = 4
TOL = dict(rtol=2e-4, atol=1e-5)


def spawn_world(tmp_path, script, n=RANKS, timeout=240, env=None):
    """Run ``script`` (a worker's source) as ``n`` ranks of one gloo
    world; each gets ``tmp_path`` as its argument (and ``env`` in its
    environment).  Returns the ranks' outputs; raises with every rank's
    output when one fails."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(n):
        renv = dict(os.environ,
                    PYTHONPATH=REPO + os.pathsep
                    + os.environ.get("PYTHONPATH", ""),
                    MXNET_TPU_COORDINATOR=coord,
                    MXNET_TPU_NUM_PROCS=str(n), MXNET_TPU_PROC_ID=str(rank),
                    MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="60000",
                    OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(path), str(tmp_path)], env=renv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        outs.append((p.returncode, text))
    if any(rc != 0 for rc, _ in outs):
        raise AssertionError("\n".join(
            "rank %d rc %s:\n%s" % (r, rc, text[-4000:])
            for r, (rc, text) in enumerate(outs)))
    return outs


def load_ranks(tmp_path, n=RANKS):
    """Each rank's ``rank<r>.npz`` arrays and ``rank<r>.json`` values."""
    out = []
    for r in range(n):
        arrays = dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
        with open(str(tmp_path / ("rank%d.json" % r))) as f:
            out.append((arrays, json.load(f)))
    return out


# the worker's preamble, shared with the other mesh test files
WORKER_HEAD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.parallel import collectives
from mxnet_tpu_torch.gluon.convert import params_from_numpy
import torch.distributed as dist

out_dir = sys.argv[1]
assert mx.distributed_init() is True
rank = dist.get_rank()
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
arrays, values = {}, {}


def tensors(net):
    return {k: p.data()._data.detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def weights_in(prefix):
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def finish():
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **arrays)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(values, f)
    dist.barrier()
"""

_WORKER = WORKER_HEAD + r"""
from mxnet_tpu_torch.dataio import DeviceFeed
from mxnet_tpu_torch.parallel import (TrainStep, make_mesh, replicate_block,
                                      shard_batch, split_and_load)
from mxnet_tpu_torch.parallel.mesh import global_shape_of, sharding_of

with mx.cpu():
    mesh = make_mesh({"dp": 4}, device="cpu")
    values["shape_dp"] = dict(mesh.shape)
    values["shape_all"] = dict(make_mesh({"dp": -1}, device="cpu").shape)
    values["shape_2d"] = dict(make_mesh({"dp": 2, "mp": 2},
                                        device="cpu").shape)
    for key, axes in (("err_infer", {"dp": 3, "mp": -1}),
                      ("err_big", {"dp": 8})):
        try:
            make_mesh(axes, device="cpu")
            values[key] = None
        except mx.MXNetError as e:
            values[key] = str(e)

    # shard_batch / split_and_load: the local slice, the global shape
    x16 = inp["x16"]
    local = x16[rank * 4:(rank + 1) * 4]
    sx = shard_batch(local, mesh)
    arrays["shard_local"] = sx._data.numpy()
    values["shard_global"] = list(global_shape_of(sx))
    values["shard_spec"] = list(sharding_of(sx).spec)
    sl = split_and_load(local, mesh=mesh)
    values["split_len"] = len(sl)
    values["split_global"] = list(global_shape_of(sl[0]))

    # replicate_block: rank 0's values on every rank
    rep = gluon.nn.Dense(4, in_units=3)
    rep.initialize(ctx=mx.cpu(),
                   generator=torch.Generator().manual_seed(100 + rank))
    arrays["rep_before"] = rep.weight.data()._data.detach().numpy().copy()
    replicate_block(rep, mesh)
    arrays["rep_after"] = rep.weight.data()._data.detach().numpy().copy()

    def bn_net():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(8), gluon.nn.BatchNorm(), gluon.nn.Dense(2))
        net.initialize(ctx=mx.cpu())
        with autograd.pause():
            net(torch.zeros(1, 4))
        params_from_numpy(net, weights_in("bn."))
        return net

    # TrainStep(mesh=) with BatchNorm: the global batch's step
    X, Y = inp["bn_x"], inp["bn_y"]
    b = X.shape[0] // 4
    net = bn_net()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore=None)
    step = TrainStep(net, gluon.loss.L2Loss(), tr, mesh=mesh)
    losses = []
    collectives.reset_counts()
    for i in range(3):
        losses.append(float(step(X[rank * b:(rank + 1) * b],
                                 Y[rank * b:(rank + 1) * b])))
        if i == 0:
            arrays["bn_rm1"] = \
                net[1].running_mean.data()._data.numpy().copy()
            values["bn_step_calls"] = collectives.counts()
    values["bn_losses"] = losses
    for k, v in tensors(net).items():
        arrays["bn_final." + k] = v
    rep_ = step.cost_report()
    values["bn_walk_collectives"] = \
        rep_["categories"]["collective"]["instructions"]
    values["bn_walk_kinds"] = rep_.get("collectives", {})
    values["bn_buckets"] = step._buckets

    # Adam with a FactorScheduler on a mesh: t, lr and states follow
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    with autograd.pause():
        net(torch.zeros(1, 8))
    params_from_numpy(net, weights_in("adam."))
    sched = mx.optimizer.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.01, "lr_scheduler": sched},
                       kvstore=None)
    step = TrainStep(net, gluon.loss.L2Loss(), tr, mesh=mesh)
    X, Y = inp["adam_x"], inp["adam_y"]
    b = X.shape[0] // 4
    values["adam_losses"] = [float(step(X[rank * b:(rank + 1) * b],
                                        Y[rank * b:(rank + 1) * b]))
                             for _ in range(11)]
    values["adam_num_update"] = tr._optimizer.num_update
    for k, v in tensors(net).items():
        arrays["adam_final." + k] = v

    # a frozen parameter survives the mesh step
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    with autograd.pause():
        net(torch.zeros(1, 8))
    params_from_numpy(net, weights_in("frozen."))
    net[0].weight.grad_req = "null"
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=None)
    step = TrainStep(net, gluon.loss.L2Loss(), tr, mesh=mesh)
    X, Y = inp["frozen_x"], inp["frozen_y"]
    b = X.shape[0] // 4
    for _ in range(3):
        step(X[rank * b:(rank + 1) * b], Y[rank * b:(rank + 1) * b])
    for k, v in tensors(net).items():
        arrays["frozen_final." + k] = v

    # run_steps on a mesh: the K-step block, batches split per step
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    with autograd.pause():
        net(torch.zeros(1, 6))
    params_from_numpy(net, weights_in("scan."))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=None)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                     mesh=mesh)
    X, Y = inp["scan_x"], inp["scan_y"]
    b = X.shape[1] // 4
    arrays["scan_losses"] = step.run_steps(
        X[:, rank * b:(rank + 1) * b], Y[:, rank * b:(rank + 1) * b]) \
        .numpy()
    for k, v in tensors(net).items():
        arrays["scan_final." + k] = v

    # the feed's and the DataLoader's mesh route
    feed = DeviceFeed(iter([(local, local[:, 0])]), mesh=mesh)
    fb = next(feed)
    values["feed_global"] = [list(global_shape_of(a)) for a in fb]
    arrays["feed_local"] = fb.data._data.numpy()
    feed.close()
    dl = gluon.data.DataLoader(
        gluon.data.ArrayDataset(local, local[:, 0]), batch_size=4,
        mesh=mesh)
    db = next(iter(dl))
    values["loader_global"] = [list(global_shape_of(a)) for a in db]
finish()
"""


def _jax_arrays(net, prefix):
    return {prefix + k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jax_mlp(seed, in_units):
    jmx.random.seed(seed)
    np.random.seed(seed)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    net.initialize(ctx=jmx.cpu())
    net(jmx.nd.zeros((1, in_units)))
    return net


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side and the port's 4-rank world, once."""
    tmp = tmp_path_factory.mktemp("mesh")
    devs = jax.devices("cpu")[:RANKS]
    mesh = jmake_mesh({"dp": RANKS}, devices=devs)
    rng = np.random.RandomState(0)
    inp = {"x16": np.arange(64, dtype=np.float32).reshape(16, 4)}
    ref = {}

    # BatchNorm net: three SGD steps on the global batch of 16
    jmx.random.seed(0)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(8), jgluon.nn.BatchNorm(), jgluon.nn.Dense(2))
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.zeros((1, 4)))
    inp.update(_jax_arrays(jnet, "bn."))
    inp["bn_x"] = rng.randn(16, 4).astype(np.float32) + 3.0
    inp["bn_y"] = rng.randn(16, 2).astype(np.float32)
    tr = jgluon.Trainer(jnet.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9},
                        kvstore=None)
    step = JTrainStep(jnet, jgluon.loss.L2Loss(), tr, mesh=mesh)
    ref["bn_losses"] = []
    for i in range(3):
        ref["bn_losses"].append(float(step(
            jmx.nd.array(inp["bn_x"]), jmx.nd.array(inp["bn_y"]))
            .asscalar()))
        if i == 0:
            ref["bn_rm1"] = jnet[1].running_mean.data().asnumpy()
    ref["bn_final"] = {k: p.data().asnumpy() for k, p in
                       jnet._collect_params_with_prefix().items()}

    # Adam + FactorScheduler, eleven steps
    jnet = _jax_mlp(13, 8)
    inp.update(_jax_arrays(jnet, "adam."))
    inp["adam_x"] = rng.randn(16, 8).astype(np.float32)
    inp["adam_y"] = rng.randn(16, 4).astype(np.float32)
    sched = jmx.optimizer.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    tr = jgluon.Trainer(jnet.collect_params(), "adam",
                        {"learning_rate": 0.01, "lr_scheduler": sched},
                        kvstore=None)
    step = JTrainStep(jnet, jgluon.loss.L2Loss(), tr, mesh=mesh)
    ref["adam_losses"] = [float(step(jmx.nd.array(inp["adam_x"]),
                                     jmx.nd.array(inp["adam_y"]))
                                .asscalar()) for _ in range(11)]
    ref["adam_final"] = {k: p.data().asnumpy() for k, p in
                         jnet._collect_params_with_prefix().items()}

    # frozen first weight
    jnet = _jax_mlp(17, 8)
    inp.update(_jax_arrays(jnet, "frozen."))
    inp["frozen_x"] = rng.randn(8, 8).astype(np.float32)
    inp["frozen_y"] = rng.randn(8, 4).astype(np.float32)
    jnet[0].weight.grad_req = "null"
    tr = jgluon.Trainer(jnet.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore=None)
    step = JTrainStep(jnet, jgluon.loss.L2Loss(), tr, mesh=mesh)
    for _ in range(3):
        step(jmx.nd.array(inp["frozen_x"]), jmx.nd.array(inp["frozen_y"]))
    ref["frozen_final"] = {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()}

    # run_steps over the mesh
    jnet = _jax_mlp(3, 6)
    inp.update(_jax_arrays(jnet, "scan."))
    inp["scan_x"] = rng.randn(2, 8, 6).astype(np.float32)
    inp["scan_y"] = rng.randint(0, 4, (2, 8)).astype(np.float32)
    tr = jgluon.Trainer(jnet.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore=None)
    step = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), tr,
                      mesh=mesh)
    ref["scan_losses"] = step.run_steps(jmx.nd.array(inp["scan_x"]),
                                        jmx.nd.array(inp["scan_y"])) \
        .asnumpy()
    ref["scan_final"] = {k: p.data().asnumpy() for k, p in
                         jnet._collect_params_with_prefix().items()}

    np.savez(str(tmp / "inputs.npz"), **inp)
    spawn_world(tmp, _WORKER)
    return {"ranks": load_ranks(tmp), "inp": inp, "ref": ref,
            "mesh": mesh, "devs": devs}


def test_make_mesh_sizes(world):
    devs = world["devs"]
    for arrays, vals in world["ranks"]:
        assert vals["shape_dp"] == {"dp": 4}
        assert vals["shape_all"] == \
            dict(jmake_mesh({"dp": -1}, devices=devs).shape)
        assert vals["shape_2d"] == \
            dict(jmake_mesh({"dp": 2, "mp": 2}, devices=devs).shape)
        for key, axes in (("err_infer", {"dp": 3, "mp": -1}),
                          ("err_big", {"dp": 8})):
            with pytest.raises(JMXNetError) as e:
                jmake_mesh(axes, devices=devs)
            assert vals[key] == str(e.value)


def test_shard_batch_places_the_local_slice(world):
    x = jmx.nd.array(world["inp"]["x16"])
    sx = jshard_batch(x, world["mesh"])
    shards = {s.device.id: np.asarray(s.data)
              for s in sx._data.addressable_shards}
    for r, (arrays, vals) in enumerate(world["ranks"]):
        np.testing.assert_array_equal(arrays["shard_local"],
                                      shards[world["devs"][r].id])
        assert vals["shard_global"] == list(sx.shape)
        assert vals["shard_spec"] == ["dp", None]
        assert vals["split_len"] == 1
        assert vals["split_global"] == list(sx.shape)


def test_replicate_block_takes_rank_zeros_values(world):
    first = world["ranks"][0][0]["rep_before"]
    assert not np.array_equal(first, world["ranks"][1][0]["rep_before"])
    for arrays, _vals in world["ranks"]:
        np.testing.assert_array_equal(arrays["rep_after"], first)


def _final(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _assert_params(arrays, prefix, want):
    got = _final(arrays, prefix)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_train_step_batchnorm_is_the_global_batchs(world):
    ref = world["ref"]
    for arrays, vals in world["ranks"]:
        np.testing.assert_allclose(vals["bn_losses"], ref["bn_losses"],
                                   **TOL)
        np.testing.assert_allclose(arrays["bn_rm1"], ref["bn_rm1"], **TOL)
        _assert_params(arrays, "bn_final.", ref["bn_final"])


def test_train_step_batchnorm_is_not_per_rank_statistics(world):
    """After one step the running mean is the global batch's, which
    differs from what each rank's own batch would give."""
    inp, ref = world["inp"], world["ref"]
    w, b = inp["bn.0.weight"], inp["bn.0.bias"]
    h = inp["bn_x"] @ w.T + b
    glob = 0.1 * h.mean(axis=0)
    np.testing.assert_allclose(ref["bn_rm1"], glob, rtol=1e-4, atol=1e-6)
    for r, (arrays, _vals) in enumerate(world["ranks"]):
        mine = 0.1 * h[r * 4:(r + 1) * 4].mean(axis=0)
        assert np.abs(mine - glob).max() > 1e-3
        assert np.abs(arrays["bn_rm1"] - mine).max() > 1e-3


def test_train_step_collectives_are_buckets_and_batchnorm_sites(world):
    """One BatchNorm site (forward moments, backward sums) and one
    gradient bucket carrying the loss: three all-reduces a step, as the
    profiling walk counts them."""
    for _arrays, vals in world["ranks"]:
        assert vals["bn_buckets"] == 1
        assert vals["bn_step_calls"]["all_reduce"]["calls"] == 1 + 2 * 1
        assert vals["bn_walk_collectives"] == 3
        assert vals["bn_walk_kinds"]["all-reduce"]["count"] == 3


def test_train_step_adam_scheduler_and_states(world):
    ref = world["ref"]
    for arrays, vals in world["ranks"]:
        assert vals["adam_num_update"] == 11
        np.testing.assert_allclose(vals["adam_losses"], ref["adam_losses"],
                                   **TOL)
        _assert_params(arrays, "adam_final.", ref["adam_final"])


def test_train_step_frozen_params_survive(world):
    inp, ref = world["inp"], world["ref"]
    for arrays, _vals in world["ranks"]:
        np.testing.assert_array_equal(arrays["frozen_final.0.weight"],
                                      inp["frozen.0.weight"])
        _assert_params(arrays, "frozen_final.", ref["frozen_final"])


def test_run_steps_on_a_mesh(world):
    ref = world["ref"]
    for arrays, _vals in world["ranks"]:
        np.testing.assert_allclose(arrays["scan_losses"],
                                   ref["scan_losses"], **TOL)
        _assert_params(arrays, "scan_final.", ref["scan_final"])


def test_feed_and_loader_land_the_local_slice(world):
    for r, (arrays, vals) in enumerate(world["ranks"]):
        np.testing.assert_array_equal(
            arrays["feed_local"], world["inp"]["x16"][r * 4:(r + 1) * 4])
        assert vals["feed_global"] == [[16, 4], [16]]
        assert vals["loader_global"] == [[16, 4], [16]]


# (a)'s rule of chip_smoke.py's mesh phase at dp=4 on a narrow
# BatchNorm conv net: the real step, then each planted fault, against the
# global batch's step without a mesh on rank 0
_RULE_WORKER = WORKER_HEAD + r"""
import chip_smoke as cs
from mxnet_tpu_torch.parallel import make_mesh


def narrow():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, padding=1, use_bias=False),
            gluon.nn.BatchNorm(), gluon.nn.Activation("relu"),
            gluon.nn.Conv2D(16, 3, strides=2, padding=1, use_bias=False),
            gluon.nn.BatchNorm(), gluon.nn.Activation("relu"),
            gluon.nn.GlobalAvgPool2D(), gluon.nn.Dense(10))
    return net


def run(step_mesh, xb, yb, **kw):
    return cs.mesh_dp_run(narrow, step_mesh, xb, yb, device="cpu", **kw)[0]


with mx.cpu():
    mesh = make_mesh({"dp": 4}, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 3, 8, 8), generator=gen)
    y = torch.randint(0, 10, (32,), generator=gen).float()
    sl = slice(rank * 8, (rank + 1) * 8)
    ref = cs._single_device(4, device="cpu")
    four = run(mesh, x[sl], y[sl])
    runs = {"real": {"one": run(mesh, x[sl], y[sl], steps=1), "four": four,
                     "replicas": cs.mesh_dp_replicas(four, 4)}}
    for kind in cs.MESH_DP_CONTROLS:
        with cs.planted_fault(kind):
            four = run(mesh, x[sl], y[sl], first=True)
        runs[kind] = {"one": four.pop("first"), "four": four,
                      "replicas": cs.mesh_dp_replicas(four, 4)}
    if rank == 0:
        perm1 = torch.randperm(32, generator=torch.Generator().manual_seed(1))
        perms = [torch.randperm(32, generator=torch.Generator().manual_seed(k))
                 for k in range(2, 2 + cs.MESH_DP_PERMUTATIONS)]
        refs = {"one": (run(ref, x, y, steps=1),
                        [run(ref, x[perm1], y[perm1], steps=1)]),
                "four": (run(ref, x, y), [run(ref, x[p], y[p]) for p in perms])}
        values["rule"] = cs.mesh_dp_rule(runs, refs)
        values["fails"] = cs.mesh_dp_failures(values["rule"])
finish()
"""


@pytest.fixture(scope="module")
def rule_world(tmp_path_factory):
    """The rule's 4-rank world, once: rank 0's table and failures."""
    tmp = tmp_path_factory.mktemp("mesh_rule")
    np.savez(str(tmp / "inputs.npz"), none=np.zeros(1))
    spawn_world(tmp, _RULE_WORKER, timeout=120)
    return load_ranks(tmp)[0][1]


def test_dp_rule_passes_the_real_step(rule_world):
    assert rule_world["fails"]["real"] == []
    one = rule_world["rule"]["one_step"]
    assert sorted(one) == sorted(["loss", "updates", "momenta",
                                  "running_mean", "running_var"])
    assert all(row["held"] for row in one.values())
    assert one["loss"]["limit"] == 1e-5


def test_dp_rule_fails_per_rank_batchnorm_on_running_statistics(rule_world):
    fails = rule_world["fails"]["batchnorm_per_rank"]
    assert any("running_mean" in f or "running_var" in f for f in fails)
    assert "one_step running_mean" in fails


def test_dp_rule_fails_an_unsummed_bucket_on_the_update(rule_world):
    fails = rule_world["fails"]["bucket_unsummed"]
    assert "one_step updates" in fails
    assert "replicas ranks_differing" in fails


def test_dp_rule_holds_the_replicas_bitwise_equal(rule_world):
    row = rule_world["rule"]["replicas"]["ranks_differing"]
    assert row["held"] and row["limit"] == 0
    assert row["real"] == 0
    assert row["batchnorm_per_rank"] == 3 and row["bucket_unsummed"] == 3


def test_dp_rule_holds_a_trajectory_quantity_only_with_teeth(rule_world):
    controls = [k for k in rule_world["fails"] if k != "real"]
    for q, row in rule_world["rule"]["trajectory"].items():
        assert row["limit"] >= row["floor"] * cs.MESH_DP_FLOOR_FACTOR
        assert row["held"] == any(row[c] > row["limit"] for c in controls)
