"""The port's multi-process kvstore, ``Trainer(kvstore="dist_sync")`` and
``horovod`` against the JAX package's, on a world of two port ranks on
CPU gloo (one ``python`` subprocess a rank, run once for the module):

- ``dist_sync`` ``push``/``pull``/``pushpull``/``pushpull_bucket``
  equal the JAX ``"device"`` store fed both ranks' values in one
  process; with 2-bit compression each rank compresses its own value
  before the sum, so the reference is one compressed JAX store a rank,
  their outputs summed in rank order;
- the initial broadcast: every parameter of rank 1 equals rank 0's,
  bitwise, though each rank initialized from its own seed;
- three ``Trainer(kvstore="dist_sync")`` SGD steps of a narrow
  Dense-BatchNorm-Dense net equal, within 1e-6, a single-process JAX
  computation: one JAX net a rank on its own batch (with its own
  running statistics), the two gradients summed in rank order, the same
  SGD update; the ranks' trainable weights stay bitwise equal while
  their running statistics differ;
- ``horovod``'s single-process API equals the JAX package's, and
  ``DistributedTrainer`` on two ranks averages the gradients as the
  JAX one does.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import horovod as jhvd
from mxnet_tpu import kvstore as jkv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import horovod as hvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)
SGD = {"learning_rate": 0.1, "momentum": 0.9}
HVD_SGD = {"learning_rate": 0.1}
BATCH = 4

_COMMON = r"""
import numpy as np


def value(seed, rank, shape):
    rng = np.random.default_rng(1000 * seed + rank)
    return rng.standard_normal(shape).astype(np.float32)


def batch(step, rank):
    rng = np.random.default_rng(100 * step + rank)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((4, 4)).astype(np.float32))


def layers(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
            nn.Activation("relu"), nn.Dense(4, in_units=16))
    return net
"""

_WORKER = _COMMON + r"""
import os, sys
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, kvstore
from mxnet_tpu_torch import distributed as dist
from mxnet_tpu_torch import horovod as hvd
from mxnet_tpu_torch.ndarray import NDArray

out = sys.argv[1]
assert mx.distributed_init() is True
nproc, rank = dist.world()
res = {}
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def weights(net, tag):
    for k, p in net._collect_params_with_prefix().items():
        res["%s/%s" % (tag, k)] = p._data.detach().numpy().copy()


def train(net, trainer, steps, first):
    for s in range(first, first + steps):
        x, y = batch(s, rank)
        with autograd.record():
            loss = gluon.loss.L2Loss()(net(NDArray(t(x))), NDArray(t(y)))
        loss.backward()
        trainer.step(4)


with mx.cpu():
    kv = kvstore.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (rank, nproc)
    kv.init(0, torch.zeros(5))
    kv.init(1, torch.zeros((3, 2)))
    kv.push(0, t(value(1, rank, (5,))))
    o = torch.zeros(5)
    kv.pull(0, out=o)
    res["push_pull"] = o.numpy().copy()
    kv.push(0, [t(value(2, rank, (5,))), t(value(3, rank, (5,)))])
    kv.pull(0, out=o)
    res["push_list"] = o.numpy().copy()
    o2 = torch.zeros((3, 2))
    kv.pushpull(1, t(value(4, rank, (3, 2))), out=o2)
    res["pushpull"] = o2.numpy()
    outs = [torch.zeros(5), torch.zeros((3, 2))]
    kv.pushpull_bucket([7, 8], [t(value(5, rank, (5,))),
                                t(value(6, rank, (3, 2)))], outs)
    res["bucket0"], res["bucket1"] = outs[0].numpy(), outs[1].numpy()
    kvc = kvstore.create("dist_sync")
    kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    for i in range(3):
        oc = torch.zeros(6)
        kvc.pushpull(3, t(value(10 + i, rank, (6,))), out=oc)
        res["compressed%d" % i] = oc.numpy()
    kv.barrier()

    net = layers(gluon.nn)
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(10 + rank))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore="dist_sync")
    trainer.allreduce_grads()       # the initial broadcast
    weights(net, "init")
    train(net, trainer, 3, 1)
    weights(net, "after")

    hvd.init()
    assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (rank, nproc, 0)
    hnet = layers(gluon.nn)
    hnet.initialize(device="cpu",
                    generator=torch.Generator().manual_seed(30 + rank))
    hnet(torch.zeros((1, 8)))
    hvd.broadcast_parameters(hnet.collect_params())
    weights(hnet, "hvd_init")
    htr = hvd.DistributedTrainer(hnet.collect_params(), "sgd",
                                 {"learning_rate": 0.1})
    train(hnet, htr, 2, 10)
    weights(hnet, "hvd_after")
    res["hvd_allreduce"] = hvd.allreduce(t(value(40, rank, (5,)))).asnumpy()
    res["hvd_grouped"] = np.concatenate([
        a.asnumpy().reshape(-1) for a in hvd.grouped_allreduce(
            [t(value(41, rank, (3,))), t(value(42, rank, (2, 2)))],
            average=False)])
np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
dist.barrier("done")
print("OK", rank, flush=True)
"""

exec(_COMMON)                   # value, batch, layers for the references


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kvdist")
    path = tmp / "worker.py"
    path.write_text(_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(2):
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   MXNET_TPU_COORDINATOR=coord, MXNET_TPU_NUM_PROCS="2",
                   MXNET_TPU_PROC_ID=str(rank),
                   MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="30000")
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(path), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + 150
    for rank, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        assert p.returncode == 0 and "OK %d" % rank in text, text[-3000:]
    return [dict(np.load(str(tmp / ("rank%d.npz" % r)))) for r in range(2)]


def _j(a):
    return jmx.nd.array(a, ctx=jmx.cpu())


def test_push_pull_and_pushpull_equal_the_jax_device_store(world):
    store = jkv.create("device")
    store.init(0, _j(np.zeros(5, np.float32)))
    store.init(1, _j(np.zeros((3, 2), np.float32)))
    store.push(0, [_j(value(1, r, (5,))) for r in range(2)])
    o = _j(np.zeros(5, np.float32))
    store.pull(0, out=o)
    want = {"push_pull": o.asnumpy()}
    out2 = _j(np.zeros((3, 2), np.float32))
    store.pushpull(1, [_j(value(4, r, (3, 2))) for r in range(2)],
                   out=out2)
    want["pushpull"] = out2.asnumpy()
    for rank in range(2):
        for key in ("push_pull", "pushpull"):
            np.testing.assert_array_equal(world[rank][key], want[key])
    # a list pushed on each rank merges there, then sums across ranks
    lists = sum(value(2, r, (5,)) + value(3, r, (5,)) for r in range(2))
    buckets = [sum(value(5, r, (5,)) for r in range(2)),
               sum(value(6, r, (3, 2)) for r in range(2))]
    for rank in range(2):
        np.testing.assert_allclose(world[rank]["push_list"], lists, **TOL)
        for i in range(2):
            np.testing.assert_array_equal(world[rank]["bucket%d" % i],
                                          buckets[i])


def test_two_bit_compression_compresses_each_rank_before_the_sum(world):
    stores = []
    for _r in range(2):
        st = jkv.create("device")
        st.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        st.init(3, _j(np.zeros(6, np.float32)))
        stores.append(st)
    for i in range(3):
        outs = []
        for r, st in enumerate(stores):
            o = _j(np.zeros(6, np.float32))
            st.pushpull(3, _j(value(10 + i, r, (6,))), out=o)
            outs.append(o.asnumpy())
        want = outs[0] + outs[1]
        for rank in range(2):
            np.testing.assert_array_equal(world[rank]["compressed%d" % i],
                                          want)


def _tagged(res, tag):
    return {k.split("/", 1)[1]: v for k, v in res.items()
            if k.startswith(tag + "/")}


def test_initial_broadcast_makes_rank_1_rank_0s(world):
    r0, r1 = _tagged(world[0], "init"), _tagged(world[1], "init")
    assert sorted(r0) == sorted(r1) and len(r0) == 8
    for k in r0:
        assert r0[k].tobytes() == r1[k].tobytes(), k
    h0, h1 = _tagged(world[0], "hvd_init"), _tagged(world[1], "hvd_init")
    for k in h0:
        assert h0[k].tobytes() == h1[k].tobytes(), k


def _jax_net(arrays):
    net = layers(jgluon.nn)
    net.initialize(ctx=jmx.cpu())
    net(_j(np.zeros((1, 8), np.float32)))
    params = net._collect_params_with_prefix()
    for k, a in arrays.items():
        params[k].set_data(_j(a))
    return net


def _jax_world_steps(init, steps, first, opt, average):
    """One JAX net a rank from ``init``; each step every net backs its
    own batch, the gradients are summed (or averaged) in rank order, the
    JAX package's SGD updater applies them to net 0's weights at the
    local batch size, and net 1 is rebuilt from net 0's trainable
    weights and its own running statistics."""
    nets = [_jax_net(init) for _ in range(2)]
    updater = jmx.optimizer.get_updater(jmx.optimizer.create(
        "sgd", rescale_grad=1.0 / BATCH, **opt))
    for s in range(first, first + steps):
        for r, net in enumerate(nets):
            x, y = batch(s, r)
            with jautograd.record():
                loss = jgluon.loss.L2Loss()(net(_j(x)), _j(y))
            loss.backward()
        p0 = nets[0]._collect_params_with_prefix()
        p1 = nets[1]._collect_params_with_prefix()
        for i, (k, p) in enumerate(sorted(p0.items())):
            if p.grad_req == "null":
                continue
            g = np.asarray(p._data._grad) + np.asarray(p1[k]._data._grad)
            if average:
                g = g / np.float32(2)
            updater(i, _j(g), p.data())
        nets[1] = _jax_net({k: (p1[k] if p.grad_req == "null" else p)
                            .data().asnumpy() for k, p in p0.items()})
    return [{k: p.data().asnumpy() for k, p in
             net._collect_params_with_prefix().items()} for net in nets]


def _stat(k):
    return k.endswith("running_mean") or k.endswith("running_var")


def test_three_dist_sync_steps_equal_the_one_process_jax_steps(world):
    want = _jax_world_steps(_tagged(world[0], "init"), 3, 1, SGD, False)
    got = [_tagged(world[r], "after") for r in range(2)]
    for k in want[0]:
        for r in range(2):
            np.testing.assert_allclose(got[r][k], want[r][k],
                                       err_msg="rank %d %s" % (r, k), **TOL)
        if not _stat(k):
            assert got[0][k].tobytes() == got[1][k].tobytes(), k
    stats = [k for k in got[0] if _stat(k)]
    assert stats and any(got[0][k].tobytes() != got[1][k].tobytes()
                         for k in stats)


def test_distributed_trainer_averages_like_the_jax_one(world):
    want = _jax_world_steps(_tagged(world[0], "hvd_init"), 2, 10, HVD_SGD,
                            True)
    for r in range(2):
        got = _tagged(world[r], "hvd_after")
        for k in want[r]:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg="rank %d %s" % (r, k), **TOL)
    avg = (value(40, 0, (5,)) + value(40, 1, (5,))) / np.float32(2)
    grouped = np.concatenate([
        (value(41, 0, (3,)) + value(41, 1, (3,))).reshape(-1),
        (value(42, 0, (2, 2)) + value(42, 1, (2, 2))).reshape(-1)])
    for r in range(2):
        np.testing.assert_array_equal(world[r]["hvd_allreduce"], avg)
        np.testing.assert_array_equal(world[r]["hvd_grouped"], grouped)


def test_horovod_single_process_api_equals_jax():
    hvd.init()
    jhvd.init()
    assert (hvd.rank(), hvd.size(), hvd.local_rank()) == \
        (jhvd.rank(), jhvd.size(), jhvd.local_rank()) == (0, 1, 0)
    a = value(50, 0, (4,))
    with tmx.cpu():
        got = hvd.allreduce(tmx.nd.array(a)).asnumpy()
        grouped = [g.asnumpy() for g in hvd.grouped_allreduce(
            [tmx.nd.array(a), tmx.nd.array(a * 2)])]
        net = layers(tmx.gluon.nn)
        net.initialize(device="cpu")
        hvd.broadcast_parameters(net.collect_params())   # one process
        tr = hvd.DistributedTrainer(net.collect_params(), "sgd",
                                    HVD_SGD)
        assert tr._kvstore is None
    np.testing.assert_array_equal(got, jhvd.allreduce(_j(a)).asnumpy())
    for g, w in zip(grouped, jhvd.grouped_allreduce([_j(a), _j(a * 2)])):
        np.testing.assert_array_equal(g, w.asnumpy())
