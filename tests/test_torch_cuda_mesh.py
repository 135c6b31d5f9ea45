"""The port's meshes on NVIDIA GPUs: NCCL collectives on a mesh axis,
eager and recorded into CUDA graphs, and ``TrainStep(mesh=)`` captured
with its collectives inside the graph.

Each case runs in a world of its own (``python`` subprocesses, one card
a rank): a world of one rank on the card -- every collective still
issued, through NCCL -- and, where four cards are visible, a world of
four (the 4-rank cases skip with fewer).  Every test here needs the
card and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_mesh.py
"""
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = r"""
import sys
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, autograd, gluon
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.parallel import (TrainStep, TensorParallelMLP,
                                      collectives, make_mesh)
import torch.distributed as dist

mx.distributed_init()
world = make_mesh({"dp": -1})
rank, n = dist.get_rank(), dist.get_world_size()
torch.cuda.set_device(rank % torch.cuda.device_count())
torch.backends.cudnn.deterministic = True
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def net_fn():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
            gluon.nn.BatchNorm(axis=-1), gluon.nn.Activation("relu"),
            gluon.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
            gluon.nn.BatchNorm(axis=-1),
            gluon.nn.Flatten(), gluon.nn.Dense(10))
    net.initialize(device="cuda", generator=torch.Generator().manual_seed(0))
    return net


def train(mesh, x, y, steps=4):
    net = net_fn()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                     mesh=mesh)
    losses = []
    with _capture.checking_syncs():
        for k in range(steps):
            if k == 2:
                torch.cuda.synchronize()
                collectives.reset_counts()
            losses.append(step(x, y))
    torch.cuda.synchronize()
    calls = collectives.counts()
    return net, step, [float(v) for v in losses], calls


def norm_rel(a, b):
    num = sum(float((x - y).double().norm()) ** 2 for x, y in zip(a, b))
    den = sum(float(y.double().norm()) ** 2 for y in b)
    return (num / den) ** 0.5
"""

_ONE = _HEAD + r"""
mesh = make_mesh({"dp": 1})
x = torch.arange(6.0, device="cuda").reshape(2, 3)
assert collectives.psum(x, mesh, "dp").tolist() == x.tolist()
assert collectives.all_gather(x, mesh, "dp", 1).shape == (2, 3)
assert collectives.all_to_all(x, mesh, "dp", 0, 1).tolist() == x.tolist()
assert collectives.ppermute(x, mesh, "dp").tolist() == x.tolist()

# collectives recorded into a CUDA graph run, and count, at each replay
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    collectives.psum(x, mesh, "dp")
torch.cuda.current_stream().wait_stream(side)
from collections import Counter
g = torch.cuda.CUDAGraph()
with registry.counting_into(Counter()) as tally:
    with torch.cuda.graph(g):
        y = collectives.psum(x * 2, mesh, "dp")
        z = collectives.ppermute(x, mesh, "dp")
collectives.reset_counts()
x.add_(1)
for _ in range(3):
    g.replay()
    registry.add_launches(tally)
torch.cuda.synchronize()
assert y.tolist() == (x * 2).tolist() and z.tolist() == x.tolist()
c = collectives.counts()
assert c["all_reduce"]["calls"] == 3 and c["ppermute"]["calls"] == 3, c

# TrainStep(mesh=dp:1), captured, against the step without a mesh
gen = torch.Generator().manual_seed(1)
xb = torch.randn((16, 8, 8, 3), generator=gen).cuda()
yb = torch.randint(0, 10, (16,), generator=gen).float().cuda()
net_m, step_m, loss_m, calls = train(mesh, xb, yb)
net_p, _step_p, loss_p, _ = train(None, xb, yb)
assert step_m.capture_stats()["graphs"] == 1
per_replay = calls["all_reduce"]["calls"] / 2
walked = step_m.cost_report()["categories"]["collective"]["instructions"]
assert per_replay == walked == step_m._buckets + 2 * 2, (per_replay, walked)
w_m = [p.data()._data for p in net_m.collect_params().values()]
w_p = [p.data()._data for p in net_p.collect_params().values()]
assert max(abs(a - b) / abs(b) for a, b in zip(loss_m, loss_p)) <= 1e-6
assert norm_rel(w_m, w_p) <= 1e-6, norm_rel(w_m, w_p)
print("ONE_OK", flush=True)
"""

_FOUR = _HEAD + r"""
mesh = make_mesh({"dp": 4})
solo = make_mesh({"dp": 1}, devices=[0])
gen = torch.Generator().manual_seed(1)
xb = torch.randn((32, 8, 8, 3), generator=gen).cuda()
yb = torch.randint(0, 10, (32,), generator=gen).float().cuda()
mine = slice(rank * 8, (rank + 1) * 8)
net_m, step_m, loss_m, calls = train(mesh, xb[mine], yb[mine])
print("FOUR rank %d: dp step" % rank, flush=True)
w_m = [p.data()._data for p in net_m.collect_params().values()]
assert calls["all_reduce"]["calls"] / 2 == step_m._buckets + 2 * 2
if rank == 0:
    net_p, _s, loss_p, _ = train(solo, xb, yb)
    w_p = [p.data()._data for p in net_p.collect_params().values()]
    assert max(abs(a - b) / abs(b) for a, b in zip(loss_m, loss_p)) <= 1e-5
    assert norm_rel(w_m, w_p) <= 2e-2, norm_rel(w_m, w_p)
print("FOUR rank %d: against one card" % rank, flush=True)

# tensor parallelism over four cards: the MLP's forward
tp = make_mesh({"tp": 4})
mlp = TensorParallelMLP(256, 64, mesh=tp)
mlp.initialize(device="cuda", generator=torch.Generator().manual_seed(2))
xt = torch.randn((8, 64), generator=torch.Generator().manual_seed(3)).cuda()
with autograd.pause():
    want = mlp(xt)
    mlp.shard(tp)
    got = mlp(xt)
assert float((got - want).abs().max()) <= 1e-4
dist.barrier()
print("FOUR_OK", rank, flush=True)
"""


def _world(tmp_path, script, n, timeout=180):
    """Run ``script`` as a world of ``n`` ranks; every rank is killed
    once ``timeout`` seconds have passed.  Returns each rank's exit code
    and output."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(n):
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   MXNET_TPU_COORDINATOR=coord, MXNET_TPU_NUM_PROCS=str(n),
                   MXNET_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(path)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
        outs.append((p.returncode, text))
    return outs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def test_a_world_of_one_rank_on_the_card(card, tmp_path):
    (rc, text), = _world(tmp_path, _ONE, 1)
    assert rc == 0 and "ONE_OK" in text, text[-4000:]


def test_a_world_of_four_ranks(card, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards, %d visible"
                    % torch.cuda.device_count())
    outs = _world(tmp_path, _FOUR, 4)
    report = "\n".join("rank %d exit %s:\n%s" % (r, rc, text[-3000:])
                       for r, (rc, text) in enumerate(outs))
    for r, (rc, text) in enumerate(outs):
        assert rc == 0 and "FOUR_OK %d" % r in text, report
