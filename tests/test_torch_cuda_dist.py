"""The port's host collectives between two processes on one NVIDIA GPU:
``host_allreduce`` (plain and bucketed) of CUDA tensors lands on the
card and equals the rank-order sum bit for bit on both ranks, and
``host_broadcast`` lands rank 0's value on the card.  The two ranks
share the one card through gloo over host copies.  Every test here
needs the card and skips without one.  The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_dist.py
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import distributed as dist

assert mx.distributed_init() is True
nproc, rank = dist.world()


def value(r, n, dtype):
    g = torch.Generator(device="cuda").manual_seed(100 + r)
    return torch.randn(n, generator=g, device="cuda").to(dtype)


for dtype in (torch.float32, torch.bfloat16):
    mine = value(rank, 1 << 20, dtype)
    got = dist.host_allreduce(mine)
    want = value(0, 1 << 20, dtype).clone()
    for r in range(1, nproc):
        want += value(r, 1 << 20, dtype)
    assert got.device.type == "cuda", got.device
    assert got.dtype == dtype and torch.equal(got, want), dtype
pieces = [torch.full((3, 5), float(rank + 1), device="cuda"),
          torch.arange(7, device="cuda") * (rank + 1)]
out = dist.host_allreduce_bucketed(pieces)
assert [o.device.type for o in out] == ["cuda", "cuda"]
assert torch.equal(out[0], torch.full((3, 5), 3.0, device="cuda"))
assert torch.equal(out[1], torch.arange(7, device="cuda") * 3)
root = dist.host_broadcast(torch.full((4,), float(rank), device="cuda"))
assert root.device.type == "cuda" and torch.equal(
    root, torch.zeros(4, device="cuda"))
dist.barrier("done")
print("RANK_OK", rank, flush=True)
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def test_two_ranks_allreduce_cuda_tensors_on_one_card(card, tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
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
                   MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="60000")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        outs.append((p.returncode, text))
    for rank, (rc, text) in enumerate(outs):
        assert rc == 0 and "RANK_OK %d" % rank in text, text[-3000:]
