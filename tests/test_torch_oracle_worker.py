"""``chip_smoke.py``'s host worker on the CPU: an oracle run there gives
the distances it gives in process, bitwise, and a job that raises, a
worker that is killed and a job past its bound each fail the caller
with the job's name."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402


@pytest.fixture
def worker():
    """A worker on every cpu of this process with its torch threads (so
    its sums are this process's)."""
    w = cs.HostWorker(sorted(os.sched_getaffinity(0)),
                      torch.get_num_threads())
    try:
        yield w
    finally:
        w.close()


def test_mnist_oracle_in_the_worker_is_bitwise_in_process(worker):
    worker.submit("MNIST oracle", cs.mnist_oracle, {"ctx": mx.cpu()})
    here = cs.mnist_oracle(ctx=mx.cpu())
    there = worker.result("MNIST oracle")
    assert there == here
    # a distance that is no 0 of two equal runs: the permuted floor
    assert here["floor_update_rel_err"] > 0
    stats = worker.stats()
    assert set(stats["busy"]) == {"MNIST oracle"}
    assert stats["main_waited"] >= 0


def test_a_job_that_raises_fails_with_its_name(worker):
    worker.submit("planted oracle", cs.check,
                  {"cond": False, "msg": "planted failure"})
    with pytest.raises(cs.SmokeFailure) as e:
        worker.result("planted oracle")
    assert "planted oracle raised" in str(e.value)
    assert "planted failure" in str(e.value)


def test_a_killed_worker_fails_with_the_job_waited_on(worker):
    worker.submit("doomed oracle", subprocess.run,
                  {"args": ["sleep", "30"]})
    worker.proc.kill()
    with pytest.raises(cs.SmokeFailure) as e:
        worker.result("doomed oracle")
    assert "lost before doomed oracle came back" in str(e.value)


def test_a_job_past_its_bound_fails_with_its_name(worker):
    worker.job_s = 1.0
    worker.submit("slow oracle", subprocess.run, {"args": ["sleep", "30"]})
    with pytest.raises(cs.SmokeFailure) as e:
        worker.result("slow oracle")
    assert "slow oracle not back within 1 s" in str(e.value)
