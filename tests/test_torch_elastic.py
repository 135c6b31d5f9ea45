"""The port's multi-process ``ContinuousTrainer`` under the restart
supervisor, against the JAX package's (``tests/test_resilience.py``):

- the publish policy: a publish aborted by a ``RankFailure`` is trained
  past with ``on_publish_error="continue"`` (with a warning) and raised
  with ``"raise"``, in both packages alike;
- a single-process trainer binds no lease beater and never calls
  ``distributed.beat_lease``, in both packages;
- the port's twin of ``test_supervised_elastic_restart_bit_identical_
  gloo``: two ranks of a tiny net through ``python -m
  mxnet_tpu_torch.launch --supervise``, rank 1 chaos-KILLed between the
  ``written`` and ``committed`` barriers of step 2's publish; rank 0
  raises a ``BarrierTimeout`` naming rank 1 and exits through
  ``failfast_exit``, the supervisor relaunches generation 1, both ranks
  resume step 1 bit for bit, train to step 3 and publish it.
"""
import os
import subprocess
import sys

import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import distributed as jdist
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.chaos import scenarios as jscenarios
from mxnet_tpu.serving.loop import ContinuousTrainer as JContinuousTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, chaos
from mxnet_tpu_torch import distributed as dist
from mxnet_tpu_torch.chaos import scenarios
from mxnet_tpu_torch.serving.loop import ContinuousTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "jax": (JContinuousTrainer, jdist, jscenarios, JMXNetError, {}),
    "port": (ContinuousTrainer, dist, scenarios, MXNetError,
             {"device": "cpu"}),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    yield PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_chaos():
    for ch in (chaos, jchaos):
        ch.reset()
    yield
    for ch in (chaos, jchaos):
        ch.disarm()
        ch.reset()


def test_single_process_trainer_never_touches_leases(pkg, tmp_path,
                                                     monkeypatch):
    trainer_cls, d, scen, _err, kw = pkg
    calls = []
    monkeypatch.setattr(d, "beat_lease", lambda: calls.append(1))
    with mx.cpu():
        net, trainer, loss_fn, data = scen.train_fixtures(seed=0, **kw)
        ct = trainer_cls(net, trainer, loss_fn, data,
                         str(tmp_path / "ck"), publish_every=2)
        assert ct._lease_beat is None
        ct.run_steps(2)
        ct.close()
    assert calls == []


def test_publish_policy_continue_vs_raise(pkg, tmp_path):
    trainer_cls, d, scen, err, kw = pkg
    with mx.cpu():
        net, trainer, loss_fn, data = scen.train_fixtures(seed=0, **kw)
        ct = trainer_cls(net, trainer, loss_fn, data, str(tmp_path / "ck"),
                         publish_every=1, on_publish_error="continue")
        boom = d.RankFailure("peer died", tag="ckpt_written", ranks=[1])
        fails = [2]
        real = ct.manager.save_training

        def flaky(step, *a, **k):
            if step in fails:
                raise boom
            return real(step, *a, **k)

        ct.manager.save_training = flaky
        with pytest.warns(RuntimeWarning, match="continuing past it"):
            ct.run_steps(3)
        assert (ct.step, ct.published_step) == (3, 3)
        assert ct.manager.latest_step() == 3
        ct.close()
        ct2 = trainer_cls(net, trainer, loss_fn, data,
                          str(tmp_path / "ck2"), publish_every=1)
        ct2.manager.save_training = flaky
        fails[0] = ct2.step + 2
        with pytest.raises(d.RankFailure):
            ct2.run_steps(3)
        assert ct2.published_step == 1
        with pytest.raises(err):
            trainer_cls(net, trainer, loss_fn, data,
                        str(tmp_path / "ck3"), on_publish_error="shrug")


_ELASTIC_WORKER = r"""
import os, sys
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch import distributed as dist
from mxnet_tpu_torch.chaos import scenarios
from mxnet_tpu_torch.serving.loop import ContinuousTrainer

outdir = sys.argv[1]
assert mx.distributed_init() is True
nproc, rank = dist.world()
gen = dist.generation()
telemetry.enable()
chaos.arm_from_spec()            # generation-scoped: inert in gen 1
# identical replicated params on every rank: seed the init, as the JAX
# package's worker does
np.random.seed(0)
mx.random.seed(0)
torch.manual_seed(0)
with mx.cpu():
    net, trainer, loss_fn, data = scenarios.train_fixtures(seed=0,
                                                           device="cpu")
    ct = ContinuousTrainer(net, trainer, loss_fn, data,
                           outdir + "/ckpts", publish_every=1)
    ckpt = ct.resume()


def dump(tag):
    arrs = {k: p._reduce().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}
    np.savez(outdir + "/%s_rank%d.npz" % (tag, rank), **arrs)


if gen == 0:
    assert ckpt is None
    assert ct._lease_beat is not None
    ct.run_steps(1)
    dump("step1")
    try:
        ct.run_steps(2)
    except dist.BarrierTimeout as e:
        assert 1 in e.ranks, e.ranks
        assert ct.manager.latest_step() == 1, ct.manager.all_steps()
        print("SURVIVOR_ABORT rank=%d %s: %s" % (
            rank, type(e).__name__, e), flush=True)
        dist.failfast_exit(3)
    raise SystemExit("kill did not fire (rank %d)" % rank)

assert gen == 1, gen
assert ckpt is not None and ckpt.step == 1, ckpt
side = np.load(outdir + "/step1_rank%d.npz" % rank)
for k, p in sorted(net._collect_params_with_prefix().items()):
    a = p.data().asnumpy()
    assert a.dtype == side[k].dtype and a.tobytes() == side[k].tobytes(), k
print("RESUME_BIT_IDENTICAL rank=%d generation=%d step=%d"
      % (rank, gen, ckpt.step), flush=True)
ct.run_steps(2)
dist.barrier("gen1_steps_done")
assert ct.manager.latest_step() == 3, ct.manager.all_steps()
ct.close()
print("GEN1_DONE rank=%d" % rank, flush=True)
"""


def test_supervised_elastic_restart_bit_identical_gloo(tmp_path):
    worker = tmp_path / "elastic_worker.py"
    worker.write_text(_ELASTIC_WORKER)
    spec = chaos.make_spec(seed=0, rules=[
        {"point": "checkpoint.sharded.barrier.committed", "action": "kill",
         "nth": 2, "rank": 1, "generation": 0}])
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         "--supervise", "--max-restarts", "2", "--grace", "30",
         sys.executable, "-u", str(worker), str(tmp_path)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ,
                 PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", ""),
                 MXNET_TPU_CHAOS_SPEC=spec,
                 MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="5000",
                 MXNET_TPU_DIST_LEASE_TTL_S="2"))
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-800:])
    assert "SURVIVOR_ABORT rank=0 BarrierTimeout" in out.stdout
    assert "relaunching generation 1" in out.stdout
    for rank in range(2):
        assert "[g1.%d] RESUME_BIT_IDENTICAL rank=%d generation=1 step=1" \
            % (rank, rank) in out.stdout
    assert out.stdout.count("GEN1_DONE") == 2
