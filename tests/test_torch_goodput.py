"""The port's goodput ledger against the JAX package's: both
``StepLedger``s, fed the same instrument deltas on the same clock, give
equal windows -- categories, shares, reconciliation, verdicts, MFU --
and the same regressions, env-guard and publish-guard verdicts; the
ledger's telemetry and status-board row; and the ContinuousTrainer's
ticks on the CPU with ``MXNET_TPU_OBS_GOODPUT=1``."""
import math
import types

import numpy as np
import torch

from mxnet_tpu.obs import goodput as jgoodput
from mxnet_tpu.telemetry.core import Registry as JRegistry

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, obs, telemetry
from mxnet_tpu_torch.obs import goodput
from mxnet_tpu_torch.telemetry.core import Registry


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def _close(a, b, path="w"):
    if isinstance(a, float) or isinstance(b, float):
        assert a is not None and b is not None, path
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    else:
        assert a == b, (path, a, b)


# per window: (steps, {timer: seconds per step}, publishes, rtt_us)
BASE = {"trainer.step_time": 0.020, "profiling.step_time": 0.0,
        "feed.consumer_wait": 0.002, "dispatch.host_sync_time": 0.004,
        "compile.build_time": 0.0}
WINDOWS = [
    (4, dict(BASE, **{"compile.build_time": 0.05}), 0, None),
    (4, BASE, 0, None),
    (4, BASE, 1, None),
    (4, dict(BASE, **{"checkpoint.save_time": 0.030}), 1, None),
    (4, BASE, 0, None),
    (4, dict(BASE, **{"dispatch.host_sync_time": 0.030}), 0, None),
    (4, dict(BASE, **{"feed.consumer_wait": 0.050}), 0, 20000.0),
    (4, dict(BASE, **{"feed.consumer_wait": 0.050}), 0, None),
    (2, BASE, 0, None),
]


def _drive(module, registry, monkeypatch, flops):
    clock = _Clock()
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(perf_counter=clock.perf_counter))
    led = module.StepLedger(window_steps=4, tol=0.25, mad_k=4.0,
                            flops_per_step=flops, registry=registry)
    out = []
    for steps, per_step, publishes, rtt in WINDOWS:
        if rtt is not None:
            registry.gauge("env.dispatch_roundtrip_us").set(rtt)
        for _ in range(steps):
            spent = 0.0
            for name, s in per_step.items():
                if s:
                    registry.timer(name).observe(s)
                    spent += s
            clock.t += spent + 0.003         # un-instrumented time
            for _ in range(publishes):
                led.note_publish()
            publishes = 0
            win = led.step()
            if win is not None:
                out.append(win)
        if rtt is not None:
            registry.gauge("env.dispatch_roundtrip_us").set(100.0)
    clock.t += 0.01
    out.append(led.flush(reason="close"))
    out.append(led.flush())          # an idle window
    return out, led.baseline()


def test_both_ledgers_give_equal_windows(monkeypatch):
    jwins, jbase = _drive(jgoodput, JRegistry(), monkeypatch, 1e9)
    pwins, pbase = _drive(goodput, Registry(), monkeypatch, 1e9)
    assert len(pwins) == len(jwins) == 10
    for j, p in zip(jwins, pwins):
        _close(j, p)
    _close(jbase, pbase)
    # what the windows say, beyond equality
    assert all(w["reconciliation"]["ok"] for w in pwins)
    assert pwins[0]["verdict"]["bound"] == "recompile"
    assert [r["category"] for r in pwins[5]["regressions"]] == \
        ["host_sync"]
    assert pwins[3]["regressions"] == [] and pwins[3]["publishes"] == 1
    assert pwins[6]["env_degraded"] and pwins[6]["regressions"] == []
    assert [r["category"] for r in pwins[7]["regressions"]] == \
        ["input_wait"]
    assert pwins[7]["verdict"]["bound"] == "input"
    assert pwins[-1]["verdict"]["bound"] == "idle"
    assert pwins[1]["mfu"] is not None and pwins[1]["peaks_assumed"]


def test_overshoot_fails_reconciliation_in_both(monkeypatch):
    for module, reg in ((jgoodput, JRegistry()), (goodput, Registry())):
        clock = _Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter))
        led = module.StepLedger(window_steps=1, tol=0.25, registry=reg)
        reg.timer("trainer.step_time").observe(2.0)    # another thread's
        clock.t += 1.0
        win = led.step()
        assert win["reconciliation"]["ok"] is False
        assert win["reconciliation"]["error"] == 1.0


def test_window_publishes_goodput_instruments_and_statusz():
    telemetry.enable()
    obs.status.reset()
    goodput.reset()
    try:
        led = goodput.ledger(window_steps=2)
        assert goodput.ledger() is led
        telemetry.timer("trainer.step_time").observe(0.001)
        led.step()
        win = led.step()
        snap = {r["name"]: r for r in telemetry.snapshot()}
        assert snap["goodput.windows"]["value"] == 1
        assert snap["goodput.steps"]["value"] == 2
        assert "goodput.device_compute_share" in snap
        assert obs.status.statusz()["goodput"] == win
        assert goodput.line_summary(win)["steps"] == 2
    finally:
        telemetry.disable()
        telemetry.reset()
        goodput.reset()
        obs.status.reset()


def test_continuous_trainer_ticks_the_ledger(tmp_path):
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import ContinuousTrainer
    telemetry.enable()
    obs.enable_goodput()
    goodput.reset()
    try:
        with mx.cpu():
            net = gluon.nn.Dense(3, in_units=4)
            net.initialize(device="cpu")
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
            rng = np.random.default_rng(0)
            x = NDArray(torch.from_numpy(
                rng.standard_normal((8, 4)).astype(np.float32)))
            y = NDArray(torch.from_numpy(
                rng.integers(0, 3, 8).astype(np.float32)))
            led = goodput.ledger(window_steps=3)
            ct = ContinuousTrainer(net, tr,
                                   gluon.loss.SoftmaxCrossEntropyLoss(),
                                   (x, y), str(tmp_path / "ck"),
                                   publish_every=3)
            ct.run_steps(7)
            ct.close()
        wins = led.windows()
        assert [w["steps"] for w in wins] == [3, 3, 1]
        assert [w["publishes"] for w in wins] == [1, 1, 0]
        assert wins[-1]["reason"] == "close"
        assert all(w["reconciliation"]["ok"] for w in wins)
        assert wins[0]["categories"]["device_compute"]["seconds"] > 0
        assert wins[0]["categories"]["checkpoint_stall"]["seconds"] > 0
    finally:
        obs.disable_goodput()
        telemetry.disable()
        telemetry.reset()
        goodput.reset()
        obs.status.reset()
