"""The port's leak sentinel against the JAX package's: both
``LeakSentinel``s, fed the same census totals and buckets window by
window, give equal window reports, baselines and leak flags (the
publish guard, the warm-baseline and streak rules, the named bucket);
the port's census on the CPU walks the live tensors, ``pin_action``
grows it, and the ContinuousTrainer's ticks flag an armed
``memory.leak`` after its onset and never before."""
import numpy as np
import pytest
import torch

from mxnet_tpu.analysis import memory as jmemory

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, gluon, obs, telemetry
from mxnet_tpu_torch.analysis import memory

MIB = 1 << 20


def _censuses():
    """Per window: total bytes and buckets; steady, one spike under a
    publish, then a leak of 8 MiB a window from window 6."""
    steady = {"(256,)/float32": {"count": 40, "bytes": 40 * MIB}}
    out = []
    for i in range(12):
        buckets = {k: dict(v) for k, v in steady.items()}
        if i == 3:          # a checkpoint snapshot, publish-guarded
            buckets["(9,)/float32"] = {"count": 1, "bytes": 30 * MIB}
        if i >= 6:
            buckets["(2097152,)/float32"] = {"count": i - 5,
                                             "bytes": (i - 5) * 8 * MIB}
        total = sum(b["bytes"] for b in buckets.values()) + (i % 2) * 1024
        out.append({"bytes_total": total,
                    "arrays": sum(b["count"] for b in buckets.values()),
                    "buckets": buckets})
    return out


def _drive(module, monkeypatch):
    seq = iter(_censuses())
    monkeypatch.setattr(module, "live_census", lambda: dict(next(seq)))
    module.reset_watch()
    s = module.LeakSentinel(window_steps=2, mad_k=4.0)
    reports = []
    for i in range(12):
        if i == 3:
            s.note_publish()
        s.step()
        reports.append(s.step())
        reports[-1] = s.last()
    return reports, s.baseline(), module.status_row()


def test_both_sentinels_flag_the_same_windows(monkeypatch):
    jrep, jbase, jrow = _drive(jmemory, monkeypatch)
    prep, pbase, prow = _drive(memory, monkeypatch)
    assert prep == jrep
    assert pbase == pytest.approx(jbase, rel=1e-12)
    for key in ("leaks", "last_leak", "pinned"):
        assert prow[key] == jrow[key], key
    flagged = [r["index"] for r in prep if r["leak"]]
    assert flagged and min(flagged) >= 6 and min(flagged) <= 8
    assert prep[flagged[0]]["leak"]["bucket"] == "(2097152,)/float32"
    assert prep[3]["publishes"] == 1 and prep[3]["leak"] is None


def test_cpu_census_walks_live_tensors_and_pins_grow_it():
    memory.reset_watch()
    keep = torch.zeros(12345, dtype=torch.float64)
    c0 = memory.live_census()
    assert c0["buckets"]["(12345,)/float64"]["bytes"] >= 12345 * 8
    memory.pin_action({"nbytes": 4 * MIB})
    memory.pin_action({"nbytes": 4 * MIB})
    c1 = memory.live_census()
    assert memory.pinned_count() == 2
    assert c1["buckets"]["(1048576,)/float32"]["count"] >= 2
    assert c1["bytes_total"] - c0["bytes_total"] >= 8 * MIB
    assert memory.unpin_all() == 2
    row = memory.status_row()
    assert row["censuses"] == 2 and row["pinned"] == 0
    del keep


def test_continuous_trainer_flags_an_armed_leak(tmp_path, monkeypatch):
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import ContinuousTrainer
    monkeypatch.setattr(memory, "_WATCH", True)
    memory.reset_watch()
    chaos.reset()
    telemetry.enable()
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
            s = memory.sentinel(window_steps=2, min_baseline=2)
            ct = ContinuousTrainer(net, tr,
                                   gluon.loss.SoftmaxCrossEntropyLoss(),
                                   (x, y), str(tmp_path / "ck"),
                                   publish_every=100)
            with chaos.scenario(seed=0):
                # 16 MiB a step from step 9 (the 5th window)
                chaos.on("memory.leak", nth=range(9, 17),
                         action=lambda ctx: memory.pin_action(
                             dict(ctx, nbytes=16 * MIB)))
                reports = []
                for _ in range(8):
                    ct.run_steps(2)
                    reports.append(s.last())
            ct.close()
        flagged = [r["index"] for r in reports if r["leak"]]
        assert flagged, reports
        assert min(flagged) >= 4 and min(flagged) <= 6
        assert "(4194304,)/float32" == reports[flagged[0]]["leak"]["bucket"]
        snap = {r["name"]: r for r in telemetry.snapshot()}
        assert snap["memory.leaks"]["value"] == len(flagged)
        assert obs.status.statusz()["memory"]["leaks"] == len(flagged)
    finally:
        telemetry.disable()
        telemetry.reset()
        chaos.reset()
        memory.reset_watch()
