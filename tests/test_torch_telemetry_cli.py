"""The port's ``mxtelemetry`` against the JAX package's: on the same
files -- a JSONL run log the port wrote (trainer, checkpoints, serving,
goodput windows and a regression, memory censuses, spans), two rank
files, a flight-recorder ring the JAX package wrote -- ``summarize``
(console, ``--json``, ``--prom``, ranks) and ``blackbox`` print the same
text from both CLIs; ``fleet`` raises naming the fleet plane."""
import json

import pytest

from mxnet_tpu.obs import flight as jflight
from mxnet_tpu.telemetry import cli as jcli

from mxnet_tpu_torch import MXNetError, obs, telemetry
from mxnet_tpu_torch.obs import goodput
from mxnet_tpu_torch.telemetry import cli as pcli

CATS = goodput.CATEGORIES


def _window(index, shares, regressions=()):
    return {"index": index, "reason": "steps", "steps": 10,
            "wall_s": 2.0, "mfu": 0.25,
            "categories": {c: {"seconds": 2.0 * shares.get(c, 0.0),
                               "share": shares.get(c, 0.0)} for c in CATS},
            "reconciliation": {"error": 0.0, "ok": True},
            "verdict": {"detail": "compute-bound: device busy 60% of "
                                  "wall", "bound": "compute"},
            "env_degraded": False, "regressions": list(regressions)}


def _write_log(path, rank_scale=1.0):
    telemetry.disable()
    telemetry.registry().clear()
    telemetry.enable()
    obs.enable_tracing()
    sink = telemetry.attach_jsonl(str(path))
    try:
        h = telemetry.hooks
        for i in range(6):
            h.trainer_step(0.05 * rank_scale + 0.001 * i, 32)
        h.checkpoint("save", nbytes=4096, seconds=0.4, step=8)
        h.train_publish(8, 0.41)
        h.compile_event("train_step", seconds=1.5, owner="TrainStep(Net)",
                        stage="warm")
        h.host_sync("asnumpy", 0.002)
        h.feed_produce(0.02, 1 << 20)
        h.feed_wait(0.001)
        h.serving_request("m", 2)
        h.serving_batch("m", 2, 4, 0.003)
        h.serving_latency(0.004)
        h.memory_census(1 << 30, 120)
        h.memory_leak("(16777216,)/float32", 64 << 20, 1 << 30, 4)
        h.goodput_window(_window(0, {"device_compute": 0.6,
                                     "other": 0.4}))
        h.goodput_window(_window(1, {"device_compute": 0.5,
                                     "host_sync": 0.3, "other": 0.2}))
        h.goodput_regression("host_sync", 0.06, 0.01, 6.0, 1)
        with obs.span("train.step", step=1):
            pass
        telemetry.flush()
    finally:
        obs.disable_tracing()
        telemetry.registry().detach(sink)
        sink.close()
        telemetry._jsonl_sink = None
        telemetry.disable()
        telemetry.registry().clear()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    paths = [d / "rank0.jsonl", d / "rank1.jsonl"]
    _write_log(paths[0])
    _write_log(paths[1], rank_scale=1.6)
    return [str(p) for p in paths]


def _both(argv, capsys):
    prc = pcli.main(argv)
    pout = capsys.readouterr().out
    jrc = jcli.main(argv)
    jout = capsys.readouterr().out
    return (prc, pout), (jrc, jout)


@pytest.mark.parametrize("extra", [[], ["--json"], ["--prom"]])
def test_summarize_prints_the_same_text(logs, capsys, extra):
    port, jax = _both(["summarize", logs[0]] + extra, capsys)
    assert port == jax and port[0] == 0
    if not extra:
        assert "goodput" in port[1] and "host_sync" in port[1]
    if extra == ["--json"]:
        agg = json.loads(port[1])
        assert agg["goodput"]["windows"] == 2
        assert agg["goodput"]["regressions"] == 1


def test_summarize_ranks_prints_the_same_text(logs, capsys):
    port, jax = _both(["summarize"] + logs, capsys)
    assert port == jax and port[0] == 0


def test_blackbox_prints_the_same_text(tmp_path, capsys):
    rec = jflight.FlightRecorder(str(tmp_path / "bb"), capacity=4096)
    for i in range(30):
        rec.write({"kind": "sample", "name": "trainer.step_time",
                   "t": float(i), "value": 0.05})
    rec.note("chaos.kill", point="train.step", hit=1)
    rec.close()
    for argv in (["blackbox", str(tmp_path / "bb")],
                 ["blackbox", str(tmp_path / "bb"), "--last", "5"],
                 ["blackbox", str(tmp_path / "bb"), "--json"],
                 ["blackbox", str(tmp_path / "missing")]):
        port, jax = _both(argv, capsys)
        assert port == jax, argv


def test_fleet_names_the_fleet_plane():
    with pytest.raises(MXNetError, match="item 8b"):
        pcli.main(["fleet", "http://127.0.0.1:1"])
