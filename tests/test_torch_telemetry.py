"""The port's telemetry against the JAX package's: the same hook calls
into both registries give equal snapshots (names, kinds, counts,
percentiles to 1e-9), the same Prometheus text, console table and JSONL
fields; every ported hook writes instruments whose names and kinds are
the JAX catalogue's; instrument semantics and the disabled-mode
contract (zero hook calls on the port's hot paths) hold in the port."""
import json
import math
import re
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import telemetry as jax_telemetry
from mxnet_tpu.telemetry import hooks as jax_hooks
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import hooks as thooks
from mxnet_tpu_torch.telemetry.core import Registry
from mxnet_tpu_torch.telemetry.sinks import prom_text, summary_table

# one call of every ported hook, with the arguments its JAX call sites
# pass
HOOK_CALLS = [
    ("trainer_step", (0.05, 32)),
    ("trainer_step", (0.07, 32)),
    ("amp_overflow", (65536.0, 32768.0)),
    ("amp_rescale", (32768.0, 65536.0)),
    ("numerics_check", (0.001,)),
    ("numerics_nonfinite", ("dense0_weight", 7, "nan")),
    ("checkpoint", ("save",), {"nbytes": 1024, "seconds": 0.5,
                               "step": 3}),
    ("checkpoint", ("restore",), {"nbytes": 1024, "seconds": 0.2}),
    ("checkpoint_wait", (0.01,), {"step": 3}),
    ("checkpoint_quarantine", (4, "/ck/step_00000004.corrupt")),
    ("checkpoint_retry", (1, "blip"), {"step": 5}),
    ("checkpoint_write_failed", (3, "enospc"), {"step": 5}),
    ("checkpoint_commit_aborted", (6, "rank 1 died"), {"rank": 1}),
    ("sync_contention", ("serving.registry", 0.003)),
    ("sync_hold", ("serving.registry", 0.002)),
    ("sync_watchdog", ("serving.batcher",)),
    ("sync_inversion", ("a", "b")),
    ("serving_request", ("m", 3)),
    ("serving_request", ("m", 1)),
    ("serving_shed", ("m",)),
    ("serving_timeout", ("m",)),
    ("serving_error", ("m",)),
    ("serving_batch", ("m", 3, 4, 0.004)),
    ("serving_latency", (0.006,)),
    ("serving_latency", (0.0009,)),
    ("serving_warmup", ("m", 1.5, 6)),
    ("serving_model", ("m", "checkpoint", 6)),
    ("serving_compile_cache", (False,)),
    ("serving_compile_cache", (True,)),
    ("serving_evict", ()),
    ("serving_swap", ("m", 2, 0.8, True), {"from_step": 1, "attempt": 2}),
    ("serving_swap", ("m", 3, 0.1, False), {"error": "boom"}),
    ("serving_watcher_suspended", ("m", 3, 2)),
    ("decode_request", ("gpt", 2)),
    ("decode_shed", ("gpt", "kvcache")),
    ("decode_prefill", ("gpt", 16, 5, 0.003)),
    ("decode_step", ("gpt", 3, 4, 0.001)),
    ("decode_ttft", (0.004,)),
    ("decode_inter_token", (0.0011,)),
    ("decode_finish", ("gpt", "length", 20)),
    ("kvcache_alloc", (5, 0.25)),
    ("kvcache_free", (2, 0.5)),
    ("kvcache_alloc_failure", ()),
    ("train_publish", (4, 0.3)),
    ("preemption_reentry", ()),
    ("chaos_inject", ("serving.swap", "raise")),
    ("chaos_survive", ("serving.swap", "retry")),
    ("op_dispatch", ("elemwise_add",)),
    ("host_sync", ("asnumpy", 0.002)),
    ("host_sync", ("waitall",)),
    ("compile_event", ("hybrid_cache",), {"seconds": 0.4,
                                          "retrace": True,
                                          "block": "Net"}),
    ("samples_per_sec", (512.0,)),
    ("dataloader_wait", (0.003,)),
    ("feed_produce", (0.02, 4096)),
    ("feed_wait", (0.001,)),
    ("feed_overlap", (0.9,)),
    ("memory_census", (1 << 20, 12)),
    ("memory_leak", ("(16,)/float32", 1 << 16, 1 << 20, 4)),
    ("profiling_capture", ("train_step:Net", 0.05), {"flops": 1e9}),
    ("profiling_step", ("train_step:Net", 0.01)),
    ("supervisor_restart", (1, 0, 137, 1)),
    ("supervisor_exhausted", (2, 1)),
    ("goodput_window", ({
        "index": 0, "reason": "steps", "steps": 10, "wall_s": 1.0,
        "mfu": 0.3,
        "categories": {c: {"seconds": 0.1, "share": 0.1}
                       for c in ("device_compute", "input_wait",
                                 "host_sync", "checkpoint_stall",
                                 "recompile", "other")},
        "reconciliation": {"error": 0.0, "ok": True},
        "verdict": {"detail": "mixed", "bound": "mixed"},
        "env_degraded": False},)),
    ("goodput_regression", ("host_sync", 0.05, 0.01, 5.0, 3)),
    ("goodput_env_degraded", (4, 20000.0)),
    ("env_health", (120.0,), {"h2d_mb_per_s": 9000.0}),
]


def _call_all(hooks):
    for entry in HOOK_CALLS:
        name, args = entry[0], entry[1]
        kwargs = entry[2] if len(entry) > 2 else {}
        getattr(hooks, name)(*args, **kwargs)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages start disabled with empty registries and are left
    that way."""
    for mod in (telemetry, jax_telemetry):
        mod.disable()
        mod.registry().clear()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.disable()
        if mod._jsonl_sink is not None:
            mod.registry().detach(mod._jsonl_sink)
            mod._jsonl_sink.close()
            mod._jsonl_sink = None
        mod.registry().clear()


def _close(a, b, path="snapshot"):
    """Equal structures, floats to 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert a is not None and b is not None, path
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    else:
        assert a == b, (path, a, b)


def test_parity_hook_calls_give_equal_snapshots():
    """Every ported hook, called with the same arguments in both
    packages: the snapshots agree instrument by instrument."""
    _call_all(thooks)
    _call_all(jax_hooks)
    got, want = telemetry.registry().snapshot(), \
        jax_telemetry.registry().snapshot()
    assert [r["name"] for r in got] == [r["name"] for r in want]
    _close(got, want)


def test_parity_prom_text_and_summary_table():
    _call_all(thooks)
    _call_all(jax_hooks)
    got_snap = telemetry.registry().snapshot()
    want_snap = jax_telemetry.registry().snapshot()
    assert prom_text(got_snap) == jax_telemetry.prom_text(want_snap)
    assert summary_table(got_snap) == jax_telemetry.summary_table(
        want_snap)
    assert telemetry.prom_dump() == jax_telemetry.prom_dump()


def test_parity_jsonl_fields(tmp_path):
    """The JSONL run log: the same records, field for field, but the
    wall-clock ``t``."""
    paths = []
    for mod, hooks, name in ((telemetry, thooks, "port"),
                             (jax_telemetry, jax_hooks, "jax")):
        path = str(tmp_path / (name + ".jsonl"))
        mod.attach_jsonl(path)
        _call_all(hooks)
        mod.flush()
        mod._jsonl_sink.close()
        paths.append(path)

    def records(path):
        out = []
        for line in open(path):
            rec = json.loads(line)
            rec.pop("t", None)
            out.append(rec)
        return out

    got, want = records(paths[0]), records(paths[1])
    assert len(got) == len(want) > len(HOOK_CALLS)
    _close(got, want, "jsonl")


def _catalogue_match(name, catalogue):
    """The catalogue entry of ``name``: an exact one first, else a
    ``<placeholder>`` family (a fail point's name may hold dots)."""
    for ii in catalogue:
        if ii.name == name:
            return ii
    for ii in catalogue:
        parts = re.split(r"<[^>]+>", ii.name)
        if len(parts) > 1 and re.fullmatch(
                ".+".join(re.escape(p) for p in parts), name):
            return ii
    return None


def test_every_ported_hook_writes_catalogued_instruments():
    """Each instrument a ported hook writes is in the JAX catalogue
    under its name (a ``<placeholder>`` family matching) with its kind;
    the port's catalogue is the JAX entries of those instruments."""
    _call_all(thooks)
    assert {e[0] for e in HOOK_CALLS} == set(thooks.__all__)
    written = telemetry.registry().snapshot()
    for rec in written:
        ii = _catalogue_match(rec["name"], jax_hooks.INSTRUMENTS)
        assert ii is not None, rec["name"]
        assert ii.kind == rec["kind"], rec["name"]
        port = _catalogue_match(rec["name"], thooks.INSTRUMENTS)
        assert port is not None, rec["name"]
    jax_entries = {ii.name: (ii.kind, ii.subsystem, ii.since, ii.doc)
                   for ii in jax_hooks.INSTRUMENTS}
    for ii in thooks.INSTRUMENTS:
        assert jax_entries[ii.name] == (ii.kind, ii.subsystem, ii.since,
                                        ii.doc), ii.name
    names = {r["name"] for r in written}
    unused = [ii.name for ii in thooks.INSTRUMENTS if "<" not in ii.name
              and ii.name not in names]
    assert unused == [], unused
    assert "| `serving.swaps` | counter |" in thooks.instrument_index_md()


# ---------------------------------------------------------------------
# instrument semantics (tests/test_telemetry.py's cases on the port)
# ---------------------------------------------------------------------

def test_counter_gauge_semantics():
    reg = Registry()
    c = reg.counter("c")
    c.inc()
    c.inc(4)
    c.dec()
    assert c.value == 4 and reg.counter("c") is c
    g = reg.gauge("g")
    for v in (2.0, 0.5, 1.0):
        g.set(v)
    snap = g.snapshot()
    assert snap["value"] == 1.0 and snap["min"] == 0.5 \
        and snap["max"] == 2.0 and snap["count"] == 3


def test_timer_percentiles_match_the_jax_estimator():
    rng = np.random.default_rng(0)
    obs = rng.lognormal(-6, 1.5, 500)
    t, jt = Registry().timer("t"), jax_telemetry.Registry().timer("t")
    for v in obs:
        t.observe(float(v))
        jt.observe(float(v))
    for q in (0.5, 0.95, 0.99, 1.0):
        assert t.percentile(q) == jt.percentile(q)
    assert t.count == 500 and math.isclose(t.sum, float(obs.sum()))
    with t.time():
        pass
    assert t.count == 501


def test_event_ring_and_kind_conflict():
    reg = Registry()
    ev = reg.event("e")
    for i in range(300):
        ev.emit(i=i)
    assert ev.count == 300 and len(ev.recent) == 256
    assert ev.recent[-1] == {"i": 299}
    with pytest.raises(ValueError):
        reg.counter("e")


def test_reset_and_prefix_reset():
    reg = Registry()
    reg.counter("a.x").inc(2)
    reg.counter("b.y").inc(3)
    reg.reset("a.")
    assert reg.counter("a.x").value == 0 and reg.counter("b.y").value == 3
    reg.reset()
    assert reg.counter("b.y").value == 0
    reg.clear("b.")
    assert reg.names() == ["a.x"]


def test_instrument_increments_atomic_under_hammer():
    reg = Registry()
    c = reg.counter("hammer")
    n, per = 8, 2000

    def worker():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == n * per


def test_enable_snapshot_reset():
    assert not telemetry.enabled()
    telemetry.enable()
    assert telemetry.enabled()
    telemetry.counter("x.y").inc(2)
    assert telemetry.snapshot() == [{"kind": "counter", "name": "x.y",
                                     "value": 2}]
    telemetry.reset()
    assert telemetry.snapshot()[0]["value"] == 0
    telemetry.disable()
    assert not telemetry.enabled()


# ---------------------------------------------------------------------
# the disabled-mode contract on the port's hot paths
# ---------------------------------------------------------------------

def _exercise_hot_paths(tmp_path):
    """Serving, decode, checkpoints, the trainer and AMP's scaler, on
    the CPU."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.amp.loss_scaler import LossScaler
    from mxnet_tpu_torch.chaos import scenarios
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.serving import ModelRegistry
    from mxnet_tpu_torch.serving.decode import tiny_gpt
    net, trainer, loss_fn, (x, y) = scenarios.train_fixtures(
        device="cpu")
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(8)
    sc = LossScaler(scale_window=1)
    sc.update_scale(True)
    sc.update_scale(False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save_training(1, net, trainer)
    mgr.restore_training(net, trainer)
    reg = ModelRegistry()
    reg.register("m", block=net, input_shape=(8,), buckets=(1, 2),
                 max_wait_ms=1)
    reg.infer("m", np.ones(8, np.float32), timeout=10)
    model = tiny_gpt(vocab_size=32, units=16, num_layers=1, num_heads=2,
                     max_seq=32)
    reg.register_generative("g", model,
                            params=model.init_params(0, device="cpu"),
                            prefill_buckets=(8,), decode_buckets=(1,),
                            block_size=4, num_blocks=16, device="cpu")
    assert len(reg.generate("g", [1, 2, 3], 3).tokens()) == 3
    reg.shutdown()
    del gluon


def test_disabled_mode_makes_zero_hook_calls(monkeypatch, tmp_path):
    calls = []
    for name in thooks.__all__:
        orig = getattr(thooks, name)

        def counted(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(thooks, name, counted)
    with mx.cpu():
        _exercise_hot_paths(tmp_path / "off")
        assert calls == [], calls
        telemetry.enable()
        _exercise_hot_paths(tmp_path / "on")
    fired = set(calls)
    assert {"trainer_step", "amp_overflow", "amp_rescale", "checkpoint",
            "serving_request", "serving_batch", "serving_latency",
            "serving_warmup", "serving_model", "serving_compile_cache",
            "decode_request", "decode_prefill", "decode_step",
            "decode_finish", "kvcache_alloc", "kvcache_free"} <= fired, \
        sorted(fired)
