"""The port's chaos harness and the recovery paths it exercises, on the
CPU: the cases of ``tests/test_chaos.py`` that the port's modules cover
-- fail-point rules (the same fire sequence as the JAX package for a
seed), checkpoint quarantine and kill-mid-commit, async-write retries,
preemption re-entrancy, the batcher flood, and the continuous-train ->
hot-swap loop under injected faults."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import chaos as jax_chaos
from mxnet_tpu_torch import chaos, serving, telemetry
from mxnet_tpu_torch.chaos import scenarios
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.checkpoint.async_writer import AsyncWriter
from mxnet_tpu_torch.serving.loop import ContinuousTrainer, RegistryWatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_and_clean_chaos():
    chaos.reset()
    with mx.cpu():
        yield
    chaos.disarm()
    chaos.reset()


@pytest.fixture()
def counters():
    telemetry.enable()
    yield telemetry
    telemetry.disable()


def _loop_parts(tmp_path, publish_every=2):
    net, trainer, loss_fn, data = scenarios.train_fixtures(seed=0,
                                                           device="cpu")
    ct = ContinuousTrainer(net, trainer, loss_fn, data,
                           str(tmp_path / "ck"),
                           publish_every=publish_every)
    return net, ct


# ---------------------------------------------------------------------
# fail-point core, against the JAX package
# ---------------------------------------------------------------------

def _fires(mod, seed, rules, hits):
    """The fire sequence of ``hits`` visits of point ``p`` under
    ``rules`` (keyword dicts of ``on``), and the stats."""
    fired = []
    with mod.scenario(seed=seed):
        for kw in rules:
            mod.on("p", **kw)
        for _ in range(hits):
            try:
                mod.fail_point("p")
                fired.append(False)
            except mod.ChaosInjected:
                fired.append(True)
    return fired, mod.stats()


@pytest.mark.parametrize("seed", [0, 7, 8])
@pytest.mark.parametrize("rules", [
    [{"nth": (2, 3)}],
    [{"prob": 0.5}],
    [{"prob": 0.3, "times": 4}],
    [{"times": 1}],
    [{"nth": 5}, {"prob": 0.25}],
], ids=["nth", "prob", "prob-times", "times", "nth-and-prob"])
def test_rules_replay_the_jax_fire_sequence(seed, rules):
    want = _fires(jax_chaos, seed, rules, 32)
    got = _fires(chaos, seed, rules, 32)
    assert got == want
    assert any(got[0])


def test_fail_point_disarmed_is_noop():
    chaos.on("never", action=chaos.RAISE)
    chaos.fail_point("never")
    assert chaos.stats()["hits"] == {}


def test_spec_round_trip_matches_the_jax_package():
    rules = [{"point": "a", "nth": [1, 3]},
             {"point": "b", "action": {"sleep": 0.0}, "rank": 1},
             {"point": "c", "action": {"truncate": {"fname": "x",
                                                    "keep": 2}}}]
    spec = chaos.make_spec(seed=4, rules=rules)
    assert spec == jax_chaos.make_spec(seed=4, rules=rules)
    assert chaos.arm_from_spec(spec, rank=0, generation=0)
    assert chaos.armed()
    with pytest.raises(chaos.ChaosInjected):
        chaos.fail_point("a")
    chaos.fail_point("b")                  # scoped to rank 1: skipped
    assert chaos.stats()["injected"] == {"a": 1}
    assert not chaos.arm_from_spec("")


def test_injection_counts_in_telemetry(counters):
    telemetry.reset("chaos.")
    with chaos.scenario(seed=0):
        chaos.on("t", times=1)
        with pytest.raises(chaos.ChaosInjected):
            chaos.fail_point("t")
    chaos.survived("t", "test")
    assert telemetry.counter("chaos.injected").value == 1
    assert telemetry.counter("chaos.injected.t").value == 1
    assert telemetry.counter("chaos.survived.t").value == 1


# ---------------------------------------------------------------------
# checkpoint: quarantine and kill-mid-commit
# ---------------------------------------------------------------------

def _two_steps(tmp_path, **kwargs):
    mgr = CheckpointManager(str(tmp_path / "ck"), **kwargs)
    mgr.save(1, {"blob": b"one"})
    mgr.save(2, {"blob": b"two"})
    return mgr


def test_torn_newest_step_is_quarantined(tmp_path, counters):
    telemetry.reset("checkpoint.")
    mgr = _two_steps(tmp_path)
    with open(os.path.join(mgr.step_dir(2), "blob.bin"), "r+b") as f:
        f.truncate(1)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        assert mgr.latest_step() == 1
    assert not os.path.isdir(mgr.step_dir(2))
    assert os.path.isdir(mgr.step_dir(2) + ".corrupt")
    assert mgr.all_steps() == [1]
    assert telemetry.counter("checkpoint.quarantined").value == 1
    assert mgr.restore().step == 1


def test_quarantine_off_keeps_skip_only_discovery(tmp_path):
    mgr = _two_steps(tmp_path, quarantine=False)
    os.remove(os.path.join(mgr.step_dir(2), "manifest.json"))
    with pytest.warns(RuntimeWarning):
        assert mgr.latest_step() == 1
    assert os.path.isdir(mgr.step_dir(2))


def test_chaos_truncate_action_tears_a_committed_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with chaos.scenario(seed=0):
        chaos.on("checkpoint.commit.post_commit", nth=2,
                 action=chaos.truncate("blob.bin", keep=1))
        mgr.save(1, {"blob": b"step-one"})
        mgr.save(2, {"blob": b"step-two"})
    with pytest.warns(RuntimeWarning):
        assert mgr.latest_step() == 1
    assert chaos.stats()["injected"] == \
        {"checkpoint.commit.post_commit": 1}
    assert chaos.stats()["survived"] == {"checkpoint.commit": 1}


def test_kill_mid_commit_subprocess_costs_one_step(tmp_path):
    """A real kill (os._exit) between the data files and the manifest
    commit: the staged step never becomes loadable, discovery lands on
    the previous step, and the next manager sweeps the staging dir."""
    root = str(tmp_path / "ck")
    code = (
        "from mxnet_tpu_torch import chaos\n"
        "from mxnet_tpu_torch.checkpoint import CheckpointManager\n"
        "mgr = CheckpointManager(%r)\n"
        "chaos.arm(seed=0)\n"
        "chaos.on('checkpoint.commit.pre_manifest', nth=2,\n"
        "         action=chaos.KILL)\n"
        "mgr.save(1, {'blob': b'one'})\n"
        "mgr.save(2, {'blob': b'two'})\n"
        "raise SystemExit('kill did not fire')\n" % root)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 137, (out.returncode, out.stderr[-500:])
    assert [d for d in os.listdir(root) if d.endswith(".tmp")]
    mgr = CheckpointManager(root)           # init sweeps dead-pid tmps
    assert mgr.latest_step() == 1
    assert not any(d.endswith(".tmp") for d in os.listdir(root))


# ---------------------------------------------------------------------
# async writer: bounded retry and surfaced failure
# ---------------------------------------------------------------------

def test_async_write_retries_then_lands(tmp_path, counters):
    telemetry.reset("checkpoint.")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr._writer = AsyncWriter(retries=2, backoff_s=0.01)
    with chaos.scenario(seed=0):
        chaos.on("checkpoint.async_write", nth=(1, 2))
        mgr.save(1, {"blob": b"retry-me"})
        mgr.wait_until_finished()
    assert mgr.latest_step() == 1
    assert telemetry.counter("checkpoint.write_retries").value == 2
    assert telemetry.counter("checkpoint.write_failures").value == 0
    assert chaos.stats()["survived"] == {"checkpoint.async_write": 1}


def test_async_write_final_failure_surfaces(tmp_path, counters):
    telemetry.reset("checkpoint.")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr._writer = AsyncWriter(retries=1, backoff_s=0.01)
    with chaos.scenario(seed=0):
        chaos.on("checkpoint.async_write")
        mgr.save(1, {"blob": b"doomed"})
        with pytest.raises(chaos.ChaosInjected):
            mgr.wait_until_finished()
    assert mgr.latest_step() is None
    assert telemetry.counter("checkpoint.write_retries").value == 1
    assert telemetry.counter("checkpoint.write_failures").value == 1
    assert telemetry.event("checkpoint.write_failed").recent[-1][
        "attempts"] == 2
    from mxnet_tpu_torch.obs import status
    ready, reasons = status.health()
    assert not ready and "checkpoint_write_failures:1" in reasons
    telemetry.reset("checkpoint.")


# ---------------------------------------------------------------------
# preemption: re-entrant signal delivery
# ---------------------------------------------------------------------

def test_reentrant_sigterm_cannot_tear_the_save(tmp_path, counters):
    telemetry.reset("preemption.")
    from mxnet_tpu_torch import preemption
    net, trainer, _, _ = scenarios.train_fixtures(seed=0, device="cpu")
    prefix = str(tmp_path / "job")
    handler = preemption.PreemptionHandler(prefix, net, trainer,
                                           signals=(),
                                           save_in_handler=True)
    nested = []

    def deliver_nested(ctx):
        nested.append(True)
        ctx["handler"]._on_signal(signal.SIGTERM, None)

    with chaos.scenario(seed=0):
        chaos.on("preemption.signal", nth=1, action=deliver_nested)
        handler._on_signal(signal.SIGTERM, None)
    assert nested and handler.saved
    assert telemetry.counter("preemption.reentrant_signals").value == 1
    assert chaos.stats()["survived"] == {"preemption.signal": 1}
    net2, trainer2, _, _ = scenarios.train_fixtures(seed=1, device="cpu")
    assert preemption.resume(prefix, net2, trainer2) is not None
    for a, b in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        assert np.array_equal(a.data().asnumpy(), b.data().asnumpy())
    handler.uninstall()


def test_signal_during_boundary_save_is_suppressed(tmp_path, counters):
    telemetry.reset("preemption.")
    from mxnet_tpu_torch import preemption
    net, trainer, _, _ = scenarios.train_fixtures(seed=0, device="cpu")
    prefix = str(tmp_path / "job2")
    handler = preemption.PreemptionHandler(prefix, net, trainer,
                                           signals=())
    orig = net.save_parameters
    calls = []

    def interrupted_save(path):
        calls.append(path)
        if len(calls) == 1:
            handler._on_signal(signal.SIGTERM, None)
        return orig(path)

    net.save_parameters = interrupted_save
    handler.save_now(step=5)
    assert len(calls) == 1
    assert handler.saved and handler.triggered
    assert telemetry.counter("preemption.reentrant_signals").value == 1
    net2, trainer2, _, _ = scenarios.train_fixtures(seed=1, device="cpu")
    meta = preemption.resume(prefix, net2, trainer2)
    assert meta is not None and meta["step"] == 5
    handler.uninstall()


def test_continuous_trainer_stops_at_a_preemption(tmp_path):
    from mxnet_tpu_torch import preemption
    net, ct = _loop_parts(tmp_path, publish_every=1)
    ct.handler = preemption.PreemptionHandler(
        str(tmp_path / "pre"), net, ct.trainer, signals=())
    ct.run_steps(2)
    ct.handler._on_signal(signal.SIGTERM, None)
    assert ct.run_steps(3) is None and ct.step == 2
    assert ct.handler.saved
    ct.handler.uninstall()
    ct.close()


# ---------------------------------------------------------------------
# batcher: flood past the queue bound
# ---------------------------------------------------------------------

def test_flood_past_queue_bound_sheds_and_completes(counters):
    telemetry.reset("serving.")
    rep = scenarios.flood_scenario(seed=0, max_queue=4, clients=8,
                                   per_client=8, hold_s=0.02,
                                   device="cpu")
    assert rep["shed"] > 0 and rep["errors"] == []
    assert rep["shed_counter_delta"] == rep["shed"]
    assert rep["completed"] + rep["shed"] == rep["requests"]
    assert rep["completed"] > 0
    assert rep["max_latency_s"] < rep["latency_bound_s"]


def test_shed_error_is_distinct_and_inflight_completes():
    net = scenarios.make_mlp(device="cpu")
    reg = serving.ModelRegistry(compile_cache=False)
    with chaos.scenario(seed=0):
        chaos.on("serving.dispatch", action=chaos.sleep(0.05), times=1)
        s = reg.register("m", block=net, input_shape=(8,), buckets=(1,),
                         max_wait_ms=1, max_queue=1)
        x = np.ones(8, np.float32)
        first = s.submit(x)
        for _ in range(200):
            if s.queue_depth() == 0:
                break
            time.sleep(0.002)
        queued = s.submit(x)
        with pytest.raises(serving.ServingQueueFull):
            s.submit(x)
        assert first.result(timeout=10) is not None
        assert queued.result(timeout=10) is not None
    reg.shutdown(drain=True)


def test_dispatch_fault_fails_the_batch_not_the_worker(counters):
    telemetry.reset("serving.")
    reg = serving.ModelRegistry()
    s = reg.register("m", block=scenarios.make_mlp(device="cpu"),
                     input_shape=(8,), buckets=(1,), max_wait_ms=1)
    x = np.ones(8, np.float32)
    with chaos.scenario(seed=0):
        chaos.on("serving.dispatch", nth=1)
        with pytest.raises(chaos.ChaosInjected):
            s.infer(x, timeout=10)
        assert s.infer(x, timeout=10).shape == (4,)
    assert telemetry.counter("serving.errors").value == 1
    reg.shutdown()


# ---------------------------------------------------------------------
# the always-on loop: continuous train -> hot swap, under chaos
# ---------------------------------------------------------------------

def test_hotswap_zero_dropped_requests(tmp_path):
    rep = scenarios.hotswap_scenario(str(tmp_path / "loop"), torn=False,
                                     seed=0, device="cpu")
    assert rep["first_swap_step"] == 2 and rep["second_swap_step"] == 4
    assert rep["served_step"] == 4
    assert rep["errors"] == [] and rep["shed"] == 0
    assert rep["completed"] == rep["requests"]
    assert rep["completed_after_swap"] >= 1
    assert rep["quarantined"] == []


def test_kill_mid_commit_rolls_watcher_back(tmp_path):
    rep = scenarios.hotswap_scenario(str(tmp_path / "loop"), torn=True,
                                     seed=0, device="cpu")
    assert rep["second_swap_step"] is None
    assert rep["served_step"] == 2 and rep["published_step"] == 4
    assert rep["quarantined"] == ["step_00000004.corrupt"]
    assert rep["errors"] == []
    assert rep["chaos"]["injected"] == \
        {"checkpoint.commit.post_commit": 1}
    assert rep["chaos"]["survived"]["checkpoint.commit"] == 1


def test_swap_abort_retries_with_backoff(tmp_path, counters):
    telemetry.reset("serving.")
    net, ct = _loop_parts(tmp_path, publish_every=1)
    reg = serving.ModelRegistry(compile_cache=False)
    watcher = RegistryWatcher(reg, "m", ct.manager,
                              scenarios.make_mlp(device="cpu"),
                              input_shape=(8,), buckets=(1,),
                              max_wait_ms=1, swap_retries=1,
                              swap_backoff_s=0.01)
    ct.run_steps(1)
    with chaos.scenario(seed=0):
        chaos.on("serving.swap", nth=1)
        assert watcher.poll_once() == 1
    assert watcher.served_step == 1
    assert telemetry.counter("serving.swap_failures").value == 1
    assert telemetry.counter("serving.swaps").value == 1
    assert chaos.stats()["survived"]["serving.swap"] == 1
    ct.close()
    watcher.close()
    reg.shutdown(drain=True)


def test_swap_failure_budget_suspends_watcher(tmp_path, counters):
    telemetry.reset("serving.")
    from mxnet_tpu_torch.obs import status
    net, ct = _loop_parts(tmp_path, publish_every=1)
    reg = serving.ModelRegistry(compile_cache=False)
    watcher = RegistryWatcher(reg, "m", ct.manager,
                              scenarios.make_mlp(device="cpu"),
                              input_shape=(8,), buckets=(1,),
                              max_wait_ms=1, swap_retries=1,
                              swap_backoff_s=0.01, failure_budget=2)
    ct.run_steps(1)
    with chaos.scenario(seed=0):
        chaos.on("serving.swap")
        with pytest.warns(RuntimeWarning, match="swap to step 1"):
            assert watcher.poll_once() is None
        assert watcher.bad_steps() == [1]
        assert watcher.poll_once() is None
        assert not watcher.suspended
        ct.run_steps(1)
        with pytest.warns(RuntimeWarning, match="budget exhausted"):
            assert watcher.poll_once() is None
        assert watcher.suspended
    assert watcher.served_step is None
    assert "m" not in reg
    assert telemetry.counter("serving.swap_failures").value == 4
    assert telemetry.counter("serving.watcher_suspensions").value == 1
    ready, reasons = status.health()
    assert not ready and "watcher_suspended:m" in reasons
    ct.close()
    watcher.close()
    reg.shutdown(drain=True)


def test_continuous_trainer_resumes_from_published_step(tmp_path):
    net, ct = _loop_parts(tmp_path, publish_every=2)
    ct.run_steps(4)
    assert ct.published_step == 4
    ct.close()
    net2, trainer2, loss_fn2, data2 = scenarios.train_fixtures(
        seed=0, device="cpu")
    ct2 = ContinuousTrainer(net2, trainer2, loss_fn2, data2,
                            ct.manager.root, publish_every=2)
    ckpt = ct2.resume()
    assert ckpt is not None and ckpt.step == 4 and ct2.step == 4
    ct2.run_steps(2)
    assert ct2.published_step == 6
    ct2.close()


def test_nonfinite_chaos_point_is_caught_by_the_sentinel(tmp_path,
                                                         monkeypatch):
    """``numerics.nonfinite`` poisons one batch; the armed sentinel
    names a parameter before the optimizer applies the update."""
    from mxnet_tpu_torch.analysis import numerics
    monkeypatch.setattr(numerics, "_CHECK", True)
    net, ct = _loop_parts(tmp_path, publish_every=10)
    with chaos.scenario(seed=0):
        chaos.on("numerics.nonfinite", numerics.poison_action, nth=2)
        ct.run_steps(1)
        with pytest.raises(numerics.NonFiniteError) as ei:
            ct.run_steps(1)
    assert ei.value.step == 2 and ei.value.kind == "nan"
    assert numerics.status_row()["last"]["step"] == 2
    ct.close()
