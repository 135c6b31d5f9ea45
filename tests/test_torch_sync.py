"""The port's instrumented synchronization layer against the JAX
package's: the cases of ``tests/test_sync.py`` run through both
``mxnet_tpu.sync`` and ``mxnet_tpu_torch.sync`` (one parametrised case
each), and the same lock orders give the same inversion reports (less
the stack frames) and the same error types."""
import os
import re
import threading

import pytest

from mxnet_tpu import sync as jax_sync
from mxnet_tpu import telemetry as jax_telemetry
from mxnet_tpu_torch import sync as torch_sync
from mxnet_tpu_torch import telemetry as torch_telemetry

_TSAN_ENV = os.environ.get("MXNET_TPU_TSAN", "0") != "0"
PKGS = {"jax": (jax_sync, jax_telemetry),
        "torch": (torch_sync, torch_telemetry)}
JOIN_S = 10


@pytest.fixture(params=sorted(PKGS))
def sync(request):
    """Each package's sync module, left as it was found."""
    mod = PKGS[request.param][0]
    was_on = mod.tsan_enabled()
    yield mod
    if was_on:
        mod.enable(seed_static=False)
    else:
        mod.disable()
    mod.configure(raise_on_inversion=True,
                  watchdog_s=mod._watchdog_default())
    mod.reset_state()


def _join(*threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


@pytest.mark.skipif(_TSAN_ENV, reason="suite running under TSAN")
def test_off_mode_returns_raw_primitives(sync):
    assert type(sync.Lock()) is type(threading.Lock())
    assert type(sync.RLock()) is type(threading.RLock())
    assert isinstance(sync.Condition(), threading.Condition)
    assert isinstance(sync.Event(), threading.Event)
    lk = sync.Lock(name="probe")
    cond = sync.Condition(lk)
    with cond:
        cond.notify_all()


def test_enable_switches_factories(sync):
    sync.enable(seed_static=False)
    try:
        assert isinstance(sync.Lock(name="a"), sync._TsanLock)
        assert isinstance(sync.RLock(name="b"), sync._TsanRLock)
        assert isinstance(sync.Condition(name="c"), sync._TsanCondition)
        assert isinstance(sync.Event(name="d"), sync._TsanEvent)
    finally:
        sync.disable()


def test_wrappers_turn_inert_after_disable(sync):
    sync.enable(seed_static=False)
    a = sync.Lock(name="inert.a")
    b = sync.Lock(name="inert.b")
    sync.disable()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert "inert.a" not in sync.order_graph()


def test_lock_order_inversion_raises(sync):
    sync.enable(watchdog_s=30, seed_static=False)
    a = sync.Lock(name="inv.a")
    b = sync.Lock(name="inv.b")
    with a:
        with b:
            pass
    with pytest.raises(sync.LockOrderError) as ei:
        with b:
            with a:
                pass
    msg = str(ei.value)
    assert "inv.a" in msg and "inv.b" in msg and "acquired at" in msg
    assert a._inner.acquire(timeout=1)      # the failed acquire let go
    a._inner.release()


def test_inversion_report_only_mode_records(sync):
    sync.enable(watchdog_s=30, seed_static=False)
    sync.configure(raise_on_inversion=False)
    a = sync.Lock(name="rep.a")
    b = sync.Lock(name="rep.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    reports = sync.recorded_reports()
    assert len(reports) == 1
    assert "rep.a" in reports[0] and "rep.b" in reports[0]


def test_rlock_reentry_adds_no_edges(sync):
    sync.enable(watchdog_s=30, seed_static=False)
    r = sync.RLock(name="re.r")
    other = sync.Lock(name="re.other")
    with r:
        with r:
            with other:
                pass
    assert sync.order_graph().get("re.r") == {"re.other"}
    with pytest.raises(sync.LockOrderError):
        with other:
            with r:
                pass


def test_three_lock_cycle_detected(sync):
    sync.enable(watchdog_s=30, seed_static=False)
    a, b, c = (sync.Lock(name="cyc.%s" % n) for n in "abc")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(sync.LockOrderError) as ei:
        with c:
            with a:
                pass
    assert "cyc.b" in str(ei.value)


def test_static_seed_is_best_effort_and_idempotent(sync):
    sync.enable(seed_static=True)
    assert sync.seed_static_order() == 0
    lk = sync.Lock(name="seed.probe")
    with lk:
        pass


def test_seed_static_order_folds_the_port_trees_edges(monkeypatch):
    """The port's sanitizer seeds its graph from the static pass over its
    own source, as the JAX package's does: it returns the count folded
    (the port's tree nests no two inventoried locks today, so 0), and a
    planted edge of the pass is folded and then raises at the first
    runtime nesting that contradicts it."""
    from mxnet_tpu_torch.analysis import concurrency, static_order_edges
    pkg = os.path.dirname(torch_sync.__file__)
    torch_sync.reset_state()
    try:
        assert torch_sync.seed_static_order() == \
            len(static_order_edges([pkg]))
        torch_sync.reset_state()
        monkeypatch.setattr(concurrency, "static_order_edges",
                            lambda paths: {("seed.outer", "seed.inner")})
        torch_sync.enable(seed_static=False)
        assert torch_sync.seed_static_order() == 1
        assert torch_sync.seed_static_order() == 0      # idempotent
        assert "seed.inner" in torch_sync.order_graph()["seed.outer"]
        outer = torch_sync.Lock(name="seed.outer")
        inner = torch_sync.Lock(name="seed.inner")
        with pytest.raises(torch_sync.LockOrderError):
            with inner:
                with outer:
                    pass
    finally:
        torch_sync.disable()
        torch_sync.reset_state()


def test_watchdog_fires_on_crossed_lock_deadlock(sync):
    sync.enable(watchdog_s=1.0, seed_static=False)
    sync.configure(raise_on_inversion=False)
    a = sync.Lock(name="dead.a")
    b = sync.Lock(name="dead.b")
    barrier = threading.Barrier(2, timeout=5)
    errs = {}

    def cross(first, second, key):
        try:
            with first:
                barrier.wait()
                with second:
                    pass
        except sync.DeadlockError as e:
            errs[key] = str(e)

    t1 = threading.Thread(target=cross, args=(a, b, "t1"), daemon=True)
    t2 = threading.Thread(target=cross, args=(b, a, "t2"), daemon=True)
    t1.start()
    t2.start()
    _join(t1, t2)
    assert errs, "no watchdog fired on a crossed-lock deadlock"
    report = next(iter(errs.values()))
    assert "DEADLOCK watchdog" in report
    assert "holds 'dead.a' acquired at" in report
    assert "holds 'dead.b' acquired at" in report
    assert "all thread stacks" in report and "cross" in report


def test_watchdog_respects_caller_timeouts(sync):
    sync.enable(watchdog_s=1.0, seed_static=False)
    lk = sync.Lock(name="to.lk")
    hold = threading.Event()
    release = threading.Event()

    def holder():
        with lk:
            hold.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert hold.wait(5)
    assert lk.acquire(timeout=0.1) is False
    assert lk.acquire(blocking=False) is False
    release.set()
    _join(t)


def test_event_untimed_wait_watchdogged(sync):
    sync.enable(watchdog_s=0.3, seed_static=False)
    ev = sync.Event(name="ev.never")
    with pytest.raises(sync.DeadlockError):
        ev.wait()
    assert ev.wait(0.05) is False
    ev.set()
    assert ev.wait() is True


def test_condition_wait_notify_under_tsan(sync):
    sync.enable(watchdog_s=5, seed_static=False)
    cond = sync.Condition(name="cv.test")
    items = []

    def producer():
        for i in range(3):
            with cond:
                items.append(i)
                cond.notify_all()

    t = threading.Thread(target=producer, daemon=True)
    with cond:
        t.start()
        ok = cond.wait_for(lambda: len(items) == 3, timeout=5)
        got = list(items)
    _join(t)
    assert ok and got == [0, 1, 2]
    assert "cv.test" not in sync.order_graph().get("cv.test.lock", set())


def test_condition_untimed_wait_watchdogged(sync):
    sync.enable(watchdog_s=0.3, seed_static=False)
    cond = sync.Condition(name="cv.stuck")
    with pytest.raises(sync.DeadlockError):
        with cond:
            cond.wait()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_sync_telemetry_counts_watchdog_and_inversions(pkg):
    sync, telemetry = PKGS[pkg]
    telemetry.reset("sync.")
    telemetry.enable()
    try:
        sync.enable(watchdog_s=0.2, seed_static=False)
        sync.configure(raise_on_inversion=False)
        a = sync.Lock(name="tel.a")
        b = sync.Lock(name="tel.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert telemetry.counter("sync.inversions").value >= 1
        ev = sync.Event(name="tel.ev")
        with pytest.raises(sync.DeadlockError):
            ev.wait()
        assert telemetry.counter("sync.watchdog_fires").value >= 1
    finally:
        telemetry.disable()
        sync.disable()
        sync.configure(raise_on_inversion=True,
                       watchdog_s=sync._watchdog_default())
        sync.reset_state()


def _orders(sync, script, raise_on_inversion):
    """Run ``script`` (nestings of lock names, outer first) through one
    package; returns the error type of each nesting (or None), the
    order graph and the reports with file/line frames and the package
    name stripped."""
    sync.enable(watchdog_s=30, seed_static=False)
    sync.configure(raise_on_inversion=raise_on_inversion)
    try:
        locks = {}
        errors = []
        for nest in script:
            held = []
            try:
                for name in nest:
                    lk = locks.setdefault(name, sync.Lock(name=name))
                    lk.acquire()
                    held.append(lk)
                errors.append(None)
            except RuntimeError as e:
                errors.append(type(e).__name__)
            finally:
                for lk in reversed(held):
                    lk.release()
        reports = [
            "\n".join(line for line in r.splitlines()
                      if not re.match(r'\s+File "', line))
            .replace("mxnet_tpu_torch.sync", "SYNC")
            .replace("mxnet_tpu.sync", "SYNC")
            for r in sync.recorded_reports()]
        return errors, sync.order_graph(), reports
    finally:
        sync.disable()
        sync.configure(raise_on_inversion=True,
                       watchdog_s=sync._watchdog_default())
        sync.reset_state()


@pytest.mark.parametrize("raise_on_inversion", [True, False])
@pytest.mark.parametrize("script", [
    [("o.a", "o.b"), ("o.b", "o.a")],
    [("o.a", "o.b"), ("o.b", "o.c"), ("o.c", "o.a"), ("o.a", "o.c")],
    [("o.a", "o.b", "o.c"), ("o.c", "o.b"), ("o.b", "o.a")],
    [("o.a", "o.b"), ("o.a", "o.c"), ("o.b", "o.c")],
], ids=["ab-ba", "three-cycle", "nested-three", "no-cycle"])
def test_same_orders_give_the_same_reports(script, raise_on_inversion):
    """One lock-order script through both packages: the same error type
    at the same nesting, the same order graph and, in report-only mode,
    the same reports line for line (stack frames aside)."""
    want = _orders(jax_sync, script, raise_on_inversion)
    got = _orders(torch_sync, script, raise_on_inversion)
    assert got == want
