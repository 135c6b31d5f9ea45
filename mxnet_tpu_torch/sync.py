"""Instrumented synchronization layer (counterpart of
``mxnet_tpu/sync.py``).

The port's serving tier, checkpoint writer, telemetry, chaos and the
always-on loop create their locks, conditions and events through the
factories here instead of ``threading`` directly::

    self._lock = sync.Lock(name="telemetry.registry")

- **Flag off** (the default): each factory returns the raw ``threading``
  primitive -- no wrapper, nothing paid on acquire or release.
- **Flag on** (``MXNET_TPU_TSAN=1`` or :func:`enable`): factories return
  sanitizing wrappers that

  * record per-thread acquisition stacks and a global *lock-order
    graph* of observed nestings;
  * raise :class:`LockOrderError` the moment an acquisition would
    create an A/B--B/A cycle -- before the schedule that deadlocks
    ever runs;
  * time-bound every untimed blocking acquisition/wait with a
    **deadlock watchdog** (``MXNET_TPU_TSAN_WATCHDOG_S``, default 20s)
    that dumps every thread's stack plus the table of who holds which
    lock (acquired where) and raises :class:`DeadlockError`;
  * emit ``sync.*`` telemetry (contention waits, hold times, watchdog
    fires, recorded inversions) when telemetry is also enabled.

Lock *names* are role identities: every ``Instrument._lock`` shares the
name ``telemetry.instrument``, so the order graph reasons about roles,
not instances.  Unnamed locks get a ``file:line`` creation-site
identity.  :func:`seed_static_order` also seeds the graph with the
static lock-order pass's edges over the port's own source
(``analysis/concurrency.py :: static_order_edges``), as the JAX
package's does, so the first runtime nesting that contradicts the
code's order raises.
"""
from __future__ import annotations

import os
import sys
import threading as _threading
import time
import traceback

__all__ = [
    "Lock", "RLock", "Condition", "Event",
    "enable", "disable", "tsan_enabled", "configure",
    "DeadlockError", "LockOrderError",
    "order_graph", "recorded_reports", "reset_state", "seed_static_order",
    "watchdog_seconds",
]


class DeadlockError(RuntimeError):
    """The watchdog expired on a blocking acquisition/wait: some thread
    has held the needed lock longer than ``MXNET_TPU_TSAN_WATCHDOG_S``.
    The message carries every thread's stack and the held-locks table."""


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the observed+static
    lock-order graph -- the A/B--B/A pattern that deadlocks under the
    wrong schedule even if THIS run got lucky."""


# -- module state ------------------------------------------------------
# The flag is read at *factory* time (which wrapper class you get) and
# at wrapper *use* time (so a test's leftover wrappers turn inert after
# disable()).  Everything below uses raw threading primitives: the
# sanitizer must not sanitize itself.

_TSAN = os.environ.get("MXNET_TPU_TSAN", "0") != "0"
_RAISE_ON_INVERSION = True

_tls = _threading.local()            # per-thread held-lock stack
_meta_lock = _threading.Lock()       # guards the structures below
_order = {}                          # name -> set(successor names)
_edge_sites = {}                     # (a, b) -> "thread/stack" of first obs
_held_by_thread = {}                 # thread ident -> shared held list
_reports = []                        # report-only inversion texts
_static_seeded = False
_seeding = False


def _watchdog_default():
    try:
        return float(os.environ.get("MXNET_TPU_TSAN_WATCHDOG_S", "20"))
    except ValueError:
        return 20.0


_WATCHDOG_S = _watchdog_default()

# contention/hold telemetry floor: micro-acquisitions (every uncontended
# acquire "waits" a few ns of syscall time) would otherwise stream a
# timer sample per lock op and drown the run log
_EMIT_THRESHOLD_S = 1e-3


def watchdog_seconds():
    return _WATCHDOG_S


def tsan_enabled():
    return _TSAN


def enable(watchdog_s=None, seed_static=True):
    """Turn the sanitizer on for primitives created from now on.
    ``seed_static=True`` (default) folds the static pass's
    acquisition-order edges into the runtime graph, so the first
    runtime nesting that contradicts the *code's* order -- not just a
    previously observed one -- already raises."""
    global _TSAN, _WATCHDOG_S
    _TSAN = True
    if watchdog_s is not None:
        _WATCHDOG_S = float(watchdog_s)
    if seed_static:
        seed_static_order()


def disable():
    global _TSAN
    _TSAN = False


def configure(raise_on_inversion=None, watchdog_s=None):
    """Tune sanitizer behavior.  ``raise_on_inversion=False`` switches
    to report-only mode (inversions are recorded in
    :func:`recorded_reports` and counted in telemetry, but execution
    proceeds -- letting a *true* deadlock form for the watchdog, or a
    long soak run collect every ordering violation at once)."""
    global _RAISE_ON_INVERSION, _WATCHDOG_S
    if raise_on_inversion is not None:
        _RAISE_ON_INVERSION = bool(raise_on_inversion)
    if watchdog_s is not None:
        _WATCHDOG_S = float(watchdog_s)


def reset_state():
    """Drop the observed order graph, reports, and held-lock table
    (tests; a fresh process needs nothing)."""
    global _static_seeded
    with _meta_lock:
        _order.clear()
        _edge_sites.clear()
        _reports.clear()
        _held_by_thread.clear()
        _static_seeded = False


def order_graph():
    """Copy of the current lock-order graph ``{name: set(successors)}``."""
    with _meta_lock:
        return {a: set(bs) for a, bs in _order.items()}


def recorded_reports():
    """Inversion reports collected in report-only mode."""
    with _meta_lock:
        return list(_reports)


def seed_static_order():
    """Fold ``analysis.concurrency``'s static acquisition-order edges
    (over the port's package source) into the runtime graph; returns
    the number of edges folded.  Idempotent; best-effort: the sanitizer
    works from pure observation when the source is unavailable."""
    global _static_seeded, _seeding
    if _static_seeded or _seeding:
        return 0
    _seeding = True
    try:
        from .analysis import concurrency as _conc
        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        edges = _conc.static_order_edges([pkg_dir])
    except (ImportError, OSError, SyntaxError):
        edges = ()
    finally:
        _seeding = False
    n = 0
    with _meta_lock:
        for a, b in edges:
            if a != b:
                _order.setdefault(a, set()).add(b)
                _edge_sites.setdefault((a, b), "static analysis "
                                      "(analysis/concurrency.py)")
                n += 1
        _static_seeded = True
    return n


# -- held-lock bookkeeping ---------------------------------------------

class _Held:
    __slots__ = ("lock", "name", "t0", "site")

    def __init__(self, lock, name, site):
        self.lock = lock
        self.name = name
        self.t0 = time.perf_counter()
        self.site = site


def _held_stack():
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
        with _meta_lock:
            _held_by_thread[_threading.get_ident()] = stack
    return stack


def _acq_site(limit=12):
    """Cheap acquisition-stack capture: raw (file, line, fn) tuples per
    frame -- no FrameSummary, no linecache -- formatted lazily by
    :func:`_format_site` only when a report is actually built.  This
    runs on EVERY sanitized acquisition, so it must stay microseconds."""
    f = sys._getframe(2)
    out = []
    while f is not None and len(out) < limit:
        code = f.f_code
        out.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    return out


def _format_site(site):
    if isinstance(site, str):
        return site
    return "".join('  File "%s", line %d, in %s\n' % t
                   for t in reversed(site))


def _telemetry():
    # late, guarded import: telemetry itself creates locks through this
    # module, so the dependency must stay one-way at import time
    try:
        from . import telemetry
    except ImportError:
        return None
    return telemetry if telemetry._ENABLED else None


def _emit(hook, *args):
    """Guarded telemetry emission: the instruments' own locks are sync
    locks, so an unguarded emit-on-release would recurse forever
    (hold_time's release emitting hold_time...)."""
    if getattr(_tls, "in_hook", False):
        return
    tel = _telemetry()
    if tel is None:
        return
    _tls.in_hook = True
    try:
        getattr(tel.hooks, hook)(*args)
    finally:
        _tls.in_hook = False


def _creation_site():
    f = sys._getframe(2)
    return "%s:%d" % (os.path.basename(f.f_code.co_filename), f.f_lineno)


# -- the order graph ----------------------------------------------------

def _path_exists(src, dst):
    """DFS reachability in _order; caller holds _meta_lock."""
    seen = set()
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(_order.get(node, ()))
    return False


def _cycle_path(src, dst):
    """One path src -> ... -> dst in _order; caller holds _meta_lock."""
    seen = {src}
    path = [src]

    def dfs(node):
        if node == dst:
            return True
        for nxt in sorted(_order.get(node, ())):
            if nxt in seen:
                continue
            seen.add(nxt)
            path.append(nxt)
            if dfs(nxt):
                return True
            path.pop()
        return False

    dfs(src)
    return path


def _record_edge(held, name, acq_site):
    """Add edge held.name -> name; detect and handle inversions."""
    report = None
    with _meta_lock:
        a, b = held.name, name
        if b != a:
            if _path_exists(b, a):
                path = _cycle_path(b, a)
                lines = [
                    "mxnet_tpu_torch.sync: LOCK-ORDER INVERSION",
                    "thread %r acquires %r while holding %r," %
                    (_threading.current_thread().name, b, a),
                    "but the order graph already requires %s -> %s:"
                    % (" -> ".join(path), b),
                ]
                for x, y in zip(path, path[1:] + [b]):
                    site = _edge_sites.get((x, y))
                    if site:
                        lines.append("  edge %s -> %s first observed:\n%s"
                                     % (x, y, _format_site(site)))
                lines.append("holding %r acquired at:\n%s"
                             % (a, _format_site(held.site)))
                lines.append("acquiring %r at:\n%s"
                             % (b, _format_site(acq_site)))
                report = "\n".join(lines)
                _reports.append(report)
            _order.setdefault(a, set()).add(b)
            _edge_sites.setdefault((a, b), acq_site)
    if report is not None:
        _emit("sync_inversion", held.name, name)
        if _RAISE_ON_INVERSION:
            raise LockOrderError(report)


def _all_stacks_report(waiter_name, waited_s):
    """The watchdog dump: every thread's stack + the held-locks table."""
    lines = [
        "mxnet_tpu_torch.sync: DEADLOCK watchdog expired after %.1fs waiting "
        "to acquire %r" % (waited_s, waiter_name),
        "",
        "held locks by thread:",
    ]
    with _meta_lock:
        held_snapshot = {ident: [(h.name, h.site) for h in stack]
                         for ident, stack in _held_by_thread.items()
                         if stack}
    names = {t.ident: t.name for t in _threading.enumerate()}
    for ident, held in sorted(held_snapshot.items()):
        lines.append("  thread %r (%s):"
                     % (names.get(ident, "?"), ident))
        for name, site in held:
            lines.append("    holds %r acquired at:\n%s"
                         % (name, _indent(_format_site(site))))
    if not held_snapshot:
        lines.append("  (none recorded)")
    lines.append("")
    lines.append("all thread stacks:")
    frames = sys._current_frames()
    for ident, frame in frames.items():
        lines.append("  thread %r (%s):" % (names.get(ident, "?"), ident))
        lines.append(_indent("".join(traceback.format_stack(frame,
                                                            limit=16))))
    return "\n".join(lines)


def _indent(text, pad="      "):
    return "\n".join(pad + ln for ln in text.splitlines())


def _watchdog_fire(name, waited_s):
    _emit("sync_watchdog", name)
    return DeadlockError(_all_stacks_report(name, waited_s))


# -- wrappers ----------------------------------------------------------

class _TsanLockBase:
    """Shared acquire/release instrumentation for Lock and RLock."""

    _reentrant = False

    def __init__(self, name=None):
        self.name = name or _creation_site()
        self._inner = self._make_inner()

    def acquire(self, blocking=True, timeout=-1):
        if not _TSAN:                # disabled after creation: passthrough
            return self._inner.acquire(blocking, timeout)
        held = _held_stack()
        reentry = self._reentrant and any(h.lock is self for h in held)
        if not blocking:
            got = self._inner.acquire(False)
            if got and not reentry:
                self._on_acquired(held, 0.0)
            return got
        t0 = time.perf_counter()
        if timeout is not None and timeout >= 0:
            got = self._inner.acquire(True, timeout)
            if got and not reentry:
                self._on_acquired(held, time.perf_counter() - t0)
            return got
        got = self._inner.acquire(True, _WATCHDOG_S)
        waited = time.perf_counter() - t0
        if not got:
            raise _watchdog_fire(self.name, waited)
        if not reentry:
            self._on_acquired(held, waited)
        return True

    def _on_acquired(self, held, waited):
        acq_site = _acq_site()
        if held:
            try:
                _record_edge(held[-1], self.name, acq_site)
            except LockOrderError:
                # the caller never observed a successful acquire
                self._inner.release()
                raise
        if waited > _EMIT_THRESHOLD_S:
            _emit("sync_contention", self.name, waited)
        held.append(_Held(self, self.name, acq_site))

    def release(self):
        if _TSAN:
            held = _held_stack()
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is self:
                    entry = held.pop(i)
                    if not (self._reentrant
                            and any(h.lock is self for h in held)):
                        held_s = time.perf_counter() - entry.t0
                        if held_s > _EMIT_THRESHOLD_S:
                            _emit("sync_hold", self.name, held_s)
                    break
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return "<sync.%s %r>" % (type(self).__name__, self.name)


class _TsanLock(_TsanLockBase):
    _reentrant = False

    @staticmethod
    def _make_inner():
        return _threading.Lock()


class _TsanRLock(_TsanLockBase):
    _reentrant = True

    @staticmethod
    def _make_inner():
        return _threading.RLock()

    def locked(self):                       # RLock has no .locked()
        raise AttributeError("RLock has no locked()")

    def _is_owned(self):                    # Condition integration
        return self._inner._is_owned()


class _TsanCondition:
    """Condition over a sanitized lock: ``with cond:`` goes through the
    wrapper (order graph + watchdog), ``wait()`` temporarily retires
    the lock from the held stack (the condition releases it) and
    watchdog-bounds an untimed wait."""

    def __init__(self, lock=None, name=None):
        if lock is None:
            lock = _TsanLock(name=(name or _creation_site()) + ".lock")
        self._lock = lock
        self.name = name or getattr(lock, "name", None) or _creation_site()
        inner = lock._inner if isinstance(lock, _TsanLockBase) else lock
        self._inner = _threading.Condition(inner)

    def acquire(self, *args, **kwargs):
        return self._lock.acquire(*args, **kwargs)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def _retire_held(self):
        if not (_TSAN and isinstance(self._lock, _TsanLockBase)):
            return None
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self._lock:
                return held.pop(i)
        return None

    def _restore_held(self, entry):
        if entry is not None:
            entry.t0 = time.perf_counter()
            _held_stack().append(entry)

    def wait(self, timeout=None):
        entry = self._retire_held()
        try:
            if timeout is not None or not _TSAN:
                return self._inner.wait(timeout)
            t0 = time.perf_counter()
            got = self._inner.wait(_WATCHDOG_S)
            if not got:
                raise _watchdog_fire(self.name,
                                     time.perf_counter() - t0)
            return got
        finally:
            self._restore_held(entry)

    def wait_for(self, predicate, timeout=None):
        # mirrors threading.Condition.wait_for, through our wait()
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def __repr__(self):
        return "<sync.Condition %r>" % self.name


class _TsanEvent:
    """Event whose *untimed* wait is watchdog-bounded: a flag nobody
    ever sets is the single-threaded spelling of a deadlock."""

    def __init__(self, name=None):
        self.name = name or _creation_site()
        self._inner = _threading.Event()

    def is_set(self):
        return self._inner.is_set()

    def set(self):
        self._inner.set()

    def clear(self):
        self._inner.clear()

    def wait(self, timeout=None):
        if timeout is not None or not _TSAN:
            return self._inner.wait(timeout)
        t0 = time.perf_counter()
        got = self._inner.wait(_WATCHDOG_S)
        if not got:
            raise _watchdog_fire(self.name, time.perf_counter() - t0)
        return got

    def __repr__(self):
        return "<sync.Event %r>" % self.name


# -- factories ---------------------------------------------------------
# Flag off: the raw threading primitive, so the sanitized build and the
# production build differ by ONE branch per primitive *creation* and
# nothing per acquisition.

def Lock(name=None):
    """A mutex; sanitized under ``MXNET_TPU_TSAN=1``, raw otherwise."""
    return _TsanLock(name) if _TSAN else _threading.Lock()


def RLock(name=None):
    """A reentrant mutex; reacquisition by the owner adds no edges."""
    return _TsanRLock(name) if _TSAN else _threading.RLock()


def Condition(lock=None, name=None):
    """A condition variable; pass a :func:`Lock` result to share it."""
    if not _TSAN:
        return (_threading.Condition(lock)
                if not isinstance(lock, _TsanLockBase)
                else _threading.Condition(lock._inner))
    return _TsanCondition(lock, name=name)


def Event(name=None):
    """An event; its untimed ``wait()`` is watchdog-bounded under TSAN."""
    return _TsanEvent(name) if _TSAN else _threading.Event()
