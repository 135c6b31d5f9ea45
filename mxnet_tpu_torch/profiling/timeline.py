"""Always-available step timeline -> Chrome-trace JSON (counterpart
of ``mxnet_tpu/profiling/timeline.py``).

``mx.profiler`` records the card's own trace through ``torch.profiler``.
This is the lightweight complement: host-side spans (train steps,
``Trainer.step``, feed staging, user ``profiler.scope`` regions) and
instant events (markers) in a bounded in-memory ring, exported as
Chrome trace-event JSON that loads straight into ``chrome://tracing``
or Perfetto -- no device hooks, cheap enough to leave on for a whole
run.

Recording only happens while ``mx.profiling`` is enabled; every hook
site is guarded by the module flag, so the off cost is one check.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from .. import sync as _sync

# bounded ring: a multi-hour run cannot grow host memory unboundedly
_MAX_EVENTS = 100_000

_lock = _sync.Lock(name="profiling.timeline")
_events = []
_dropped = 0
# timeline epoch = the perf_counter clock's own zero, so spans timed
# before this module's (lazy) import still land at positive offsets
_t0 = 0.0


def _ts():
    """Microseconds on the perf_counter clock (chrome trace 'ts')."""
    return (time.perf_counter() - _t0) * 1e6


def record(name, t_start, duration_s, args=None):
    """Record one complete span (begin ``t_start`` seconds on the
    perf_counter clock, lasting ``duration_s``)."""
    global _dropped
    ev = {"name": name, "ph": "X",
          "ts": (t_start - _t0) * 1e6,
          "dur": duration_s * 1e6,
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            del _events[:_MAX_EVENTS // 10]
            _dropped += _MAX_EVENTS // 10
        _events.append(ev)


def instant(name, args=None):
    """Record an instant event (chrome 'i' phase)."""
    global _dropped
    ev = {"name": name, "ph": "i", "ts": _ts(), "s": "t",
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            del _events[:_MAX_EVENTS // 10]
            _dropped += _MAX_EVENTS // 10
        _events.append(ev)


@contextlib.contextmanager
def span(name, **args):
    """``with timeline.span("phase"): ...`` -- records on exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, t0, time.perf_counter() - t0, args or None)


def events():
    with _lock:
        return list(_events)


def dropped():
    return _dropped


def clear():
    global _dropped
    with _lock:
        del _events[:]
        _dropped = 0


def export_chrome_trace(path=None):
    """Chrome trace-event JSON of everything recorded.  Written to
    ``path`` when given; the dict is returned either way."""
    with _lock:
        evs = list(_events)
        ndropped = _dropped
    trace = {"traceEvents": evs, "displayTimeUnit": "ms",
             "otherData": {"producer": "mxnet_tpu_torch.profiling.timeline",
                           "dropped_events": ndropped}}
    if path:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
