"""Profiler (counterpart of ``mxnet_tpu/profiler.py``; reference:
``python/mxnet/profiler.py`` over ``src/profiler/profiler.cc``).

The heavy lifting is ``torch.profiler``: the host's ops and the card's
kernels, copies and memory events (CUPTI), kernels replayed from a
CUDA graph included, in one trace.  This module supplies the
reference's control surface (``set_config / set_state / start / stop /
dump / dumps``) plus named scopes that the hybridize cache
(``mx.cachedop:<Block>``) and user code enter, so framework-level
structure shows up in the trace as ``record_function`` ranges.

- :func:`dump` writes the trace as Chrome trace-event JSON to
  ``set_config(filename=...)`` and returns its path;
- :func:`dumps` is the JAX package's aggregate table over the
  ``mx.profiling`` CostReports (one row per report: step count and host
  wall, FLOPs, bytes, peak memory), followed, when a trace was
  recorded, by the card's kernels by device time.
"""
from __future__ import annotations

import contextlib
import os

from .base import MXNetError

__all__ = ["set_config", "set_state", "start", "stop", "pause", "resume",
           "dump", "dumps", "state", "scope", "Profiler", "Domain",
           "Task", "Frame", "Event", "Counter", "reset", "marker",
           "kernel_rows"]

_config = {
    "filename": "profile.json",   # the Chrome trace dump() writes
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": True,
    "profile_api": True,
    "aggregate_stats": False,
}
_state = "stop"
_prof = None            # the running or last torch.profiler.profile
_scopes_enabled = False


def set_config(**kwargs):
    """Reference: ``profiler.set_config``.  ``filename`` is the Chrome
    trace :func:`dump` writes."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError("profiler.set_config: unknown options %r"
                         % sorted(unknown))
    _config.update(kwargs)


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def set_state(state="stop", profile_process="worker"):
    """Reference: ``profiler.set_state('run'|'stop')``: starts or stops
    a ``torch.profiler`` trace of the host and, where there is one, the
    card."""
    global _state, _prof, _scopes_enabled
    if state not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    if state == "run" and _state == "stop":
        import torch
        prof = torch.profiler.profile(
            activities=_activities(),
            profile_memory=bool(_config["profile_memory"]),
            record_shapes=bool(_config["profile_all"]))
        prof.start()
        _prof = prof
        _scopes_enabled = True
        _state = "run"
    elif state == "stop" and _state == "run":
        _prof.stop()
        _scopes_enabled = False
        _state = "stop"


def start(profile_process="worker"):
    """Reference: ``profiler.start``."""
    set_state("run", profile_process)


def stop(profile_process="worker"):
    """Reference: ``profiler.stop``."""
    set_state("stop", profile_process)


def pause(profile_process="worker"):
    """Scopes off; the trace keeps running (closest analog)."""
    global _scopes_enabled
    _scopes_enabled = False


def resume(profile_process="worker"):
    global _scopes_enabled
    if _state == "run":
        _scopes_enabled = True


def dump(finished=True, profile_process="worker"):
    """Reference: ``profiler.dump`` -- finish the trace (when
    ``finished``) and write it as Chrome trace-event JSON to the
    configured filename; returns the path (None before any trace)."""
    if _state == "run" and finished:
        stop()
    if _prof is None or _state == "run":
        return None
    path = os.path.abspath(_config["filename"])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _prof.export_chrome_trace(path)
    return path


_DUMPS_SORT_KEYS = ("total", "avg", "min", "max", "count", "flops",
                    "bytes", "peak_hbm")


def _device_time_us(evt):
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_rows(limit=None):
    """The card's kernels of the last finished trace, by device time:
    ``[{"name", "count", "device_ms"}]`` (empty without a trace or a
    card)."""
    if _prof is None or _state == "run":
        return []
    rows = []
    for evt in _prof.key_averages():
        us = _device_time_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and str(evt.device_type).endswith("CUDA"):
            rows.append({"name": evt.key, "count": int(evt.count),
                         "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:limit] if limit else rows


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Reference: ``profiler.dumps`` (aggregate stats): one row per
    ``mx.profiling`` CostReport -- step count/total/avg (host wall),
    FLOPs, bytes, peak memory -- the JAX package's table, column for
    column; then, in the table format and when a trace was recorded,
    the card's kernels by device time.

    ``sort_by`` follows the reference's keys (``total``/``avg``/
    ``min``/``max``/``count`` over step time) plus cost-side keys
    (``flops``/``bytes``/``peak_hbm``); ``format`` is ``table`` or
    ``json``; ``reset=True`` clears the store after rendering."""
    if sort_by not in _DUMPS_SORT_KEYS:
        raise MXNetError("profiler.dumps: sort_by must be one of %s"
                         % (_DUMPS_SORT_KEYS,))
    if format not in ("table", "json"):
        raise MXNetError("profiler.dumps: format must be 'table' or "
                         "'json'")
    from . import profiling
    rows = []
    for rep in profiling.reports():
        st = rep.get("step") or {}
        count = st.get("count", 0)
        total = st.get("total_s", 0.0) or 0.0
        rows.append({
            "name": rep["label"],
            "count": count,
            "total": total,
            "avg": (total / count) if count else 0.0,
            "min": st.get("min_s") or 0.0,
            "max": st.get("max_s") or 0.0,
            "flops": rep["totals"]["flops"],
            "bytes": rep["totals"]["bytes_accessed"],
            "peak_hbm": rep["memory"]["peak_hbm_bytes"],
        })
    rows.sort(key=lambda r: r[sort_by], reverse=not ascending)
    if reset:
        profiling.reset()
    if format == "json":
        import json
        return json.dumps(rows, indent=1, sort_keys=True)
    lines = ["Profile Statistics (mx.profiling cost reports):",
             "%-36s %8s %12s %12s %14s %14s %12s"
             % ("Name", "Count", "Total(ms)", "Avg(ms)", "FLOPs",
                "Bytes", "PeakHBM")]
    for r in rows:
        lines.append("%-36s %8d %12.3f %12.3f %14.3g %14.3g %12d"
                     % (r["name"][:36], r["count"], 1e3 * r["total"],
                        1e3 * r["avg"], r["flops"], r["bytes"],
                        r["peak_hbm"]))
    if not rows:
        lines.append("(no cost reports captured; enable with "
                     "MXNET_TPU_PROFILING=1 / mx.profiling.enable())")
    kernels = kernel_rows(limit=20)
    if kernels:
        lines.append("")
        lines.append("Device kernels (torch.profiler, by device time):")
        lines.append("%-60s %8s %12s" % ("Kernel", "Count", "Device(ms)"))
        for k in kernels:
            lines.append("%-60s %8d %12.3f" % (k["name"][:60], k["count"],
                                               k["device_ms"]))
    return "\n".join(lines)


def state():
    return _state


@contextlib.contextmanager
def scope(name):
    """Named region: a ``record_function`` range in the trace while the
    profiler runs and, with ``mx.profiling`` enabled, a span on the step
    timeline."""
    from . import profiling as _profiling
    if not _scopes_enabled and not _profiling._ENABLED:
        yield
        return
    with contextlib.ExitStack() as stack:
        if _scopes_enabled:
            import torch
            stack.enter_context(torch.profiler.record_function(name))
        if _profiling._ENABLED:
            from .profiling import timeline
            stack.enter_context(timeline.span(name))
        yield


class Profiler:
    """Context manager sugar: ``with mx.profiler.Profiler(filename=...):``"""

    def __init__(self, **config):
        if config:
            set_config(**config)

    def __enter__(self):
        start()
        return self

    def __exit__(self, *exc):
        stop()


class Domain:
    """Reference: ``profiler.Domain`` -- a named grouping for custom
    objects."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name


def _region_name(a, b):
    """Reference calling conventions: ``Task(domain, name)`` /
    ``Frame(domain, name)`` take the Domain first; ``Event(name)`` takes
    just a name.  Accept both orders."""
    if b is None:
        return str(a)
    return "%s::%s" % (a, b) if isinstance(a, Domain) else str(b)


class _NamedRegion:
    """Base for the reference's custom profiler objects (``Task``,
    ``Frame``, ``Event``): start/stop (or ``with``) brackets a named
    range in the trace."""

    def __init__(self, domain_or_name, name=None):
        self.name = _region_name(domain_or_name, name)
        self._cm = None

    def start(self):
        if _scopes_enabled:
            import torch
            self._cm = torch.profiler.record_function(self.name)
            self._cm.__enter__()

    def stop(self):
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_NamedRegion):
    """Reference: ``profiler.Task``."""


class Frame(_NamedRegion):
    """Reference: ``profiler.Frame``."""


class Event(_NamedRegion):
    """Reference: ``profiler.Event``."""


# profiler counters live in the telemetry registry under this prefix,
# so they show up in telemetry sinks/snapshots and ``profiler.reset()``
# can clear exactly them
_COUNTER_PREFIX = "profiler."


class Counter:
    """Named counter (reference: ``profiler.Counter(domain, name,
    value)``).  Re-constructing an existing name attaches to it without
    resetting (reference semantics); backed by the ``mx.telemetry``
    registry, so it shows in every telemetry sink and
    :func:`reset` zeroes it."""

    def __init__(self, domain_or_name, name=None, value=None):
        from . import telemetry
        self.name = _region_name(domain_or_name, name)
        self._counter = telemetry.counter(_COUNTER_PREFIX + self.name)
        if value is not None:
            self._counter.set(value)

    def set_value(self, value):
        self._counter.set(value)

    def increment(self, delta=1):
        self._counter.inc(delta)

    def decrement(self, delta=1):
        self._counter.dec(delta)

    @property
    def value(self):
        return self._counter.value


def reset():
    """Zero every ``profiler.Counter``."""
    from . import telemetry
    telemetry.reset(prefix=_COUNTER_PREFIX)


def marker(name, scope="process"):
    """Instant event (reference: ``profiler.Marker``/``set_marker``):
    recorded as a zero-length range."""
    if _scopes_enabled:
        import torch
        with torch.profiler.record_function("marker:" + name):
            pass


# reference env: start profiling at import when requested; the trace
# only reaches disk through dump(), so stop at interpreter exit
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") != "0":
    import atexit
    set_state("run")
    atexit.register(stop)
