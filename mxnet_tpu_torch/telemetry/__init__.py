"""Always-on runtime telemetry (counterpart of
``mxnet_tpu/telemetry``).

Typed Counters/Gauges/Timers/Events over the port's hot paths (the
serving and decode tiers, checkpoints, the always-on loop, the trainer,
AMP, the numerics sentinel, chaos, preemption and the sync layer),
cheap enough to leave enabled for a whole run and queryable as data.

Enable with ``MXNET_TPU_TELEMETRY=1`` in the environment or
``telemetry.enable()`` in code.  When disabled (the default), every
instrumented hot path pays exactly ONE module-attribute flag check
(``telemetry._ENABLED``) and makes zero instrument calls.

Sinks: a JSONL run log (``MXNET_TPU_TELEMETRY_JSONL=/path`` or
``attach_jsonl(path)``), Prometheus text exposition (``prom_dump()``),
and a console summary table (``summary()``).  The JAX package's offline
CLI (``python -m mxnet_tpu.telemetry``) is not ported yet.
"""
from __future__ import annotations

import atexit
import os

from .core import Counter, Event, Gauge, Registry, Timer
from .sinks import JsonlSink, prom_text, summary_table

__all__ = [
    "enable", "disable", "enabled", "reset", "flush", "snapshot",
    "counter", "gauge", "timer", "event", "registry",
    "attach_jsonl", "prom_dump", "summary",
    "Counter", "Gauge", "Timer", "Event", "Registry", "JsonlSink",
]

# THE flag every hot-path hook checks (one module-attribute read).
# Mutate only through enable()/disable().
_ENABLED = False

_registry = Registry()
_jsonl_sink = None
_atexit_armed = False

from . import hooks  # noqa: E402  (needs _registry defined above)


def enable():
    """Turn the hot-path hooks on (idempotent)."""
    global _ENABLED
    _ENABLED = True


def disable():
    """Turn the hot-path hooks off; instruments keep their values."""
    global _ENABLED
    _ENABLED = False


def enabled():
    return _ENABLED


def registry() -> Registry:
    return _registry


def counter(name) -> Counter:
    return _registry.counter(name)


def gauge(name) -> Gauge:
    return _registry.gauge(name)


def timer(name) -> Timer:
    return _registry.timer(name)


def event(name) -> Event:
    return _registry.event(name)


def reset(prefix=None):
    """Zero all instruments (or only names under ``prefix``)."""
    _registry.reset(prefix)


def snapshot():
    """The registry's snapshot: one dict per instrument, by name."""
    return _registry.snapshot()


def flush():
    """Append the aggregate snapshot to attached sinks and flush them."""
    _registry.flush()


def attach_jsonl(path):
    """Attach (or replace) the JSONL run-log sink; returns the sink.
    The snapshot is flushed to it at interpreter exit."""
    global _jsonl_sink, _atexit_armed
    if _jsonl_sink is not None:
        _registry.detach(_jsonl_sink)
        _jsonl_sink.close()
    _jsonl_sink = _registry.attach(JsonlSink(path))
    if not _atexit_armed:
        atexit.register(_atexit_flush)
        _atexit_armed = True
    return _jsonl_sink


def _atexit_flush():
    if _jsonl_sink is not None:
        try:
            _registry.flush()
        except Exception:
            pass


def prom_dump(path=None):
    """Prometheus text exposition of the current snapshot; written to
    ``path`` when given, returned either way."""
    text = prom_text(_registry.snapshot())
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def summary():
    """Human console summary table of the current snapshot."""
    return summary_table(_registry.snapshot())


# env arming (read directly, matching the package's != "0" convention;
# the typed registry view lives in env.py)
if os.environ.get("MXNET_TPU_TELEMETRY", "0") != "0":
    enable()
_env_jsonl = os.environ.get("MXNET_TPU_TELEMETRY_JSONL", "")
if _env_jsonl:
    attach_jsonl(_env_jsonl)
