"""Ops plane for the always-on loop (counterpart of ``mxnet_tpu/obs``):
request and step tracing, and the process status board.

``telemetry`` (counters/histograms) says *how much*; ``obs`` says
*which one and why*:

- **tracing** (``obs.trace``): context-propagated trace/span IDs
  threaded through the serving path (submit -> queue wait -> batch
  assembly -> dispatch -> device_get -> respond, batcher fan-in
  recorded as span links) and the training loop (step -> publish ->
  checkpoint commit -> watcher discover -> warm -> install), exported
  as Chrome-trace JSON and streamed into the telemetry JSONL;
- **status board** (``obs.status``): readiness (``health()``) and the
  operator snapshot (``statusz()``) off the registered watchers,
  registries and trainers.

Tracing is gated exactly like telemetry: disabled (the default), every
instrumented site pays ONE module-flag check (``obs._TRACE_ENABLED``)
and makes zero calls into ``obs.trace``.  Enable with
``MXNET_TPU_OBS_TRACE=1`` or ``obs.enable_tracing()``.

The JAX package's flight recorder, HTTP server, goodput ledger, alerts
and fleet plane come with the rest of the ops plane (ROADMAP item 8).
"""
from __future__ import annotations

import os

from . import status, trace
from .trace import (TraceContext, begin_span, current, end_span,
                    export_chrome_trace, record_span, span, spans)
from .trace import trace as start_trace

__all__ = [
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "start_trace", "span", "begin_span", "end_span", "record_span",
    "current", "spans", "export_chrome_trace", "TraceContext", "status",
]

# THE flag every traced hot path checks (one module-attribute read).
# Mutate only through enable_tracing()/disable_tracing().
_TRACE_ENABLED = False


def enable_tracing():
    """Arm the trace hooks (idempotent)."""
    global _TRACE_ENABLED
    _TRACE_ENABLED = True


def disable_tracing():
    """Disarm the trace hooks; recorded spans are kept."""
    global _TRACE_ENABLED
    _TRACE_ENABLED = False


def tracing_enabled():
    return _TRACE_ENABLED


# env arming (the package's != "0" convention)
if os.environ.get("MXNET_TPU_OBS_TRACE", "0") != "0":
    enable_tracing()
