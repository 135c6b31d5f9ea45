"""Ops plane (counterpart of ``mxnet_tpu/obs``): request and step
tracing, the process status board, the goodput ledger, the crash-safe
flight recorder and the introspection HTTP server.

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
  registries, trainers, goodput ledgers and supervisors;
- **goodput ledger** (``obs.goodput``): per-window step-time
  attribution, a rolling MFU gauge and a regression sentinel, ticked by
  the ContinuousTrainer loop (``MXNET_TPU_OBS_GOODPUT=1`` /
  :func:`enable_goodput`);
- **flight recorder** (``obs.flight``): an mmap'd ring of the newest
  telemetry records that survives the process's death
  (:func:`install_blackbox`, ``MXNET_TPU_OBS_BLACKBOX``);
- **introspection server** (``obs.server``): ``/healthz``,
  ``/metrics``, ``/statusz`` and ``/alertz`` over HTTP (:func:`serve`,
  ``MXNET_TPU_OBS_PORT``), publishing its endpoint file for discovery
  (``obs.fleet``).

Tracing is gated exactly like telemetry: disabled (the default), every
instrumented site pays ONE module-flag check (``obs._TRACE_ENABLED``)
and makes zero calls into ``obs.trace``.  Enable with
``MXNET_TPU_OBS_TRACE=1`` or ``obs.enable_tracing()``.

The fleet plane polls several processes' servers: :mod:`.fleet`
(endpoint discovery, the scrape client, ``FleetMonitor`` and its
aggregates) and :mod:`.alerts` (the SLO alert engine ``/alertz``
serves).
"""
from __future__ import annotations

import os

from . import flight, goodput, status, trace
from .trace import (TraceContext, begin_span, current, end_span,
                    export_chrome_trace, record_span, span, spans)
from .trace import trace as start_trace

__all__ = [
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "enable_goodput", "disable_goodput", "goodput_enabled",
    "start_trace", "span", "begin_span", "end_span", "record_span",
    "current", "spans", "export_chrome_trace", "TraceContext",
    "flight", "goodput", "status", "server", "serve",
    "install_blackbox", "fleet",
]

# THE flag every traced hot path checks (one module-attribute read).
# Mutate only through enable_tracing()/disable_tracing().
_TRACE_ENABLED = False

# THE flag the goodput-ledger hook sites check (ContinuousTrainer's
# step/publish loop); same zero-overhead contract as _TRACE_ENABLED.
_GOODPUT_ENABLED = False


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


def enable_goodput():
    """Arm the goodput-ledger loop hooks (idempotent; the ledger reads
    telemetry instruments, so enable telemetry too for non-empty
    category attribution)."""
    global _GOODPUT_ENABLED
    _GOODPUT_ENABLED = True


def disable_goodput():
    """Disarm the goodput hooks; recorded windows are kept."""
    global _GOODPUT_ENABLED
    _GOODPUT_ENABLED = False


def goodput_enabled():
    return _GOODPUT_ENABLED


def install_blackbox(path=None, capacity=None):
    """Install the process flight recorder (see ``obs.flight``)."""
    return flight.install(path, capacity=capacity)


def serve(port=None):
    """Start the introspection HTTP server (see ``obs.server``)."""
    return server.serve(port)


from . import fleet, server  # noqa: E402  (the handler imports status)

# env arming (the package's != "0" convention)
if os.environ.get("MXNET_TPU_OBS_TRACE", "0") != "0":
    enable_tracing()
if os.environ.get("MXNET_TPU_OBS_GOODPUT", "0") != "0":
    enable_goodput()
_env_blackbox = os.environ.get("MXNET_TPU_OBS_BLACKBOX", "")
if _env_blackbox:
    flight.install(_env_blackbox)
_env_port = os.environ.get("MXNET_TPU_OBS_PORT", "")
if _env_port and _env_port != "0":
    server.serve(int(_env_port))
