"""Step cost accounting (counterpart of ``mxnet_tpu/profiling``).

``mx.telemetry`` counts host-side events; ``mx.profiler`` records the
card's trace through ``torch.profiler``.  Neither says which ops eat
the card.  This subsystem is the cost layer:

- Each shape-keyed program the port runs -- a ``parallel.TrainStep``
  key, a hybridized block's key -- is walked op by op during its eager
  warm-up (:mod:`.aten`, the counterpart of the JAX package's HLO
  parser) into a :class:`CostReport` (:mod:`.cost`): FLOPs and bytes
  totals, a per-category breakdown (conv/dot, collective,
  transpose-layout, elementwise/fusion, other) that sums exactly to the
  totals, the hand kernels at their cost functions, argument/output and
  peak memory, and a fingerprint of the op sequence.
- An analytic roofline (:mod:`.roofline`) turns a measured step time
  and a CostReport into achieved-vs-peak compute and bandwidth per
  category against the H100's data-sheet peaks.
- A lightweight always-available step timeline (:mod:`.timeline`)
  exports host spans as Chrome-trace JSON.
- The ``mxprof`` CLI (``python -m mxnet_tpu_torch.profiling report`` /
  ``diff``) renders report artifacts and names the categories whose
  FLOPs/bytes/peak memory drifted between two runs; it reads the JAX
  package's artifacts too, and the JAX package's reads the port's.

Enable with ``MXNET_TPU_PROFILING=1`` or ``mx.profiling.enable()``.
Disabled (the default), every hook is one module-flag check.  With
``MXNET_TPU_PROFILING_DIR`` set, reports are persisted there at exit
(and by ``save_reports()``).
"""
from __future__ import annotations

import os
import time

__all__ = [
    "enable", "disable", "enabled", "reset",
    "capture_jit", "record_step", "reports", "combined_report",
    "save_reports", "report_for", "report_dir", "flops_per_step",
    "CATEGORIES",
]

# Hot-path gate: instrumented modules check this one module attribute
# (same contract as telemetry._ENABLED) and make zero calls when off.
_ENABLED = False

# cost categories (the JAX package's); kept literal here so importing
# the gate stays stdlib-only
CATEGORIES = ("conv_dot", "collective", "transpose_layout",
              "elementwise_fusion", "other")

_atexit_armed = False


def enable():
    """Turn the capture hooks on (idempotent)."""
    global _ENABLED
    _ENABLED = True
    _arm_atexit()


def disable():
    """Turn the capture hooks off; captured reports are kept."""
    global _ENABLED
    _ENABLED = False


def enabled():
    return _ENABLED


def report_dir():
    """Report directory from ``MXNET_TPU_PROFILING_DIR`` (empty string
    when unset -- callers pass an explicit dir then)."""
    return os.environ.get("MXNET_TPU_PROFILING_DIR", "")


def _arm_atexit():
    """With a report dir configured, persist everything captured when
    the process exits."""
    global _atexit_armed
    if _atexit_armed or not report_dir():
        return
    import atexit

    def _flush():
        if _ENABLED:
            save_reports()
    atexit.register(_flush)
    _atexit_armed = True


# -- capture surface (called by the instrumented paths) -----------------

def _tensor_bytes(obj):
    from .aten import _tensors
    return sum(t.numel() * t.element_size() for t in _tensors(obj, []))


def _device_of(obj):
    from .aten import _tensors
    for t in _tensors(obj, []):
        return t.device
    return None


def _donatable_bytes(arguments, out, written):
    """Bytes of the argument tensors a step could hand its results in:
    those it writes in place (``written``, aliased by construction),
    plus those not written whose (shape, dtype) matches an output's --
    the JAX package's donatable arguments."""
    import torch
    from .aten import _tensors
    remaining = {}
    for o in _tensors(out, []):
        k = (tuple(o.shape), o.dtype)
        remaining[k] = remaining.get(k, 0) + 1
    total, seen = written, set()
    for t in _tensors(arguments, []):
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        k = (tuple(t.shape), t.dtype)
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            total += t.numel() * t.element_size()
    return total


def capture_jit(label, fn, args=(), key=None, kind="jit",
                arguments=None, owner=None, device=None, **meta):
    """``fn(*args)``, walked into a CostReport stored under ``key``
    (default ``(label,)``), once per key: a key already reported runs
    ``fn`` unwalked.  ``arguments`` are the program's argument tensors
    (parameters, optimizer state, the batch; default ``args``), whose
    bytes are the report's argument bytes, and those the run writes in
    place its alias bytes; ``owner`` the graph owner whose pool the
    key's capture will take.  On the card the warm-up's peak allocation
    is the report's peak.  The walk's audit counters are stored beside
    the report (:func:`.store.audit_counters`).  Returns ``fn``'s
    result."""
    from . import aten, cost, store
    from .aten import _tensors
    key = key if key is not None else (label,)
    if store.has(key):
        return fn(*args)
    arguments = args if arguments is None else arguments
    device = device if device is not None else (
        _device_of(arguments) or _device_of(args))
    import torch
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with aten.Walk() as walk:
        out = fn(*args)
    peak = None
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    written = walk.written_bytes(_tensors(arguments, []))
    rep = cost.analyze_walk(walk, label=label, kind=kind,
                            device=device if device is not None else "cpu",
                            argument_bytes=_tensor_bytes(arguments),
                            output_bytes=_tensor_bytes(out),
                            peak_bytes=peak, alias_bytes=written, **meta)
    counters = walk.audit_counters()
    counters["donatable_bytes"] = _donatable_bytes(arguments, out, written)
    dt = time.perf_counter() - t0
    if store.register(key, rep, owner=owner, audit=counters):
        from .. import telemetry as _telemetry
        if _telemetry._ENABLED:
            _telemetry.hooks.profiling_capture(
                label, dt, flops=rep["totals"]["flops"])
    return out


def record_step(label, seconds, items=None):
    """Record one measured step wall time for ``label`` (feeds the
    roofline's achieved-vs-peak numbers)."""
    from . import store
    store.record_step(label, seconds, items=items)


def reports():
    """Every CostReport (step stats + roofline attached where
    known)."""
    from . import store
    return store.reports()


def combined_report():
    """One combined report dict (steps + executables + category
    rollup) -- the artifact ``mxprof report``/``diff`` consume."""
    from . import store
    return store.combined()


def flops_per_step(label=None):
    """FLOPs of one dispatch of the labeled report (default: the first
    train_step) -- the goodput ledger's window-flops source.  None when
    nothing matches."""
    from . import store
    return store.flops_per_step(label)


def save_reports(dirpath=None):
    """Write per-report ``*.cost.json`` files plus the combined
    ``report.json`` under ``dirpath`` (default: the env report dir).
    Returns the combined report path."""
    from . import store
    return store.save(dirpath)


def reset():
    """Drop captured reports, step times and timeline events (test
    isolation)."""
    from . import store, timeline
    store.clear()
    timeline.clear()


def report_for(obj, label=None, step_time_s=None, items_per_step=None):
    """CostReport of a ``parallel.TrainStep``'s last dispatched key
    (walked then if it was not yet; see ``TrainStep.cost_report``), with
    the step and roofline sections at ``step_time_s`` when given.
    Returns None when nothing was dispatched yet."""
    from . import roofline
    rep = obj.cost_report(label=label)
    if rep is not None and step_time_s:
        rep = dict(rep)
        rep["step"] = {"count": 1, "mean_s": step_time_s,
                       "min_s": step_time_s, "max_s": step_time_s,
                       "total_s": step_time_s}
        rep["roofline"] = roofline.build(rep, step_time_s,
                                         items_per_step=items_per_step)
    return rep


# env arming (read directly, matching the package's != "0" convention;
# the typed registry view lives in mxnet_tpu_torch/env.py)
# MXNET_TPU_SHARD_CHECK rides the same capture surface: the sharding
# sanitizer's collective contract (analysis/sharding.py) reads the
# walked steps from this store, so arming it arms the walk
if os.environ.get("MXNET_TPU_PROFILING", "0") != "0" or \
        os.environ.get("MXNET_TPU_SHARD_CHECK", "0") != "0":
    enable()
