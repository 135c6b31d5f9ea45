"""Retrace auditor: flag op params that would be frozen into a capture
(counterpart of ``mxnet_tpu/analysis/retrace.py``).

The port compiles nothing eagerly: an ``mx.nd`` call runs its op at
once, whatever its params.  Its caches are captures, and op params sit
in them as the JAX package's sit in its compile caches:

- ``TrainStep`` captures one graph per key and feeds the per-step
  scalars of the update from a device tensor refreshed before each
  replay (``parallel/data_parallel.py :: _DYNAMIC_PARAMS``): a new
  learning rate, weight decay, rescale or update count reaches the
  next replay with no new capture;
- the **hybridize** cache (``gluon/block.py :: _CACHE_KEY_STATIC``)
  keys on ``(training, amp-policy, shapes, dtypes, device)`` only; an
  op param inside the block is a Python value frozen into the captured
  graph.

On the H100 the hazard is therefore a capture, not a compile: an op
param whose name marks it as per-step-varying (a schedule, a step
counter, a loss scale) that no device tensor feeds is either frozen at
its capture-time value in every replay, or -- keyed on -- one graph
captured per value.

Rules:

- ``retrace-hazard``  (warning) varying-named op param outside the
  device-fed set
- ``cache-key-drift`` (warning) the cache-key anchors this audit reads
  (``_CACHE_KEY_STATIC``, ``_DYNAMIC_PARAMS``) are gone or no longer
  cover what the audit assumes -- the engine changed; update the audit
"""
from __future__ import annotations

from typing import List

from .core import Diagnostic, WARNING, rule

__all__ = ["audit_retrace", "cache_key_fields", "eager_dynamic_params",
           "VARYING_PARAM_NAMES"]

# Param names that, by convention in the op table, carry per-step values
# (optimizer schedules, step counters, loss scaling).  Constant
# hyperparameters (``clip_gradient``) and shape-like params (``step``
# strides) are deliberately excluded.  The JAX package's set.
VARYING_PARAM_NAMES = {
    "lr", "wd", "rescale_grad", "scalar", "t", "loss_scale", "num_update",
}


def eager_dynamic_params() -> frozenset:
    """The op param names whose per-step value reaches a captured step
    without a new capture (``TrainStep``'s device-fed scalars)."""
    from ..parallel import data_parallel
    return getattr(data_parallel, "_DYNAMIC_PARAMS", frozenset())


def cache_key_fields() -> List[str]:
    """Static fields of the hybridize cache key, from ``gluon/block.py``
    (empty list if the anchor is gone)."""
    from ..gluon import block as block_mod
    return list(getattr(block_mod, "_CACHE_KEY_STATIC", ()))


@rule("retrace-hazard", "registry",
      "An op param carries a per-step-varying value that no device "
      "tensor feeds: inside a captured scope its capture-time value is "
      "frozen into every replay (or each distinct value captures a "
      "graph of its own).", severity=WARNING)
def _audit_varying_params(ctx):
    from ..ops import table
    dynamic = eager_dynamic_params()
    seen = set()
    for _, op in sorted(table.TABLE.items()):
        if id(op) in seen:           # aliases share the OpSpec
            continue
        seen.add(id(op))
        hazards = [p for p in op.params
                   if p in VARYING_PARAM_NAMES and p not in dynamic]
        if hazards:
            yield Diagnostic(
                "retrace-hazard",
                "op %r params %r vary per step but no device tensor "
                "feeds them (TrainStep's _DYNAMIC_PARAMS; the hybridize "
                "key %s holds no op param): a captured graph freezes "
                "their value -- feed them from the step's scalars tensor "
                "or pass them as tensor inputs"
                % (op.name, hazards, cache_key_fields()),
                node=op.name, severity=WARNING)


@rule("cache-key-drift", "registry",
      "The capture-key anchors this audit reads no longer match what "
      "it expects; update the audit with the engine.",
      severity=WARNING)
def _audit_cache_key(ctx):
    fields = cache_key_fields()
    expected = {"training", "shape", "dtype", "device"}
    missing = expected - set(fields)
    if not fields or missing:
        yield Diagnostic(
            "cache-key-drift",
            "could not confirm hybridize cache-key fields %s in "
            "gluon/block.py (found %s); the retrace audit may be stale"
            % (sorted(expected), sorted(set(fields))),
            severity=WARNING)
    if not eager_dynamic_params():
        yield Diagnostic(
            "cache-key-drift",
            "parallel.data_parallel._DYNAMIC_PARAMS is missing or empty; "
            "TrainStep no longer feeds per-step params from the device "
            "and the retrace audit may be stale", severity=WARNING)


def audit_retrace() -> List[Diagnostic]:
    """Run every registry-kind rule; imports the op modules first so
    the table is fully populated."""
    from .. import ops  # noqa: F401  (populates the op table)
    from .core import RULES
    diags: List[Diagnostic] = []
    for r in RULES.values():
        if r.kind != "registry":
            continue
        for d in r.check(None):
            d.severity = r.severity
            diags.append(d)
    return diags
