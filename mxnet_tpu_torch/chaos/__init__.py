"""Chaos harness: deterministic fault injection for the always-on loop
(counterpart of ``mxnet_tpu/chaos``).

Every robustness mechanism in the tree -- atomic checkpoint commits
with corruption-tolerant discovery, the draining hot-swap registry,
async-write retries, preemption saves, batcher load-shedding -- existed
without anything ever *injecting* the fault it guards against.  This
package is the weather machine:

- **fail points** (``chaos.fail_point(name)``, ``core.py``): named
  hooks compiled into the dangerous spots (checkpoint commit, serving
  dispatch, the hot-swap install, the preemption signal path).
  Disarmed they are one module-flag check; armed, seeded rules decide
  deterministically which hit dies, and how (``RAISE``, ``KILL``,
  ``sleep``, ``truncate``, any callable);
- **scenarios** (``scenarios.py``): the composed experiments the tests
  share --
  continuous-train -> hot-swap under client load (with an optional
  torn publish), and a flood past the bounded serving queue;
- **cross-process replay**: ``make_spec()`` serializes a
  seeded scenario into ``MXNET_TPU_CHAOS_SPEC`` and launched ranks
  replay it with the EXPLICIT ``arm_from_spec()`` call (rules scoped
  per rank and per supervisor generation; production stays env-inert);
- **accounting**: every injected fault counts
  (``chaos.injected.<point>``) and every tolerated one -- injected or
  real -- is recorded by the recovery path itself
  (``chaos.survived.<point>``), so "we survived N faults" is a
  queryable claim, not a vibe.

The port's fail points are the JAX package's names at the same spots:
``checkpoint.commit.pre_manifest``, ``checkpoint.commit.post_commit``,
``checkpoint.async_write``, ``serving.dispatch``, ``serving.swap``,
``serving.decode.prefill``, ``serving.decode.step``,
``numerics.nonfinite`` and ``preemption.signal``.
"""
from __future__ import annotations

from .core import (KILL, RAISE, ChaosInjected, arm, arm_from_spec,
                   armed, disarm, fail_point, make_spec, on, reset,
                   scenario, sleep, stats, survived, truncate)

__all__ = [
    "ChaosInjected", "arm", "disarm", "armed", "reset", "on",
    "fail_point", "survived", "stats", "scenario",
    "arm_from_spec", "make_spec",
    "RAISE", "KILL", "sleep", "truncate",
    "scenarios",
]

from . import scenarios  # noqa: E402  (uses the core surface above)
