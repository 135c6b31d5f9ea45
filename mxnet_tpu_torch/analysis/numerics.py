"""The non-finite sentinel, runtime half (counterpart of the runtime
layer of ``mxnet_tpu/analysis/numerics.py``).

Behind ``MXNET_TPU_NUMERICS_CHECK=1`` (read once at import; tests flip
it with :func:`_set_check`), ``TrainStep`` reads the finite flag its
step already computes, once after the step.  On the first non-finite
step it recomputes that step's gradients eagerly, from the weights the
step kept (a non-finite step keeps the pre-step weights and states) on
the same batch with the random state of the step, names the first
offender (:func:`attribute_nonfinite`, NaN before Inf) and raises
:class:`NonFiniteError`.  Disarmed, the default, the step makes no host
read for it.

The JAX package's static lints, HLO audit, chaos point and telemetry
hooks are not part of the port.
"""
from __future__ import annotations

import torch

from .. import env

__all__ = ["NonFiniteError", "attribute_nonfinite", "check_enabled",
           "record_nonfinite"]

_CHECK = env.get("MXNET_TPU_NUMERICS_CHECK")

# the sentinel's record: non-finite steps seen, the last one
_STATE = {"nonfinite": 0, "last": None}


def check_enabled() -> bool:
    """Is the non-finite sentinel armed (``MXNET_TPU_NUMERICS_CHECK``)?"""
    return _CHECK


def _set_check(flag):
    """Arm or disarm the sentinel without re-importing; returns the
    previous setting."""
    global _CHECK
    prev = _CHECK
    _CHECK = bool(flag)
    return prev


class NonFiniteError(RuntimeError):
    """A gradient (or the loss) went NaN/Inf; ``param`` names the first
    offender, ``step`` the update count, ``kind`` is ``'nan'`` or
    ``'inf'``.  Raised after the step kept the pre-step weights and
    optimizer state, so a handler can lower the lr or skip the batch and
    go on."""

    def __init__(self, param, step, kind):
        super().__init__(
            "non-finite gradient: %s in parameter %r at step %s "
            "(weights kept at their pre-step values)" % (kind, param, step))
        self.param = param
        self.step = step
        self.kind = kind


def attribute_nonfinite(named):
    """``(name, kind)`` of the first non-finite entry of ``(name,
    tensor)`` pairs, NaN reported before Inf when both occur; None when
    every entry is finite.  Reads each tensor on the host (the failure
    path only)."""
    first_inf = None
    for name, t in named:
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            continue
        t = t.detach()
        if bool(torch.isnan(t).any()):
            return name, "nan"
        if first_inf is None and bool(torch.isinf(t).any()):
            first_inf = (name, "inf")
    return first_inf


def record_nonfinite(param, step, kind):
    """Book a detected non-finite step."""
    _STATE["nonfinite"] += 1
    _STATE["last"] = {"param": param, "step": step, "kind": kind}
