"""Dynamic loss scaling for fp16 AMP (counterpart of
``mxnet_tpu/amp/loss_scaler.py``): the scale doubles after
``scale_window`` clean steps and halves on overflow, never below
``min_scale``.  bf16 keeps fp32's exponent range and needs no scaling.
The overflow check is the numerics sentinel's eager twin,
:func:`~mxnet_tpu_torch.analysis.numerics.finite_all` (``all_finite``
here too), as the JAX ``LossScaler.has_overflow`` calls it.
"""
from __future__ import annotations

from ..analysis.numerics import finite_all

__all__ = ["LossScaler", "all_finite"]

all_finite = finite_all


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._min_scale = float(min_scale)
        self._unskipped = 0

    def has_overflow(self, grad_arrays):
        """True if any gradient holds an inf or a nan: one finite check
        over the whole list and one host read."""
        grads = [g for g in grad_arrays if g is not None]
        if not grads:
            return False
        return not bool(finite_all(grads))

    def update_scale(self, overflow):
        """Adjust the scale after a step (``amp.*`` telemetry when it
        is on)."""
        from .. import telemetry as _telemetry
        if overflow:
            before = self.loss_scale
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
            if _telemetry._ENABLED:
                _telemetry.hooks.amp_overflow(before, self.loss_scale)
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                before = self.loss_scale
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
                if _telemetry._ENABLED:
                    _telemetry.hooks.amp_rescale(before, self.loss_scale)
