"""Dynamic loss scaling for fp16 AMP (counterpart of
``mxnet_tpu/amp/loss_scaler.py``): the scale doubles after
``scale_window`` clean steps and halves on overflow, never below
``min_scale``.  bf16 keeps fp32's exponent range and needs no scaling.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler", "all_finite"]


def all_finite(tensors):
    """A 0-d bool tensor on the tensors' device: whether every element of
    every tensor is finite.  One reduction per tensor and one stack; no
    host read."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


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
        return not bool(all_finite(grads))

    def update_scale(self, overflow):
        """Adjust the scale after a step."""
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
