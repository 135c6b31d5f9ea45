"""Learning-rate schedulers (counterpart of
``mxnet_tpu/optimizer/lr_scheduler.py``, itself MXNet's
``python/mxnet/lr_scheduler.py``).

A scheduler is called with the optimizer's update count and returns the
learning rate.  The behaviour is the JAX package's, and MXNet's,
exactly:

- ``Optimizer(learning_rate=..., lr_scheduler=s)`` overwrites
  ``s.base_lr`` with ``learning_rate``, but ``warmup_final_lr`` and the
  ``base_lr_orig`` of :class:`PolyScheduler` and
  :class:`CosineScheduler` keep the ``base_lr`` the scheduler was built
  with;
- :class:`FactorScheduler` and :class:`MultiFactorScheduler` keep state
  (the last step they decayed at), so they are meant to be called with
  counts that do not go back.
"""
from __future__ import annotations

import math

from ..base import MXNetError

__all__ = ["CosineScheduler", "FactorScheduler", "LRScheduler",
           "MultiFactorScheduler", "PolyScheduler"]


class LRScheduler:
    """Base scheduler: ``warmup_steps`` updates of warm-up from
    ``warmup_begin_lr``, rising linearly to ``base_lr`` (``"linear"``) or
    held (``"constant"``)."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise MXNetError("bad warmup_mode %r" % self.warmup_mode)

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` every ``step`` updates, no lower than
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor, self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` past each update count of ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` from ``base_lr`` to
    ``final_lr`` over ``max_update - warmup_steps`` updates."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + span * pow(1 - frac, self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` over ``max_update -
    warmup_steps`` updates."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + span \
                * (1 + math.cos(math.pi * frac)) / 2
        return self.base_lr
