"""One training step: forward, loss, backward and the optimizer update
of every parameter (counterpart of
``mxnet_tpu/parallel/data_parallel.py :: TrainStep``, ``mesh=None``).

``step = TrainStep(net, loss_fn, trainer)`` then ``loss = step(x, y)``.
The JAX package compiles the step into one XLA program; the port runs
it eagerly with the same contract:

- parameters whose shape is still deferred are materialized by one
  forward under ``autograd.pause()`` (predict mode) before the first
  step;
- a parameter whose tensor dtype drifted from its declared dtype is
  cast back before optimizer state is made from it;
- the per-sample loss is **summed** over the batch for backward, and
  the update rescales by ``trainer._scale / batch_size``;
- a parameter that backward leaves without a gradient is updated as
  with a zero gradient (the JAX step's ``value_and_grad`` gives zeros);
- a ``LAMB`` optimizer is applied over one flat bucket per dtype
  (:func:`mxnet_tpu_torch.kernels.optimizer_update.bucket_update`, the
  JAX step's path under ``MXNET_TPU_KERNELS=1``; the port has no
  switch), any other optimizer parameter by parameter;
- the update counts advance every step, but when any gradient is not
  finite the weights and optimizer state are left as they were (one
  host check per step); running statistics keep the forward's update,
  as in the JAX package;
- the return value is the mean loss, a 0-d tensor.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError
from ..kernels.optimizer_update import bucket_supported, bucket_update

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, block, loss_fn, trainer, mesh=None, batch_axis=0):
        if mesh is not None:
            raise MXNetError("TrainStep: the port runs on one device; "
                             "meshes are not ported yet")
        self._block = block
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._batch_axis = batch_axis
        self.last_step_finite = None

    def _device(self):
        for p in self._block.collect_params().values():
            if p._data is not None:
                return p._data.device
            if p._deferred_init is not None:
                return p._deferred_init[1]
        raise MXNetError("TrainStep: initialize the block first")

    def _stage(self, t, device):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        return t.to(device, non_blocking=True)

    def __call__(self, data, label, batch_size=None):
        tr = self._trainer
        opt = tr._optimizer
        device = self._device()
        data = self._stage(data, device)
        label = self._stage(label, device)
        if any(p._deferred_init is not None
               for p in self._block.collect_params().values()):
            with autograd.pause():
                self._block(data)
        for p in tr._params:
            if p._data is not None and p._data.dtype != p.dtype:
                p.cast(p.dtype)
        live = [(i, p) for i, p in enumerate(tr._params)
                if p.grad_req != "null" and p._data is not None]
        for i, p in live:
            tr._updater.ensure_state(i, p._data)
            p._data.grad = None

        with autograd.record():
            loss = self._loss_fn(self._block(data), label)
        loss.sum().backward()

        for i, _p in live:
            opt._update_count(i)
        bs = batch_size if batch_size is not None \
            else data.shape[self._batch_axis]
        opt.rescale_grad = tr._scale / bs
        grads = [p._data.grad if p._data.grad is not None
                 else torch.zeros_like(p._data) for _i, p in live]
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        self.last_step_finite = finite
        if finite:
            states = tr._updater.states
            if bucket_supported(opt):
                bucket_update(opt, [(i, p._data, g, states[i])
                                    for (i, p), g in zip(live, grads)])
            else:
                for (i, p), g in zip(live, grads):
                    opt._apply(i, p._data, g, states[i])
        for _i, p in live:
            p._data.grad = None
        return loss.detach().mean()
