"""Training steps: forward, loss, backward and the optimizer update of
every parameter (counterpart of
``mxnet_tpu/parallel/data_parallel.py :: TrainStep``, ``mesh=None``).

``step = TrainStep(net, loss_fn, trainer)`` then ``loss = step(x, y)``,
or ``losses = step.run_steps(xs, ys)`` for K steps over batches stacked
on a leading axis.  The JAX package compiles the step (and the K-step
``lax.scan``) into one XLA program; the port runs it eagerly with the
same contract:

- parameters whose shape is still deferred are materialized by one
  forward under ``autograd.pause()`` (predict mode) before the first
  step;
- a parameter whose tensor dtype drifted from its declared dtype is
  cast back before optimizer state is made from it;
- the per-sample loss is **summed** over the batch for backward, and
  the update rescales by ``trainer._scale / batch_size``;
- with an fp16 loss scaler attached to the trainer
  (:func:`mxnet_tpu_torch.amp.init_trainer`), the summed loss is scaled
  by ``loss_scale`` for backward, ``1 / loss_scale`` is folded into the
  update's ``rescale_grad``, and the step's finite check updates the
  scale;
- a parameter that backward leaves without a gradient is updated as
  with a zero gradient (the JAX step's ``value_and_grad`` gives zeros);
- a ``LARS`` or ``LAMB`` optimizer is applied over one flat bucket per
  dtype (:func:`mxnet_tpu_torch.kernels.optimizer_update.bucket_update`,
  the JAX step's path under ``MXNET_TPU_KERNELS=1``; the port has no
  switch), any other optimizer parameter by parameter;
- the update counts advance every step, but when any gradient is not
  finite the weights and optimizer state are left as they were (one
  host check per step); running statistics keep the forward's update,
  as in the JAX package;
- ``__call__`` returns the mean loss, a 0-d tensor; ``run_steps``
  returns the K mean losses as a ``(K,)`` tensor on the device, reads
  lr and wd once at the start of the block, and refuses an fp16 loss
  scaler, as the JAX package does.
"""
from __future__ import annotations

import contextlib

import torch

from .. import autograd
from ..amp.loss_scaler import all_finite
from ..base import MXNetError
from ..kernels.optimizer_update import bucket_supported, bucket_update

__all__ = ["TrainStep"]


@contextlib.contextmanager
def _rates_held(opt, idxs):
    """Within the scope the optimizer's lr and wd of each index are the
    values read on entry."""
    lrs = {i: opt._get_lr(i) for i in idxs}
    wds = {i: opt._get_wd(i) for i in idxs}
    opt._get_lr, opt._get_wd = lrs.__getitem__, wds.__getitem__
    try:
        yield
    finally:
        del opt._get_lr, opt._get_wd


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

    def _prepare(self, first_batch):
        """Materialize deferred shapes, cast drifted parameters back and
        make optimizer state: ``[(index, parameter)]`` of the parameters
        that take a gradient."""
        tr = self._trainer
        if any(p._deferred_init is not None
               for p in self._block.collect_params().values()):
            with autograd.pause():
                self._block(first_batch)
        for p in tr._params:
            if p._data is not None and p._data.dtype != p.dtype:
                p.cast(p.dtype)
        live = [(i, p) for i, p in enumerate(tr._params)
                if p.grad_req != "null" and p._data is not None]
        for i, p in live:
            tr._updater.ensure_state(i, p._data)
            p._data.grad = None
        return live

    def _step(self, live, data, label, batch_size):
        """One forward, backward and update; the mean loss, on the
        device."""
        tr = self._trainer
        opt = tr._optimizer
        scaler = getattr(tr, "_amp_loss_scaler", None)
        loss_scale = scaler.loss_scale if scaler is not None else 1.0
        with autograd.record():
            loss = self._loss_fn(self._block(data), label)
        total = loss.sum()
        (total * loss_scale if scaler is not None else total).backward()

        for i, _p in live:
            opt._update_count(i)
        bs = batch_size if batch_size is not None \
            else data.shape[self._batch_axis]
        opt.rescale_grad = tr._scale / bs / loss_scale
        grads = [p._data.grad if p._data.grad is not None
                 else torch.zeros_like(p._data) for _i, p in live]
        finite = bool(all_finite(grads))
        self.last_step_finite = finite
        if scaler is not None:
            scaler.update_scale(not finite)
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

    def __call__(self, data, label, batch_size=None):
        device = self._device()
        data = self._stage(data, device)
        label = self._stage(label, device)
        live = self._prepare(data)
        return self._step(live, data, label, batch_size)

    def run_steps(self, data, label, batch_size=None):
        """K training steps over ``data``/``label`` of shape ``(K, B,
        ...)``: step k trains on ``data[k]``, ``label[k]``.  Returns the
        K mean losses as a ``(K,)`` tensor on the device."""
        tr = self._trainer
        if getattr(tr, "_amp_loss_scaler", None) is not None:
            raise MXNetError(
                "run_steps does not support fp16 dynamic loss scaling "
                "(the scaler's growth/backoff counters live on the host); "
                "use bf16 AMP or per-step __call__ for fp16")
        device = self._device()
        data = self._stage(data, device)
        label = self._stage(label, device)
        live = self._prepare(data[0])
        with _rates_held(tr._optimizer, [i for i, _p in live]):
            losses = [self._step(live, data[k], label[k], batch_size)
                      for k in range(data.shape[0])]
        return torch.stack(losses)
