"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` is ``allreduce_grads()`` then ``update(batch_size)``:

- the gradients go through the kvstore (:mod:`mxnet_tpu_torch.kvstore`),
  one ``pushpull`` a live gradient, written back in place.  The default
  ``kvstore="device"``, ``"local"`` and ``"nccl"`` are single-process
  stores: they return the gradient as it is, or its 2-bit quantization
  with ``compression_params={"type": "2bit", "threshold": t}``.
  ``kvstore=None`` skips the pass.  A ``dist_*`` store in a world of
  several processes sums the gradients across them in ONE bucketed
  ``pushpull_bucket`` a step; each rank passes its own batch size, so
  the update applies the sum of the ranks' gradients over the local
  batch, as the JAX package's does.  Before its first reduction a dist
  store broadcasts rank 0's parameters to every rank in one bucketed
  collective (the reference's ``kv.init`` + pull), once per parameter,
  a parameter whose deferred init lands later included: every rank
  starts from rank 0's weights whatever its initializer drew.
  BatchNorm's running statistics stay per rank after that, as in the
  reference.  ``update_on_kvstore`` is kept for the API, as the JAX
  package keeps it: the update runs here;
- the update applies the optimizer to every parameter that takes a
  gradient, with ``rescale_grad = _scale / batch_size``, through the
  updater's multi-precision entry point (an fp16 parameter of a
  ``multi_precision`` optimizer is updated through an fp32 master
  copy).  The JAX package groups plain SGD into ``multi_sgd(_mom)_update``
  calls to cut XLA dispatches; here those ops launch one update a
  tensor, so SGD takes the updater like every other optimizer.

``learning_rate`` is the optimizer's: its scheduler's value at the
current update count where it has one.  MXNet's ``grad_req="write"``
overwrites a gradient at each backward where PyTorch accumulates, so
the update clears each ``"write"`` gradient after using it.

With an fp16 loss scaler attached (:func:`mxnet_tpu_torch.amp.
init_trainer`), ``step`` folds ``1 / loss_scale`` into ``rescale_grad``
(unless :func:`~mxnet_tpu_torch.amp.unscale` already divided the
gradients), checks every reduced gradient for overflow, updates the
scale, and on overflow skips the whole update.

With telemetry on, ``step`` records ``trainer.step_time``,
``trainer.steps`` and ``trainer.samples`` as the JAX package does.

``save_states``/``load_states`` write and read the optimizer state blob
of :meth:`~mxnet_tpu_torch.optimizer.Updater.get_states`; the write is
atomic (:func:`mxnet_tpu_torch.checkpoint.atomic_write_bytes`).
"""
from __future__ import annotations

import time

import torch

from .. import kvstore as kvs
from .. import optimizer as opt
from .. import profiling as _profiling
from .. import telemetry as _telemetry
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a dict/list of Parameters")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError("non-Parameter in Trainer params: %r"
                                 % (p,))
            self._params.append(p)
        self._scale = 1.0
        if isinstance(optimizer, opt.Optimizer):
            self._optimizer = optimizer
        else:
            param_dict = dict(enumerate(self._params))
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._updater = opt.get_updater(self._optimizer)
        if isinstance(kvstore, str):
            kvstore = kvs.create(kvstore) if kvstore else None
        if kvstore is not None and compression_params:
            kvstore.set_gradient_compression(compression_params)
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._dist_synced = set()

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _live(self):
        """``(index, param)`` of every parameter holding a gradient."""
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None
                and p._data.grad is not None]

    def _updatable(self, ignore_stale_grad=False):
        out = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if p._data.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError("parameter %s has no gradient; run "
                                 "backward first" % p.name)
            out.append((i, p))
        return out

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients through the kvstore, then apply the
        optimizer to every parameter with a gradient (``trainer.*``
        telemetry when it is on: the host wall of the call, which does
        not wait for the card; with ``mx.profiling`` on, a
        ``trainer.step`` span on the step timeline)."""
        t0 = time.perf_counter() \
            if _telemetry._ENABLED or _profiling._ENABLED else None
        try:
            self._step(batch_size, ignore_stale_grad)
        finally:
            if t0 is not None:
                dt = time.perf_counter() - t0
                if _telemetry._ENABLED:
                    _telemetry.hooks.trainer_step(dt, batch_size)
                if _profiling._ENABLED:
                    from ..profiling import timeline
                    timeline.record("trainer.step", t0, dt,
                                    {"batch": batch_size})

    def _step(self, batch_size, ignore_stale_grad):
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            if not getattr(self, "_amp_unscaled", False):
                self._optimizer.rescale_grad /= scaler.loss_scale
            self._amp_unscaled = False
            overflow = scaler.has_overflow(
                [p._data.grad for _i, p in self._live()])
            scaler.update_scale(overflow)
            if overflow:
                self._clear_written(self._updatable(ignore_stale_grad))
                return
        self._update(ignore_stale_grad)

    def _sync_initial_params(self):
        """Broadcast rank 0's values of every parameter not yet synced
        (one bucketed collective), on a dist store in a world of
        several processes.  Every rank must materialize a deferred
        parameter at the same step: the broadcast is a collective."""
        if self._kvstore is None \
                or not getattr(self._kvstore, "_is_dist", False):
            return
        from ..distributed import host_broadcast_bucketed, world
        if world()[0] <= 1:
            return
        todo = [p for p in self._params
                if p.name not in self._dist_synced and p._data is not None]
        if not todo:
            return
        synced = host_broadcast_bucketed([p._data for p in todo], root=0)
        with torch.no_grad():
            for p, v in zip(todo, synced):
                p._data.copy_(v)
                self._dist_synced.add(p.name)

    def allreduce_grads(self):
        """Reduce every live gradient through the kvstore, in place (a
        dist store: one bucketed collective, after the initial
        broadcast of parameters it has not synced yet)."""
        if self._kvstore is None:
            return
        self._sync_initial_params()
        live = self._live()
        if getattr(self._kvstore, "_is_dist", False):
            grads = [p._data.grad for _i, p in live]
            self._kvstore.pushpull_bucket([i for i, _p in live], grads,
                                          grads)
            return
        for i, p in live:
            g = p._data.grad
            self._kvstore.pushpull(i, g, out=g)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (after :meth:`allreduce_grads`)."""
        self._sync_initial_params()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updatable = self._updatable(ignore_stale_grad)
        for i, p in updatable:
            self._updater(i, p._data.grad, p._data)
        self._clear_written(updatable)

    @staticmethod
    def _clear_written(updatable):
        for _i, p in updatable:
            if p.grad_req == "write":
                p._data.grad = None

    def get_states(self):
        """Optimizer state as an opaque bytes blob (what
        ``CheckpointManager`` stores for the ``trainer`` item)."""
        return self._updater.get_states(dump_optimizer=False)

    def set_states(self, states):
        """Install a :meth:`get_states` blob; each state lands on its
        parameter's device at its parameter's dtype, or in fp32 where the
        optimizer keeps an fp32 master copy of an fp16 parameter (the
        copy and the states made from it)."""
        placement = {}
        for i, p in enumerate(self._params):
            if p._data is not None:
                device, dtype = p._data.device, p._data.dtype
            elif p._deferred_init is not None:
                device, dtype = p._deferred_init[1], p.dtype
            else:
                continue
            if self._optimizer.multi_precision and dtype == torch.float16:
                dtype = torch.float32
            placement[i] = (device, dtype)
        self._updater.set_states(states, placement)

    def save_states(self, fname):
        """Write the optimizer state blob to ``fname`` atomically
        (temporary file, fsync, rename): a crash mid-write leaves the
        old file."""
        from ..checkpoint.core import atomic_write_bytes
        atomic_write_bytes(fname, self.get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states(f.read())
