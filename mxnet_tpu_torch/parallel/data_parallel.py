"""Training steps: forward, loss, backward and the optimizer update of
every parameter (counterpart of
``mxnet_tpu/parallel/data_parallel.py :: TrainStep``, ``mesh=None``).

``step = TrainStep(net, loss_fn, trainer)`` then ``loss = step(x, y)``,
or ``losses = step.run_steps(xs, ys)`` for K steps over batches stacked
on a leading axis.  The JAX package compiles the step (and the K-step
``lax.scan``) into one donated XLA program.  The port's counterpart on
the card is one captured CUDA graph per key (:mod:`.._capture`): the
data's shape and dtype, the label's, ``batch_size``, the AMP policy and
whether an fp16 loss scaler is attached.  A key's first call runs the
step eagerly on the capture stream (the warm-up); its second captures
forward, loss, backward, the finite check and the update as one graph;
every call from then on copies the batch into the graph's static inputs
and replays it.  The graph is captured again when a parameter or
optimizer state it read was rebound (``load_parameters``,
``restore_training``, ``cast``).  On the CPU a key's entry is the eager
step.  The contract is the JAX step's:

- parameters whose shape is still deferred are materialized by one
  forward under ``autograd.pause()`` (predict mode) before the first
  step;
- a parameter whose tensor dtype drifted from its declared dtype is
  cast back before optimizer state is made from it;
- the per-sample loss is **summed** over the batch for backward, and
  the update rescales by ``trainer._scale / batch_size``;
- the per-step scalars -- ``rescale_grad``, the loss scale, the update
  count ``t``, LAMB's bias corrections and each parameter's lr and wd --
  reach the step as one fp32 device tensor, refreshed before each step
  by one copy from a pinned host buffer (the JAX step's traced ``t,
  lrs, wds, rescale, loss_scale``), so ``trainer.set_learning_rate``
  takes effect at the next step without a new capture;
- with an fp16 loss scaler attached to the trainer
  (:func:`mxnet_tpu_torch.amp.init_trainer`), the summed loss is scaled
  by ``loss_scale`` for backward, ``1 / loss_scale`` is folded into the
  update's ``rescale_grad``, and the step's finite flag, read on the
  host once after the step (the scaler's counters live on the host, as
  in the JAX package), updates the scale;
- a parameter that backward leaves without a gradient is updated as
  with a zero gradient (the JAX step's ``value_and_grad`` gives zeros);
- optimizer state is made by ``create_state_multi_precision`` and the
  update applied by the optimizer's multi-precision entry point, so an
  fp16 weight of a ``multi_precision`` optimizer is updated through its
  fp32 master copy, written back in place;
- a ``LARS`` or ``LAMB`` optimizer is applied over one flat bucket per
  dtype (:func:`mxnet_tpu_torch.kernels.optimizer_update.bucket_update`,
  the JAX step's path under ``MXNET_TPU_KERNELS=1``; the port has no
  switch), any other optimizer parameter by parameter.  There the
  optimizer reads its lr, wd, ``rescale_grad`` and update count ``t``
  from the device tensor (``_optimizer_reads``), so Adam's bias
  correction and a per-parameter LAMB's follow ``t`` across replays;
- the update counts advance every step, but when any gradient is not
  finite the weights and optimizer state (a master copy included) keep
  their old values: a select on the device (``torch.where(all_finite,
  new, old)``), no host read; running statistics keep the forward's
  update, as in the JAX package;
- with the numerics sentinel armed (``MXNET_TPU_NUMERICS_CHECK=1``,
  :mod:`..analysis.numerics`), ``__call__`` reads the finite flag once
  after the step and on a non-finite step raises ``NonFiniteError``
  naming the first offender, the weights at their pre-step values;
  disarmed it reads nothing;
- ``__call__`` returns the mean loss, a 0-d tensor; ``run_steps``
  returns the K mean losses as a ``(K,)`` tensor on the device, reads
  lr and wd once for the block, at its first step's count, and refuses
  an fp16 loss scaler, as the JAX package does;
- with ``mx.profiling`` on, a key's warm-up is walked into its
  CostReport (label ``train_step:<Block>``, ``train_scan:<Block>``
  under ``run_steps``), and each step's dispatch wall feeds the
  roofline's step clock (``profiling.step_time``, the goodput ledger's
  device_compute) and the step timeline.  A replay returns before the
  card finishes: the wait lands where the host reads a result (the
  ``host_sync`` category).  :meth:`cost_analysis` gives the last key's
  flops and bytes, walking one eager step then if the key was not
  profiled (its weights, optimizer state and random state restored
  after).
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import _capture
from .. import amp as _amp
from .. import autograd
from .. import chaos as _chaos
from .. import profiling as _profiling
from .. import random as _random
from ..analysis import numerics as _numerics
from ..amp.loss_scaler import all_finite
from ..base import MXNetError
from ..kernels.optimizer_update import (bucket_supported, bucket_update,
                                        lamb_bias_corrections)
from ..ndarray import NDArray

__all__ = ["TrainStep"]


@contextlib.contextmanager
def _rates_held(opt, idxs):
    """Within the scope the optimizer's lr and wd of each index are the
    values at the block's first step: read with ``num_update`` at that
    step's count, as the JAX package's ``run_steps`` reads them."""
    first = opt._index_update_count.get(idxs[0], opt.begin_num_update) \
        + 1 if idxs else opt.num_update
    saved = opt.num_update
    opt.num_update = max(saved, first)
    try:
        lrs = {i: opt._get_lr(i) for i in idxs}
        wds = {i: opt._get_wd(i) for i in idxs}
    finally:
        opt.num_update = saved
    with _optimizer_reads(opt, lrs.__getitem__, wds.__getitem__):
        yield


class _StepCount(dict):
    """Stands in for ``Optimizer._index_update_count`` inside a step
    body: every index reads the step's count ``t``, a 0-d tensor on the
    device (the JAX package's ``_TracedCount``)."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, index):
        return self._t

    def __contains__(self, index):
        return True


@contextlib.contextmanager
def _optimizer_reads(opt, get_lr, get_wd, rescale=None, count=None):
    """Within the scope the optimizer reads its lr and wd from the given
    functions, ``rescale_grad`` from ``rescale`` and its update count
    from ``count`` (a device tensor), where given; the ones it had are
    back on exit."""
    names = ("_get_lr", "_get_wd")
    held = {k: opt.__dict__[k] for k in names if k in opt.__dict__}
    saved = opt.rescale_grad, opt._index_update_count
    opt._get_lr, opt._get_wd = get_lr, get_wd
    if rescale is not None:
        opt.rescale_grad = rescale
    if count is not None:
        opt._index_update_count = _StepCount(count)
    try:
        yield
    finally:
        for k in names:
            opt.__dict__.pop(k, None)
        opt.__dict__.update(held)
        opt.rescale_grad, opt._index_update_count = saved


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _tensors(state):
    """The tensors of an optimizer state (None, a tensor or a tuple)."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _tensors(s)]
    return []


class _StepScalars:
    """A step's per-step scalars as one fp32 tensor on the device:
    ``[rescale, loss_scale, t, bc1, bc2, lr_0.., wd_0..]`` over the
    parameters that take a gradient.  :meth:`set` refreshes it before
    each step; on the card by one copy from a pinned host buffer, two
    buffers taken in turn, each rewritten only once its last copy has
    finished."""

    HEAD = 5

    def __init__(self, n, device):
        self.n = n
        self.dev = torch.zeros(self.HEAD + 2 * n, dtype=torch.float32,
                               device=device)
        self._host, self._done, self._turn = [], [], 0
        if device.type == "cuda":
            self._host = [torch.zeros(self.dev.shape, dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self._done = [None, None]

    def set(self, values):
        vals = torch.tensor(values, dtype=torch.float32)
        if not self._host:
            self.dev.copy_(vals)
            return
        k, self._turn = self._turn, self._turn ^ 1
        if self._done[k] is not None:
            self._done[k].synchronize()
        self._host[k].copy_(vals)
        self.dev.copy_(self._host[k], non_blocking=True)
        self._done[k] = torch.cuda.Event()
        self._done[k].record()

    @property
    def rescale(self):
        return self.dev[0]

    @property
    def loss_scale(self):
        return self.dev[1]

    @property
    def t(self):
        return self.dev[2]

    @property
    def lrs(self):
        return self.dev[self.HEAD:self.HEAD + self.n]

    @property
    def wds(self):
        return self.dev[self.HEAD + self.n:]

    def feed(self):
        """The bucketed update's scalars (:func:`bucket_update`)."""
        return {"lrs": self.lrs, "wds": self.wds,
                "rescale": self.dev[0:1], "corrections": self.dev[3:5]}


class TrainStep:
    def __init__(self, block, loss_fn, trainer, mesh=None, batch_axis=0):
        if mesh is not None:
            raise MXNetError("TrainStep runs on one device: meshes, the "
                             "SPMD half of the multi-device slice (ROADMAP "
                             "item 9b), are not ported; multi-process data "
                             "parallelism is Trainer(kvstore='dist_sync')")
        self._block = block
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._batch_axis = batch_axis
        self._owner = None
        self._scalars = None
        self._finite = None
        self._finite_host = None
        self._last = None          # (label, key, batch shapes, live)
        self._cost_reports = {}    # key -> CostReport walked on demand

    @property
    def last_step_finite(self):
        """Whether every gradient of the last step was finite (None
        before the first step).  The step keeps the flag as a 0-d bool
        on the device; this property reads it on the host, lazily, when
        it is asked for."""
        return None if self._finite is None else bool(self._finite)

    def capture_stats(self):
        """The graphs of this step and its keys
        (:meth:`GraphOwner.stats`)."""
        return self._owner.stats() if self._owner is not None \
            else {"keys": []}

    def _device(self):
        for p in self._block.collect_params().values():
            if p._data is not None:
                return p._data.device
            if p._deferred_init is not None:
                return p._deferred_init[1]
        raise MXNetError("TrainStep: initialize the block first")

    def _stage(self, t, device):
        if isinstance(t, NDArray):
            t = t._data
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

    def _feed(self, live, batch_size, data):
        """Advance the update counts and refresh the per-step scalars;
        returns the scalars and whether the loss is scaled."""
        tr = self._trainer
        opt = tr._optimizer
        scaler = getattr(tr, "_amp_loss_scaler", None)
        loss_scale = scaler.loss_scale if scaler is not None else 1.0
        idxs = [i for i, _p in live]
        for i in idxs:
            opt._update_count(i)
        bs = batch_size if batch_size is not None \
            else data.shape[self._batch_axis]
        opt.rescale_grad = tr._scale / bs / loss_scale
        t = opt._index_update_count[idxs[0]] if idxs else 0
        bcs = lamb_bias_corrections(t, opt.beta1, opt.beta2,
                                    opt.bias_correction) \
            if hasattr(opt, "bias_correction") else (1.0, 1.0)
        if self._scalars is None or self._scalars.n != len(idxs) \
                or self._scalars.dev.device != data.device:
            self._scalars = _StepScalars(len(idxs), data.device)
        self._scalars.set([opt.rescale_grad, loss_scale, t, *bcs]
                          + [opt._get_lr(i) for i in idxs]
                          + [opt._get_wd(i) for i in idxs])
        return self._scalars, scaler

    def _body(self, live, data, label, sc, scaled):
        """One forward, backward and update, reading the per-step scalars
        from ``sc`` and nothing from the host; the mean loss and the
        finite flag, on the device."""
        tr = self._trainer
        opt = tr._optimizer
        for _i, p in live:
            p._data.grad = None
        with autograd.record():
            loss = self._loss_fn(self._block(data), label)
        total = loss.sum()
        (total * sc.loss_scale if scaled else total).backward()
        grads = [p._data.grad if p._data.grad is not None
                 else torch.zeros_like(p._data) for _i, p in live]
        finite = all_finite(grads)
        states = tr._updater.states
        if bucket_supported(opt):
            bucket_update(opt, [(i, p._data, g, states[i])
                                for (i, p), g in zip(live, grads)],
                          feed=sc.feed(), finite=finite)
        else:
            pos = {i: k for k, (i, _p) in enumerate(live)}
            with _optimizer_reads(opt, lambda i: sc.lrs[pos[i]],
                                  lambda i: sc.wds[pos[i]], sc.rescale,
                                  sc.t), torch.no_grad():
                for (i, p), g in zip(live, grads):
                    kept = [p._data] + _tensors(states[i])
                    old = [t.clone() for t in kept]
                    opt._apply_multi_precision(i, p._data, g, states[i])
                    for t, o in zip(kept, old):
                        t.copy_(torch.where(finite, t, o))
        for _i, p in live:
            p._data.grad = None
        return loss.detach().mean(), finite

    def _watched(self, live):
        """The tensors a captured step reads that a user may rebind:
        every parameter of the block and every optimizer state."""
        states = self._trainer._updater.states
        return [p._data for p in self._block.collect_params().values()] \
            + [t for i, _p in live for t in _tensors(states.get(i))] \
            + [self._scalars.dev]

    def _step(self, live, data, label, batch_size, kind="train_step"):
        """One step through the key's entry: eager on the CPU and on a
        key's first call on the card, a replay of its graph after."""
        sc, scaler = self._feed(live, batch_size, data)
        scaled = scaler is not None
        key = (tuple(data.shape), _dtype_name(data.dtype),
               tuple(label.shape), _dtype_name(label.dtype), batch_size,
               _amp.policy_token(), scaled, str(data.device))
        if self._owner is None:
            self._owner = _capture.GraphOwner(
                "TrainStep(%s)" % type(self._block).__name__, data.device,
                site="train_step")
        plabel = "%s:%s" % (kind, type(self._block).__name__)
        self._last = (plabel, key, (data.shape, data.dtype, label.shape,
                                    label.dtype, batch_size), live)
        watched = self._watched(live)
        profile = (plabel, "train_step", ("train_step", id(self), key),
                   watched + [data, label]) if _profiling._ENABLED else None
        t0 = time.perf_counter() if _profiling._ENABLED else None
        built = self._owner.build_s
        loss, finite = self._owner.run(
            key, lambda x, y: self._body(live, x, y, sc, scaled),
            [data, label], watched, "the step of key %r" % (key,),
            profile)
        if t0 is not None:
            # the key's warm-up and capture are compile.build_time's
            # (the ledger's recompile), not the dispatch wall
            self._profiling_hook(plabel, t0, time.perf_counter() - t0
                                 - (self._owner.build_s - built),
                                 batch_size if batch_size is not None
                                 else data.shape[self._batch_axis])
        self._finite, self._finite_host = finite, None
        if scaled:
            self._finite_host = bool(finite)
            scaler.update_scale(not self._finite_host)
        return loss

    @staticmethod
    def _profiling_hook(label, t0, dispatch_s, items):
        """mx.profiling for one dispatched step: the roofline's step
        clock and a timeline span.  The dispatch wall is what the host
        spent; a replay returns before the card finishes, so the wait
        for the card lands where the host reads a result."""
        from ..profiling import timeline
        _profiling.record_step(label, dispatch_s, items=items)
        timeline.record(label, t0, dispatch_s, {"items": items})

    def cost_report(self, label=None):
        """The CostReport of the last dispatched key: the profiling
        store's, when ``mx.profiling`` walked its warm-up, else one
        eager step walked now on zeros of the key's batch shapes, with
        every parameter, optimizer state and the random state restored
        after it.  None before the first step."""
        if self._last is None:
            return None
        plabel, key, shapes, live = self._last
        label = label or plabel
        pkey = ("train_step", id(self), key)
        from ..profiling import store
        rep = store.report(pkey)
        if rep is not None:
            return rep
        rep = self._cost_reports.get(key)
        if rep is None:
            rep = self._cost_reports[key] = self._walk(label, shapes, live)
        return rep

    def _walk(self, label, shapes, live):
        """One eager step of the key walked into a CostReport (not
        stored), leaving the block, the optimizer state and the random
        state as they were."""
        from ..profiling import aten, cost
        dshape, ddtype, lshape, ldtype, _bs = shapes
        device = self._device()
        data = torch.zeros(dshape, dtype=ddtype, device=device)
        label_t = torch.zeros(lshape, dtype=ldtype, device=device)
        watched = self._watched(live)
        kept = [t for t in watched if t is not None]
        saved = [t.detach().clone() for t in kept]
        gen = _random.generator(device)
        rng = gen.get_state()
        scaled = getattr(self._trainer, "_amp_loss_scaler", None) is not None
        try:
            with aten.Walk() as walk, _capture.body_scope():
                out = self._body(live, data, label_t, self._scalars, scaled)
        finally:
            with torch.no_grad():
                for t, s in zip(kept, saved):
                    t.copy_(s)
            for _i, p in live:
                p._data.grad = None
            gen.set_state(rng)
        return cost.analyze_walk(
            walk, label=label, kind="train_step", device=device,
            argument_bytes=sum(t.numel() * t.element_size()
                               for t in kept + [data, label_t]),
            output_bytes=sum(t.numel() * t.element_size() for t in out))

    def cost_analysis(self):
        """Cost of the most recently dispatched key --
        ``{"flops": ..., "bytes accessed": ..., ...}`` from its
        CostReport (:meth:`cost_report`), or None before the first step.
        Powers the goodput ledger's MFU."""
        rep = self.cost_report()
        if rep is None:
            return None
        return {"flops": rep["totals"]["flops"],
                "bytes accessed": rep["totals"]["bytes_accessed"],
                "transcendentals": rep["totals"]["transcendentals"],
                "argument bytes": rep["memory"]["argument_bytes"],
                "output bytes": rep["memory"]["output_bytes"]}

    def __call__(self, data, label=None, batch_size=None):
        """One training step on ``(data, label)``, or on a
        :class:`~..dataio.DeviceBatch` alone (a fed batch carries its
        label as its second part; it is used where it landed)."""
        if label is None:
            from ..dataio import DeviceBatch
            if isinstance(data, DeviceBatch):
                data, label = data.data, data.label
            if label is None:
                raise MXNetError(
                    "TrainStep needs (data, label) or a DeviceBatch "
                    "with a label component")
        device = self._device()
        data = self._stage(data, device)
        label = self._stage(label, device)
        live = self._prepare(data)
        # numerics.nonfinite chaos point: poison_action marks the box
        # and THIS step injects the NaN into its own batch, so the fault
        # flows through forward/backward and the sentinel must catch it
        box = {}
        _chaos.fail_point("numerics.nonfinite", box=box,
                          step=self._trainer._optimizer.num_update + 1)
        if box.get("poison"):
            data = _numerics.poison_nd(data)
        if not _numerics.check_enabled():
            return self._step(live, data, label, batch_size)
        gen = _random.generator(device)
        rng_state = gen.get_state()
        loss = self._step(live, data, label, batch_size)
        finite = self._finite_host if self._finite_host is not None \
            else bool(self._finite)
        if not finite:
            gen.set_state(rng_state)
            self._raise_nonfinite(live, data, label)
        return loss

    def _raise_nonfinite(self, live, data, label):
        """The sentinel's failure path: the step's gradients recomputed
        eagerly from the weights it kept (its pre-step values), on the
        same batch and random state, named, and the first offender
        raised as :class:`~..analysis.numerics.NonFiniteError`.  The
        recomputation's forward leaves the running statistics as the
        step left them."""
        tr = self._trainer
        frozen = [(p._data, p._data.clone())
                  for p in self._block.collect_params().values()
                  if p.grad_req == "null" and p._data is not None]
        scaler = getattr(tr, "_amp_loss_scaler", None)
        try:
            with autograd.record():
                loss = self._loss_fn(self._block(data), label)
            total = loss.sum()
            (total * scaler.loss_scale if scaler is not None
             else total).backward()
            named = [(p.name, p._data.grad) for _i, p in live] \
                + [("loss", loss.detach().mean())]
            hit = _numerics.attribute_nonfinite(named)
        finally:
            for _i, p in live:
                p._data.grad = None
            with torch.no_grad():
                for t, kept in frozen:
                    t.copy_(kept)
        param, kind = hit if hit is not None \
            else ("<unattributed>", "nonfinite")
        step_no = tr._optimizer.num_update
        _numerics.record_nonfinite(param, step_no, kind)
        raise _numerics.NonFiniteError(param, step_no, kind)

    def run_steps(self, data, label, batch_size=None):
        """K training steps over ``data``/``label`` of shape ``(K, B,
        ...)``: step k trains on ``data[k]``, ``label[k]`` (on the card,
        K replays of the step's graph, each batch copied on the device).
        Returns the K mean losses as a ``(K,)`` tensor on the device."""
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
            losses = [self._step(live, data[k], label[k], batch_size,
                                 kind="train_scan")
                      for k in range(data.shape[0])]
        return torch.stack(losses)
