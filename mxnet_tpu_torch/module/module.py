"""Module: the legacy symbolic training API (counterpart of
``mxnet_tpu/module/module.py``; reference ``python/mxnet/module/
module.py``).

One :class:`~mxnet_tpu_torch.executor.Executor` on one device runs the
whole graph, captured on the card; the reference's executor group (one
executor a GPU, gradients copied and reduced) is data parallelism,
which here is the ``dist*`` kvstore across processes.  ``context=None``
is the current context, ``gpu(0)`` unless a ``with ctx:`` is in force;
a list of more than one device raises.  Arrays are bound once and
written in place: ``init_params``/``set_params`` copy into them, the
optimizer updates them, and a module bound with ``shared_module`` reads
that module's parameter, aux and gradient arrays themselves.
"""
from __future__ import annotations

import logging

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..model import load_params, save_checkpoint
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _normalize_shapes(shapes):
    """``DataDesc``s from DataDescs, ``(name, shape)`` pairs or a
    dict."""
    if shapes is None:
        return []
    if isinstance(shapes, dict):
        shapes = list(shapes.items())
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], tuple(s[1]))
            for s in shapes]


def _one_context(context):
    if context is None:
        return current_context()
    if isinstance(context, (list, tuple)):
        if len(context) != 1:
            raise MXNetError(
                "Module(context=%r): one device a module, as in the JAX "
                "package; multi-device data parallelism is the "
                "mxnet_tpu_torch.parallel mesh path (TrainStep(mesh=)), "
                "or kvstore='dist_sync' over processes" % (context,))
        context = context[0]
    if not isinstance(context, Context):
        raise MXNetError("Module: context must be a Context, got %r"
                         % (context,))
    return context


class Module(BaseModule):
    """``Module(symbol, data_names, label_names, context)``."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._context = _one_context(context)
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None
        self._inputs_need_grad = False
        self._preloaded_params = None
        self._preloaded_states = None

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write", group2ctx=None):
        """Allocate the executor's arrays for the input shapes; the
        parameters' shapes come from ``Symbol.infer_shape``.  With
        ``shared_module`` the parameter, aux and gradient arrays of the
        same names are that module's own (a bucket of a
        ``BucketingModule`` updates the one set of weights)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self._data_shapes = _normalize_shapes(data_shapes)
        self._label_shapes = _normalize_shapes(label_shapes)
        shapes = {d.name: d.shape
                  for d in self._data_shapes + self._label_shapes}
        if not for_training:
            grad_req = "null"
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._fixed_param_names or name in self._label_names:
                req[name] = "null"
            elif name in self._data_names:
                req[name] = grad_req if inputs_need_grad else "null"
            else:
                req[name] = grad_req
        arg_names = self._symbol.list_arguments()
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        shared = shared_module._exec if shared_module is not None else None
        if shared is not None:
            missing = [n for n in self._param_names + self._aux_names
                       if n not in shared.arg_dict
                       and n not in shared.aux_dict]
            if missing:
                raise MXNetError(
                    "bind: %s not in the shared module (a bucketing "
                    "module's default bucket must hold every bucket's "
                    "parameters)" % missing)

        def alloc(name, shape, pool, dtype="float32"):
            if shared is not None and name in pool:
                arr = pool[name]
                if tuple(arr.shape) != tuple(shape):
                    raise MXNetError(
                        "bind: shared array %r is %s, this graph needs %s"
                        % (name, tuple(arr.shape), tuple(shape)))
                return arr
            return nd.zeros(shape, ctx=self._context, dtype=dtype)

        params = set(self._param_names)
        from ..symbol.symbol import _arg_dtypes
        args = {n: alloc(n, s, shared.arg_dict if shared and n in params
                         else {}, dt)
                for n, s, dt in zip(arg_names, arg_shapes,
                                    _arg_dtypes(self._symbol))}
        args_grad = {n: alloc(n, args[n].shape,
                              shared.grad_dict if shared and n in params
                              else {})
                     for n in arg_names if req[n] != "null"}
        aux_states = {n: alloc(n, s, shared.aux_dict if shared else {})
                      for n, s in zip(self._aux_names, aux_shapes)}
        from ..executor import Executor
        self._exec = Executor(self._symbol, self._context, args, args_grad,
                              req, aux_states=aux_states,
                              group2ctx=group2ctx)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Copy ``arg_params``/``aux_params`` into the bound arrays (on
        their device); a parameter they lack runs ``initializer`` with
        its ``InitDesc``, or raises unless ``allow_missing``.  A graph
        argument found only in ``aux_params`` is taken from there: an
        exported block's running statistics are arguments of its graph
        and ``aux:`` entries of its ``.params``."""
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if self.params_initialized and not force_init:
            return
        if arg_params is None and self._preloaded_params is not None:
            arg_params, preloaded_aux = self._preloaded_params
            aux_params = aux_params or preloaded_aux
        with torch.no_grad():
            for name in self._param_names:
                arr = self._exec.arg_dict[name]._data
                if arg_params is not None and name in arg_params:
                    arr.copy_(arg_params[name]._data)
                elif aux_params is not None and name in aux_params:
                    arr.copy_(aux_params[name]._data)
                elif arg_params is not None and not allow_missing:
                    raise MXNetError("missing parameter %r (pass "
                                     "allow_missing=True to initialize it)"
                                     % name)
                elif initializer is not None:
                    initializer(InitDesc(name), arr)
            for name, arr in self._exec.aux_dict.items():
                if aux_params is not None and name in aux_params:
                    arr._data.copy_(aux_params[name]._data)
                elif initializer is not None:
                    initializer(InitDesc(name), arr._data)
        self.params_initialized = True

    def get_params(self):
        """Copies of the parameters and aux states, by name."""
        self._check_ready()
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: v.copy() for n, v in self._exec.aux_dict.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def init_optimizer(self, kvstore="device", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (``rescale_grad`` 1 / batch by default, as
        the reference) and its updater.  A ``dist*`` kvstore broadcasts
        rank 0's parameters and aux states to every process in one
        bucketed collective, and each ``update()`` sums the gradients
        across the processes first."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer: bind and init_params first")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params and self._data_shapes:
                optimizer_params["rescale_grad"] = \
                    1.0 / self._data_shapes[0].shape[0]
            optimizer = opt.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._kvstore = None
        if isinstance(kvstore, str):
            if kvstore.startswith("dist"):
                from .. import kvstore as kvs
                self._kvstore = kvs.create(kvstore)
        elif kvstore is not None:
            self._kvstore = kvstore
        if self._is_dist():
            from ..distributed import host_broadcast_bucketed, world
            if world()[0] > 1:
                arrs = [self._exec.arg_dict[n]._data
                        for n in self._param_names]
                arrs += [arr._data for _, arr in
                         sorted(self._exec.aux_dict.items())]
                out = host_broadcast_bucketed(arrs, root=0)
                with torch.no_grad():
                    for a, v in zip(arrs, out):
                        a.copy_(v)
        self.optimizer_initialized = True
        if self._preloaded_states is not None:
            self.load_optimizer_states(self._preloaded_states)
            self._preloaded_states = None

    def _is_dist(self):
        return self._kvstore is not None \
            and getattr(self._kvstore, "_is_dist", False)

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Copy the batch into the bound inputs (onto the module's
        device) and run the executor."""
        self._check_ready()
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        feeds = {k: v for k, v in feeds.items() if k in self._exec.arg_dict}
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._check_ready()
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step of every parameter that takes a gradient,
        in place; with a dist kvstore the gradients are summed across
        the processes first (one bucketed collective)."""
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        live = [(i, name) for i, name in enumerate(self._param_names)
                if name in self._exec.grad_dict]
        grads = [self._exec.grad_dict[name] for _, name in live]
        if self._is_dist():
            self._kvstore.pushpull_bucket([i for i, _ in live], grads, grads)
        for (i, name), grad in zip(live, grads):
            self._updater(i, grad._data, self._exec.arg_dict[name]._data)

    def get_outputs(self, merge_multi_context=True):
        self._check_ready()
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self._inputs_need_grad):
            raise MXNetError("get_input_grads: bind with "
                             "inputs_need_grad=True")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-%04d.params``, with
        ``prefix-%04d.states`` when asked."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            if not self.optimizer_initialized:
                raise MXNetError("save_checkpoint: no optimizer states "
                                 "before init_optimizer")
            from ..checkpoint.core import atomic_write_bytes
            atomic_write_bytes("%s-%04d.states" % (prefix, epoch),
                               self._updater.get_states(dump_optimizer=True))

    def load_optimizer_states(self, fname):
        """Optimizer states from a ``.states`` file (this package's or
        the JAX package's), each onto its parameter's device and
        dtype."""
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states: call init_optimizer "
                             "first")
        placement = {}
        for i, name in enumerate(self._param_names):
            w = self._exec.arg_dict[name]._data
            placement[i] = (w.device, w.dtype)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), placement=placement)
        self._optimizer = self._updater.optimizer

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module over ``prefix-symbol.json`` whose ``init_params``
        takes the parameters of ``epoch`` (and whose ``init_optimizer``
        takes its optimizer states, when asked)."""
        from .. import symbol as sym
        mod = Module(sym.load("%s-symbol.json" % prefix), **kwargs)
        mod._preloaded_params = load_params(prefix, epoch)
        if load_optimizer_states:
            mod._preloaded_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def init_params_from_load(self):
        arg_params, aux_params = self._preloaded_params or (None, None)
        self.init_params(arg_params=arg_params, aux_params=aux_params)
