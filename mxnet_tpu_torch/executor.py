"""Graph executor (counterpart of ``mxnet_tpu/executor.py``; reference
``src/executor/graph_executor.cc :: GraphExecutor`` and
``python/mxnet/executor.py :: Executor``).

An executor holds a symbol's bound arrays (``arg_dict``, ``grad_dict``,
``aux_dict``) and runs the symbol's walk over them
(:func:`~.symbol.symbol._eval_symbol`).  The JAX executor jits one eval
program and one train program (forward plus VJP under the default head
cotangent, the gradients pending until ``backward``); here each mode is
a key of a :class:`~._capture.GraphOwner`, as a hybridized block's
shapes are: on the card a key's first call runs eagerly, its second
captures a CUDA graph, and every later call replays it.  The graph reads
the bound arrays in place, so ``forward(data=...)`` copies into them (as
the reference's forward does) and an array rebound since the capture
makes the key capture again.  A training call writes BatchNorm's new
running statistics into the aux arrays inside the graph, in place, and
leaves the gradients pending; ``backward()`` writes them into
``grad_dict`` by ``grad_req`` (``write``/``add``/``null``).  On the CPU
every call is the eager walk.

``backward(out_grads=...)`` with explicit head gradients runs the
training walk once more, eagerly, with those cotangents, as the JAX
executor reruns its train program with them (without the aux updates).

``group2ctx`` runs each node on its ``ctx_group``'s device, forward
only and eagerly, copying tensors at group boundaries (the reference's
PlaceDevice; ``example/model-parallel-lstm``).  Training across groups
is model parallelism, which raises.  ``check=True`` (or
``MXNET_TPU_GRAPH_CHECK=1``) runs the static graph check
(:func:`mxnet_tpu_torch.analysis.assert_graph_ok`, shapes and dtypes on
``meta`` tensors) over the bound arrays' shapes before anything runs:
an error diagnostic raises ``GraphCheckError``, with nothing launched.
"""
from __future__ import annotations

import torch

from . import _capture
from . import env as _env
from . import profiling as _profiling
from .base import MXNetError
from .ndarray import NDArray
from .symbol.symbol import _call_node, _eval_symbol, _store

__all__ = ["Executor"]


class Executor:
    """A bound symbol: ``forward(is_train)``, ``backward(out_grads)``,
    ``outputs`` and the bound arrays by name."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 check=None):
        self._symbol = symbol
        self._ctx = ctx
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.arg_names, args))
        self.arg_dict = dict(args or {})
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.arg_names, args_grad))
        self.grad_dict = dict(args_grad or {})
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        else:
            self.grad_req = dict(grad_req)
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.aux_names, aux_states))
        self.aux_dict = dict(aux_states or {})
        if check is None:
            check = _env.get("MXNET_TPU_GRAPH_CHECK")
        if check:
            from .analysis.graph_check import assert_graph_ok
            shapes = {k: tuple(v.shape)
                      for k, v in {**self.arg_dict, **self.aux_dict}.items()}
            assert_graph_ok(symbol, shapes=shapes or None)
        self.outputs = []
        self._owners = {}
        self._pending_grads = None
        self._trained = False

    # ------------------------------------------------------------------
    def _values(self):
        vals = {k: v._data for k, v in self.arg_dict.items()}
        vals.update({k: v._data for k, v in self.aux_dict.items()})
        return vals

    def _device(self):
        for v in list(self.arg_dict.values()) + list(self.aux_dict.values()):
            return v._data.device
        if self._ctx is None:
            raise MXNetError("Executor: nothing bound and no ctx")
        return self._ctx.torch_device()

    def _grad_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"
                and self.arg_dict[n]._data.is_floating_point()]

    def _owner(self, mode, device):
        owner = self._owners.get(mode)
        if owner is None:
            owner = self._owners[mode] = _capture.GraphOwner(
                "Executor(%s)" % mode, device, site="executor." + mode)
        return owner

    def _train_walk(self, cotangents=None, update_aux=True):
        """The training walk: outputs, and the gradients of the
        arguments that take one under ``cotangents`` (ones by default,
        as the JAX executor's head cotangent); BatchNorm's new running
        statistics are written into the aux arrays after the gradients
        are taken."""
        vals = self._values()
        names = self._grad_names()
        leaves = [vals[n].detach().requires_grad_() for n in names]
        vals.update(zip(names, leaves))
        aux_up = {}
        with torch.enable_grad():
            outs = _eval_symbol(self._symbol, vals, aux_up, training=True)
            if cotangents is None:
                cotangents = [torch.ones_like(o) for o in outs]
            pairs = [(o, c) for o, c in zip(outs, cotangents)
                     if o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], leaves, [c for _, c in pairs],
                allow_unused=True) if pairs and leaves \
                else [None] * len(leaves)
        with torch.no_grad():
            if update_aux:
                for name, v in aux_up.items():
                    if name in self.aux_dict:
                        self.aux_dict[name]._data.copy_(v)
            grads = tuple(torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads))
        return tuple(o.detach() for o in outs), grads

    def _eval_walk(self):
        with torch.no_grad():
            return tuple(_eval_symbol(self._symbol, self._values(),
                                      training=False))

    def _run(self, mode, body):
        """``body()`` through ``mode``'s key of its graph owner."""
        device = self._device()
        owner = self._owner(mode, device)
        vals = self._values()
        key = (mode,) + tuple((n, tuple(vals[n].shape), str(vals[n].dtype))
                              for n in sorted(vals))
        watched = [vals[n] for n in sorted(vals)]
        profile = None
        if _profiling._ENABLED:
            profile = ("executor." + mode, "executor",
                       ("executor", id(self), mode) + key, watched)
        return owner.run(key, body, [], watched, "Executor %s" % mode,
                         profile)

    # -- ctx_group placement (reference: AttrScope(ctx_group=) and
    # bind(group2ctx=), example/model-parallel-lstm) --------------------
    def _forward_grouped(self):
        """Each node on its group's device, copies at group boundaries;
        forward only, eager."""
        def dev_of(node):
            group = node.attrs.get("ctx_group") if node.attrs else None
            ctx = (self._group2ctx.get(group) if group else None) \
                or self._ctx
            return ctx.torch_device() if ctx is not None else None

        vals, feed = {}, self._values()
        with torch.no_grad():
            for node in self._symbol._topo():
                dev = dev_of(node)
                if node.op is None:
                    v = feed.get(node.name)
                    if v is None:
                        raise MXNetError("unbound variable %r" % node.name)
                    vals[(id(node), 0)] = v if dev is None else v.to(dev)
                    continue
                args = [vals[(id(src), oi)] for src, oi in node.inputs]
                if dev is not None:
                    args = [a.to(dev) for a in args]
                _store(vals, node, _call_node(node, args, False, dev))
        self.outputs = [NDArray(vals[(id(n), i)])
                        for n, i in self._symbol._outputs]
        return self.outputs

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference: ``GraphExecutor::RunOps``); the
        arrays given by name are copied into the bound ones first."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            src = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            dst = self.arg_dict[k]._data
            if tuple(src.shape) != tuple(dst.shape):
                raise MXNetError("input %r: shape %s, bound %s"
                                 % (k, tuple(src.shape), tuple(dst.shape)))
            with torch.no_grad():
                dst.copy_(src)
        if self._group2ctx:
            if is_train:
                raise MXNetError(
                    "group2ctx training is not supported by the "
                    "compatibility path (per-op device placement, forward "
                    "only); use mxnet_tpu_torch.parallel tensor/pipeline "
                    "parallelism for model-parallel training")
            return self._forward_grouped()
        if is_train:
            outs, grads = self._run("train", self._train_walk)
            self._pending_grads = dict(zip(self._grad_names(), grads))
            self._trained = True
        else:
            outs = self._run("eval", self._eval_walk)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Write the gradients into ``grad_dict`` by ``grad_req``
        (reference: ``Executor.backward``).  With the default head
        gradient they came with the training forward; explicit
        ``out_grads`` run the training walk again with them."""
        if not self._trained:
            raise MXNetError("backward before forward(is_train=True)")
        if out_grads is None:
            grads = self._pending_grads
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [g._data if isinstance(g, NDArray) else g
                   for g in out_grads]
            _, g = self._train_walk(cts, update_aux=False)
            grads = dict(zip(self._grad_names(), g))
        with torch.no_grad():
            for name, g in grads.items():
                req = self.grad_req.get(name, "null")
                if req == "null" or name not in self.grad_dict:
                    continue
                tgt = self.grad_dict[name]._data
                if req == "add":
                    tgt.add_(g)
                else:
                    tgt.copy_(g)
        self._pending_grads = None
        self._trained = False

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays of the same names."""
        with torch.no_grad():
            for k, v in arg_params.items():
                if k in self.arg_dict:
                    self.arg_dict[k]._data.copy_(v._data)
                elif not allow_extra_params:
                    raise MXNetError("unknown parameter %r" % k)
            for k, v in (aux_params or {}).items():
                if k in self.aux_dict:
                    self.aux_dict[k]._data.copy_(v._data)

    def capture_stats(self):
        """Per mode, the graphs captured, capture seconds, pool bytes
        and replays of the executor's owners."""
        return {mode: owner.stats() for mode, owner in self._owners.items()}
