"""Gluon Block / HybridBlock (counterpart of
``mxnet_tpu/gluon/block.py``).

A :class:`Block` is a ``torch.nn.Module``: child blocks are its
submodules, ``__call__`` runs ``forward``.  What it adds is MXNet's
naming and parameter management:

- every block has a ``prefix``; an automatic one is the lower-cased
  class name and a per-class counter (``dense0_``, ``dense1_``, ...),
  counted within the enclosing ``name_scope()`` and prefixed with its
  block's prefix, so parameter names are ``resnetv10_conv2d0_weight``
  as in MXNet;
- parameters are :class:`~.parameter.Parameter` objects, created with
  ``self.params.get(...)`` and gathered by ``collect_params()``;
- ``initialize(init, ctx, verbose, force_reinit)`` allocates them on
  the GPU (or the CPU when asked), deferring any whose shape the first
  forward has to infer;
- ``register_forward_pre_hook(hook)`` runs ``hook(block, args)`` before
  each call with the call's own arguments, ``apply(fn)`` runs ``fn`` on
  every descendant and then the block (``torch.nn.Module``'s), and
  ``summary(*inputs)`` prints the reference's table of the direct
  children's outputs and parameter counts.  ``register_forward_hook``
  is ``torch.nn.Module``'s.

A block takes tensors or NDArrays.  Called with an NDArray among its
inputs, it runs on their tensors and returns NDArrays, recording for
backward only inside ``autograd.record()``, as an ``mx.nd`` op does;
called with tensors, it returns tensors.  Under ``npx.set_np()`` the
NDArrays it returns (each one of a list or tuple) are ``mx.np.ndarray``
views, on the eager and the hybridized route alike.

``save_parameters``/``load_parameters`` write and read MXNet's
``.params`` file under structural names (``"0.weight"``).

A :class:`HybridBlock` runs ``hybrid_forward(F, x, **params)`` with
``F`` the port's op namespace (:mod:`mxnet_tpu_torch.ops`).
``hybridize()`` turns on its shape-keyed cache, the counterpart of the
JAX block's ``_call_cached``/``_build_cache``/``_run_cached``: the key
is ``(training, amp.policy_token(), (shape, dtype) of each argument,
device)``, as the JAX ``_CACHE_KEY_STATIC`` plus the device.  On the
CPU an entry is the eager call.  On the card (:mod:`.._capture`) a key's
first call in a mode runs eagerly on the capture stream; the second
captures, and every later call replays:

- when no gradient is recorded (outside ``autograd.record()`` with
  NDArrays; under ``torch.no_grad()`` with tensors), one forward graph;
  its outputs are copies that the next call does not overwrite;
- when one is, a forward graph and a backward graph
  inside **one** ``torch.autograd.Function``, one node on the tape (the
  JAX ``TapeNode(..., name=type(self).__name__ + "_cached")``): the
  backward graph gives the gradients of the inputs and parameters,
  which land in ``.grad`` by each parameter's ``grad_req`` as they do
  eagerly.  The pair has a memory pool of its own and is taken from
  its forward until its backward: a block called again under the same
  ``record()`` before that (a shared block applied twice, a cell in a
  loop) captures another pair, so each call keeps its own activations,
  as the JAX block keeps each call's residuals.

BatchNorm's running statistics update inside the graph (in place).  A
call whose parameters still have deferred shapes runs imperatively and
makes no entry.  A parameter rebound since capture (``load_parameters``
of running statistics, ``cast``) makes the entry capture again.  A
hybridized child inside a hybridized parent (or a ``TrainStep``, a
serving pool) runs its plain forward as part of the owner's program.

Called with symbols (``mx.sym.var``), a block builds a graph in place of
running: a ``HybridBlock`` runs ``hybrid_forward(mx.sym, ...)`` with each
parameter as its variable, which ``export`` writes as ``-symbol.json``
beside a ``.params`` file; :class:`SymbolBlock` runs such a graph back as
a block.

:func:`param_values_from` runs forwards over other tensors than the
parameters' own, in the calling thread only: a servable reads its
snapshot of the weights through it while the same block trains in
another thread.  :meth:`HybridBlock.functionalize` builds on it the JAX
package's pure function over a parameter dict.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
import weakref

import torch

from .. import _capture
from .. import amp as _amp
from .. import autograd
from .. import numpy_extension as _npx
from .. import ops as _ops
from .. import profiler as _profiler
from .. import profiling as _profiling
from .. import random as _random
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd_mod
from ..numpy import _view
from ..symbol.symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, aux_into, shape_is_known)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "param_values_from"]

_naming = threading.local()
_bound = threading.local()

# The fields of a hybridized block's cache key, in order: whether
# autograd records (training), the AMP policy, each argument's shape and
# dtype, and the device (one graph owner a device).  Op params are not
# in it: a captured graph freezes them (analysis.retrace reads this).
_CACHE_KEY_STATIC = ("training", "amp_policy", "shape", "dtype", "device")


@contextlib.contextmanager
def param_values_from(values):
    """Within the scope, in this thread, a block's forward reads
    ``values[p]`` in place of each :class:`Parameter` ``p`` it names
    (others read their own tensor)."""
    prev = getattr(_bound, "values", None)
    _bound.values = values
    try:
        yield
    finally:
        _bound.values = prev


def _naming_state():
    if not hasattr(_naming, "counters"):
        _naming.counters = [{}]
        _naming.prefixes = [""]
    return _naming


class Block(torch.nn.Module):
    """Base container of layers and parameters."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        st = _naming_state()
        if prefix is None:
            # automatic names are scoped: a block made inside a parent's
            # name_scope() gets the parent's prefix prepended
            hint = type(self).__name__.lower()
            counters = st.counters[-1]
            idx = counters.get(hint, 0)
            counters[hint] = idx + 1
            prefix = st.prefixes[-1] + "%s%d_" % (hint, idx)
        object.__setattr__(self, "_prefix", prefix)
        object.__setattr__(self, "_reg_params", {})
        object.__setattr__(self, "_scope_params",
                           ParameterDict(prefix, shared=params))
        object.__setattr__(self, "_mx_pre_hooks", [])

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    @property
    def _children(self):
        """Child blocks in registration order (``torch.nn.Module``'s
        submodules)."""
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self):
        return self._scope_params

    def name_scope(self):
        """Scope in which new blocks are named under this block."""
        @contextlib.contextmanager
        def _scope():
            st = _naming_state()
            st.counters.append({})
            st.prefixes.append(self._prefix)
            try:
                yield self
            finally:
                st.counters.pop()
                st.prefixes.pop()
        return _scope()

    # -- parameter management -----------------------------------------
    def collect_params(self, select=None):
        """All parameters of this block and its descendants, optionally
        those whose name matches the regular expression ``select``."""
        out = ParameterDict(self._scope_params.prefix)
        pattern = re.compile(select) if select else None
        for p in self._all_params():
            if pattern is None or pattern.match(p.name):
                out._params[p.name] = p
        return out

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``"0.weight"``: child keys and
        attribute names), which do not depend on block counters."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def _all_params(self, seen=None):
        seen = seen if seen is not None else set()
        for p in list(self._reg_params.values()) \
                + list(self._scope_params.values()):
            if id(p) not in seen:
                seen.add(id(p))
                yield p
        for child in self._children.values():
            if child is not None:
                yield from child._all_params(seen)

    def cast(self, dtype):
        """Cast every parameter of this block and its descendants to
        ``dtype`` (a subclass may keep its own at another dtype:
        ``BatchNorm`` keeps fp32 below 32 bits).  A captured step that
        read a cast parameter captures again."""
        for child in self._children.values():
            if child is not None:
                child.cast(dtype)
        for p in list(self._reg_params.values()) \
                + list(self._scope_params.values()):
            p.cast(dtype)

    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters to a ``.params`` file under their
        structural names; a parameter whose deferred shape is still
        unknown is left out."""
        arg = {k: p._reduce()
               for k, p in self._collect_params_with_prefix().items()
               if p._data is not None or p._deferred_init is None}
        _nd_mod.save(filename, arg)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a ``.params`` file named structurally
        (``save_parameters``) or by full prefixed names (MXNet's older
        ``collect_params().save``).  A gradient-taking parameter keeps
        its tensor (the value is copied in); one whose shape is still
        deferred takes the file's shape, on ``ctx`` or the device it was
        initialized for."""
        loaded = _nd_mod.load_tensors(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and not any(k in params for k in loaded):
            by_name = {p.name: p for p in params.values()}
            if any(k in by_name for k in loaded):
                params = by_name
        if not ignore_extra:
            for name in loaded:
                if name not in params:
                    raise MXNetError(
                        "parameter %r in file not found in Block; set "
                        "ignore_extra=True to skip" % name)
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(
                        "parameter %r missing from file; set "
                        "allow_missing=True to skip" % name)
        for name, data in loaded.items():
            if name in params:
                params[name]._load(data, ctx, cast_dtype=cast_dtype)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """Initialize every parameter on ``ctx`` (a context; or
        ``device``, the GPU unless the caller passes ``device="cpu"``);
        random initializers draw from ``generator``."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         device=device, generator=generator)

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, args)`` before each call, with the call's
        arguments (reference: ``Block.register_forward_pre_hook``);
        returns ``hook``."""
        self._mx_pre_hooks.append(hook)
        return hook

    def summary(self, *inputs):
        """Run ``inputs`` through the block and return the reference's
        table: each direct child's type, output shape and own parameter
        count, and their total."""
        lines = ["-" * 64,
                 "%-30s %-20s %s" % ("Layer", "Output", "Params"),
                 "=" * 64]
        total = 0

        def hook(block, _args, out):
            nonlocal total
            n = sum(math.prod(p.shape) for p in block._reg_params.values()
                    if p.shape and shape_is_known(p.shape))
            total += n
            shape = tuple(out.shape) if isinstance(out, torch.Tensor) \
                else "-"
            lines.append("%-30s %-20s %d" % (type(block).__name__, shape,
                                             n))

        handles = [child.register_forward_hook(hook)
                   for child in self._children.values()]
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        lines.append("=" * 64)
        lines.append("Total params (direct children): %d" % total)
        return "\n".join(lines)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        for hook in self._mx_pre_hooks:
            hook(self, args)
        if any(isinstance(a, Symbol) for a in args):
            # symbol mode (export): a graph, not a tensor call
            return self._symbolic_call(*args)
        if not any(isinstance(a, NDArray) for a in args + tuple(
                kwargs.values())):
            return self._call_tensors(*args, **kwargs)
        args = [_unwrap(a) for a in args]
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            out = _wrap(self._call_tensors(*args, **kwargs))
        if _npx.is_np_array():
            # npx.set_np(): blocks speak mx.np (reference semantics)
            if isinstance(out, (list, tuple)):
                return type(out)(_view(o) for o in out)
            return _view(out)
        return out

    def _call_tensors(self, *args, **kwargs):
        """The call on tensors: ``torch.nn.Module``'s, which runs
        ``forward``."""
        return torch.nn.Module.__call__(self, *args, **kwargs)

    def _symbolic_call(self, *args):
        """The call on symbols: ``forward`` builds the graph (a
        container's forward calls its children on the symbols)."""
        return self.forward(*args)

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, child in self._children.items():
            lines.append("  (%s): %s" % (name,
                                         repr(child).replace("\n", "\n  ")))
        lines.append(")")
        return "\n".join(lines)


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (tuple, list)):
        # a recurrent layer's or cell's states come as a list
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


class _Pending:
    """The token of a captured forward whose backward has not run: its
    tape node holds it, its graphs keep a weak reference."""

    __slots__ = ("__weakref__",)


class _TrainGraphs:
    """A captured forward and backward of a hybridized block under
    ``autograd.record()``, in a memory pool of their own.  The floating
    inputs and the parameters that take a gradient are what the
    backward graph differentiates.  From a forward's replay until its
    backward has run (or its tape node is gone) the pair is taken: the
    block's next call of the key under ``record`` uses, or captures,
    another pair, so each outstanding call keeps its own activations,
    as the JAX block keeps each call's ``vjp`` residuals."""

    def __init__(self, block, owner, args, watched, diff, what):
        self.inputs = [a.detach().clone().requires_grad_(
            a.is_floating_point()) for a in args]
        self.grad_in = [k for k, s in enumerate(self.inputs)
                        if s.requires_grad]
        self.calls = 0
        self.pending = None
        pool = owner.new_pool()

        def forward():
            with torch.enable_grad():
                return block._plain_call(self.inputs)

        self.fwd, out = owner.capture(forward, what + " forward", watched,
                                      pool)
        self.single = isinstance(out, torch.Tensor)
        self.kind = type(out)
        self.outputs = [out] if self.single else list(out)
        self.live = [o.requires_grad for o in self.outputs]
        heads = [o for o in self.outputs if o.requires_grad]
        self.head_grads = [torch.empty_like(o) for o in heads]
        wrt = [self.inputs[k] for k in self.grad_in] + list(diff)

        def backward():
            return torch.autograd.grad(heads, wrt, self.head_grads,
                                       allow_unused=True)

        self.bwd, self.grads = owner.capture(backward, what + " backward",
                                             watched, pool)

    def free(self):
        """Whether no call waits for this pair's backward."""
        return self.pending is None or self.pending() is None

    def __call__(self, args, diff):
        outs = _ReplayedBlock.apply(self, len(args), *args, *diff)
        return outs[0] if self.single else self.kind(outs)


class _ReplayedBlock(torch.autograd.Function):
    """The tape node of a captured forward: its backward replays the
    backward graph."""

    @staticmethod
    def forward(ctx, graphs, n_args, *tensors):
        for s, a in zip(graphs.inputs, tensors[:n_args]):
            s.copy_(a)
        graphs.fwd.replay()
        graphs.calls += 1
        ctx.graphs, ctx.n_args, ctx.call = graphs, n_args, graphs.calls
        ctx.pending = _Pending()
        graphs.pending = weakref.ref(ctx.pending)
        outs = tuple(o.detach().clone() for o in graphs.outputs)
        ctx.mark_non_differentiable(*[o for o, live in zip(
            outs, graphs.live) if not live])
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        graphs = ctx.graphs
        if graphs.calls != ctx.call:
            raise MXNetError(
                "%s: a backward kept by retain_graph ran after the block's "
                "captured forward replayed for a later call over the "
                "activations it reads" % graphs.fwd.owner.name)
        with torch.no_grad():
            for buf, g in zip(graphs.head_grads, [
                    g for g, live in zip(out_grads, graphs.live) if live]):
                buf.copy_(g)
        graphs.bwd.replay()
        ctx.pending = None
        need = ctx.needs_input_grad[2:]
        n_in = len(graphs.grad_in)
        grads = [None] * ctx.n_args + list(graphs.grads[n_in:])
        for j, k in enumerate(graphs.grad_in):
            grads[k] = graphs.grads[j]
        return (None, None) + tuple(
            None if g is None or not want else g.clone()
            for g, want in zip(grads, need))


class HybridBlock(Block):
    """Block whose forward is ``hybrid_forward(F, *args, **params)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        object.__setattr__(self, "_active", False)
        object.__setattr__(self, "_cached_entries", {})
        object.__setattr__(self, "_graph_owners", {})

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Turn the shape-keyed cache on (or off), clear it and recurse
        (reference: ``HybridBlock.hybridize``; graphs are static in
        shape and memory, so ``static_alloc``/``static_shape`` are kept
        for the API)."""
        object.__setattr__(self, "_active", active)
        object.__setattr__(self, "_cached_entries", {})
        object.__setattr__(self, "_graph_owners", {})
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def cache_stats(self):
        """The cache's keys and, per device, the graphs captured, the
        seconds spent capturing, the bytes the pool took and the
        replays."""
        return {"keys": list(self._cached_entries),
                "graphs": {d: o.stats()
                           for d, o in self._graph_owners.items()}}

    def _call_tensors(self, *args, **kwargs):
        if self._active and args and not kwargs \
                and not _capture.in_body() \
                and all(isinstance(a, torch.Tensor) for a in args):
            return self._call_cached(args)
        return super()._call_tensors(*args, **kwargs)

    def _plain_call(self, args):
        return torch.nn.Module.__call__(self, *args)

    def _call_cached(self, args):
        if not _profiler._scopes_enabled:
            return self._call_keyed(args)
        # the hybridized call as a named range in the profiler's trace
        with _profiler.scope("mx.cachedop:%s" % type(self).__name__):
            return self._call_keyed(args)

    def _call_keyed(self, args):
        params = list(self._all_params())
        if any(p._deferred_init is not None for p in params):
            # the first call sizes deferred parameters imperatively
            return self._plain_call(args)
        device = args[0].device
        # the fields of _CACHE_KEY_STATIC
        key = (autograd.is_training(), _amp.policy_token()) + tuple(
            (tuple(a.shape), _dtype_name(a.dtype)) for a in args) \
            + (str(device),)
        pairs = self._cached_entries.setdefault(key, [])
        owner = self._graph_owners.get(str(device))
        if owner is None:
            owner = self._graph_owners[str(device)] = _capture.GraphOwner(
                "%s(hybridized)" % type(self).__name__, device,
                site="hybrid_cache")
        watched = [p._data for p in params]
        diff = [t for t in watched if t is not None and t.requires_grad]
        what = "%s %r" % (type(self).__name__, key)
        if not (torch.is_grad_enabled() and (
                diff or any(a.requires_grad for a in args))):
            def forward(*xs):
                with torch.no_grad():
                    return self._plain_call(xs)
            return owner.run(("forward",) + key, forward, args, watched,
                             what, self._profile(False, key, watched, args))
        new = owner.is_new(("record",) + key)
        if owner.first_call(("record",) + key):
            return owner.warm(lambda: self._plain_call(args),
                              self._profile(True, key, watched, args), new)
        pair = next((p for p in pairs if p.free()), None)
        if pair is not None and pair.fwd.stale(watched):
            pairs.remove(pair)
            pair = None
        if pair is None:
            pair = _TrainGraphs(self, owner, args, watched, diff, what)
            pairs.append(pair)
        return pair(args, diff)

    def _profile(self, train, key, watched, args):
        """The warm-up's ``mx.profiling`` capture: one CostReport per
        key (``hybrid:<Block>``, ``hybrid:<Block>:train`` for the
        recorded forward), keyed as the cache is; None while profiling
        is off."""
        if not _profiling._ENABLED:
            return None
        name = type(self).__name__
        return ("hybrid:%s%s" % (name, ":train" if train else ""),
                "hybrid_cache", ("hybrid", id(self), train) + key,
                [t for t in watched if t is not None] + list(args))

    def infer_shape(self, *args):
        """Layer-specific deferred-shape rule; layers with deferred
        parameters override it."""
        raise MXNetError("%s: cannot infer parameter shapes; give "
                         "in_units/in_channels or override infer_shape"
                         % type(self).__name__)

    def _infer_and_finish(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            p._finish_deferred_init()

    def _param_values(self, *args):
        """``{name: tensor}`` of this block's own parameters, finishing
        deferred initialization from ``args`` on the first call."""
        try:
            for p in self._reg_params.values():
                p._check_initialized()
        except DeferredInitializationError:
            self._infer_and_finish(*args)
            for p in self._reg_params.values():
                p._check_initialized()
        bound = getattr(_bound, "values", None)
        if bound is not None:
            return {k: bound.get(p, p._data)
                    for k, p in self._reg_params.items()}
        return {k: p._data for k, p in self._reg_params.items()}

    def forward(self, *args):
        return self.hybrid_forward(_ops, *args, **self._param_values(*args))

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def _symbolic_call(self, *args):
        """``hybrid_forward(mx.sym, *args, **params)`` with each
        parameter as its variable (:meth:`Parameter.var`): the graph
        that ``export`` writes.  It bypasses ``torch.nn.Module``'s call,
        the graph cache and the profiler's range.  A block that
        overrides ``forward`` builds the graph in it; a layer whose
        forward needs a tensor's data or shape raises naming itself."""
        if type(self).forward is not HybridBlock.forward:
            return self.forward(*args)
        from .. import symbol as _sym
        params = {k: p.var() for k, p in self._reg_params.items()}
        try:
            return self.hybrid_forward(_sym, *args, **params)
        except (AttributeError, TypeError) as e:
            raise MXNetError("%s: hybrid_forward does not trace to a "
                             "symbol graph: %s" % (type(self).__name__, e)
                             ) from e

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` (the forward traced with ``F =
        mx.sym``) and ``path-%04d.params`` (``arg:``/``aux:`` names);
        returns the two file names."""
        from ..symbol.export import export_block
        return export_block(self, path, epoch)

    def optimize_for(self, x, backend=None, **kwargs):
        """Hybridize and call on ``x`` (the JAX package's: no backend
        graph pass)."""
        self.hybridize()
        return self(x)

    def functionalize(self, training=True):
        """The block's forward as a pure function of its parameters'
        values (the JAX package's ``functionalize``): returns
        ``(pure_fn, param_names, params)``, the names of the initialized
        parameters and ``{name: Parameter}``.

        ``pure_fn(pvals, ivals, rng=None) -> (outs, aux)`` runs the
        forward, in training mode when ``training``, on the tensors
        ``ivals`` with ``pvals[name]`` in place of each of those
        parameters.  ``outs`` is a tuple of tensors; ``aux`` maps a
        parameter's name to the value the call computed for it
        (``BatchNorm``'s running statistics in training).  No
        parameter's tensor is written.  Dropout draws from ``rng``, a
        ``torch.Generator`` on the inputs' device, where the JAX
        package takes a key (``None``: the device's own generator,
        which a CUDA-graph capture registers).  Hybridized blocks inside
        run their forward as code, on the kernels ``block(x)`` runs.
        Autograd differentiates ``outs`` with respect to the tensors of
        ``pvals`` that require a gradient, and :mod:`.._capture` can
        capture the call."""
        params = [p for p in self._all_params() if p._data is not None]
        pmap = {p.name: p for p in params}
        block = self

        def pure_fn(pvals, ivals, rng=None):
            values = {p: _unwrap(pvals[name]) for name, p in pmap.items()}
            aux = {}

            def sink(p, value):
                # later reads in the call see the new value, as the JAX
                # trace's do
                aux[p.name] = values[p] = value

            mode = autograd.train_mode() if training \
                else autograd.predict_mode()
            with param_values_from(values), aux_into(sink), \
                    _random.drawing_from(rng), mode, _capture.body_scope():
                outs = block._plain_call([_unwrap(v) for v in ivals])
            outs = [outs] if isinstance(outs, torch.Tensor) else outs
            return tuple(outs), aux

        return pure_fn, [p.name for p in params], pmap


def _params_on(params, device):
    """``params`` (a ``.params`` file, or ``{name: NDArray, tensor or
    array}``) as tensors, each copied once onto ``device``; the names
    keep their ``arg:``/``aux:`` prefixes (:class:`SymbolBlock` reads
    them)."""
    if isinstance(params, str):
        params = _nd_mod.load_tensors(params)
    out = {}
    for k, v in (params or {}).items():
        v = v._data if isinstance(v, NDArray) else v
        if not isinstance(v, torch.Tensor):
            import numpy as np
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        out[k] = v.detach().to(device)
    return out


class SymbolBlock(HybridBlock):
    """A loaded symbol graph run as a block (counterpart of the JAX
    package's ``SymbolBlock``; reference ``gluon.SymbolBlock``).

    ``outputs`` is the graph, ``inputs`` the names (or variables) of the
    arguments a call binds, in order; ``params`` maps every other
    argument's name to its value (tensors or NDArrays; a name ``aux:``
    prefixed, as an exported file writes a running statistic, is a
    parameter that takes no gradient).  A call walks the graph
    (``_eval_symbol``) over its arguments and the parameters' tensors;
    ``hybridize()`` turns on the shape-keyed cache like any
    ``HybridBlock``: one captured graph a key on the card.  A training
    call uses the batch's statistics and leaves the running statistics
    as they are, as the JAX block does.
    """

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        if isinstance(inputs, (Symbol, str)):
            inputs = [inputs]
        object.__setattr__(self, "_outputs", outputs)
        object.__setattr__(self, "_inputs", [
            s.name if isinstance(s, Symbol) else str(s) for s in inputs])
        for key, arr in (params or {}).items():
            kind, name = key.split(":", 1) if ":" in key else ("", key)
            data = arr._data if isinstance(arr, NDArray) else arr
            if not isinstance(data, torch.Tensor):
                data = torch.as_tensor(data)
            p = Parameter(name, shape=tuple(data.shape),
                          dtype=str(data.dtype).replace("torch.", ""),
                          grad_req="null" if kind == "aux" else "write")
            p._data = p._wrap(data.detach())
            self._reg_params[name] = p
            self._scope_params._params[name] = p

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A ``SymbolBlock`` of ``symbol_file`` and ``param_file`` (an
        exported pair), its parameters copied once onto ``ctx`` (the
        current context by default: the card unless a ``with mx.cpu():``
        is in force)."""
        from ..context import current_context, resolve_device
        from ..symbol import load as sym_load
        device = resolve_device(ctx if ctx is not None
                                else current_context())
        return SymbolBlock(sym_load(symbol_file), input_names,
                           _params_on(param_file, device))

    def forward(self, *args):
        from ..symbol.symbol import _eval_symbol
        # structural: the arguments' types, not their values
        sym = any(isinstance(a, Symbol) for a in args)
        if sym:  # mxlint: disable=tracer-branch
            raise MXNetError("SymbolBlock: composing a loaded graph into "
                             "another symbol graph is not supported")
        feed = dict(self._param_values(*args))
        feed.update(zip(self._inputs, args))
        outs = _eval_symbol(self._outputs, feed)
        return outs[0] if len(outs) == 1 else outs
