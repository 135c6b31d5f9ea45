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
- ``initialize()`` allocates them on the GPU (or the CPU when asked),
  deferring any whose shape the first forward has to infer.

A block takes tensors or NDArrays.  Called with an NDArray among its
inputs, it runs on their tensors and returns NDArrays, recording for
backward only inside ``autograd.record()``, as an ``mx.nd`` op does;
called with tensors, it returns tensors.

``save_parameters``/``load_parameters`` write and read MXNet's
``.params`` file under structural names (``"0.weight"``).

A :class:`HybridBlock` runs ``hybrid_forward(F, x, **params)`` with
``F`` the port's op namespace (:mod:`mxnet_tpu_torch.ops`).  The port
runs eagerly: ``hybridize()`` is accepted and records its flag.
"""
from __future__ import annotations

import contextlib
import re
import threading

import torch

from .. import autograd
from .. import ops as _ops
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd_mod
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]

_naming = threading.local()


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

    def initialize(self, init=None, device=None, force_reinit=False,
                   generator=None, ctx=None):
        """Initialize every parameter on ``device`` (the GPU unless the
        caller passes ``device="cpu"``; ``ctx``, a context, is MXNet's
        spelling of it); random initializers draw from ``generator``."""
        self.collect_params().initialize(init, device if ctx is None
                                         else ctx, force_reinit,
                                         generator=generator)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in args + tuple(
                kwargs.values())):
            return super().__call__(*args, **kwargs)
        args = [_unwrap(a) for a in args]
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return _wrap(super().__call__(*args, **kwargs))

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, child in self._children.items():
            lines.append("  (%s): %s" % (name,
                                         repr(child).replace("\n", "\n  ")))
        lines.append(")")
        return "\n".join(lines)


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


class HybridBlock(Block):
    """Block whose forward is ``hybrid_forward(F, *args, **params)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        object.__setattr__(self, "_active", False)

    def hybridize(self, active=True, **kwargs):
        """Record the flag (the port runs eagerly; graph capture is
        later work) and recurse."""
        object.__setattr__(self, "_active", active)
        super().hybridize(active, **kwargs)

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
        return {k: p._data for k, p in self._reg_params.items()}

    def forward(self, *args):
        return self.hybrid_forward(_ops, *args, **self._param_values(*args))

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
