"""Gluon Parameter / ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` names one tensor of a block and holds it once it
is initialized: a ``torch.nn.Parameter`` when it takes a gradient
(``grad_req`` ``"write"`` or ``"add"``), a plain tensor otherwise (the
running statistics of ``BatchNorm``).  Its shape may stay unknown until
the first forward (``allow_deferred_init``): the block's
``infer_shape`` fills it and the deferred initialization finishes then,
on the device and with the initializer and generator recorded at
``initialize``.  ``data()`` and ``grad()`` return NDArrays over the
parameter's own tensors (no copy); code of the port reads ``_data``.
A parameter keeps one copy, on one device: the ``ctx`` arguments of the
reference's API (``initialize``, ``data``, ``grad``, ``list_ctx``,
``reset_ctx``) name or move that one copy.  ``initialize`` takes the
reference's positional order, ``(init, ctx, default_init,
force_reinit)``; ``device=`` (a spelling of ``ctx``) and ``generator=``
(the random initializers' :class:`torch.Generator`) are keyword-only.
:class:`Constant` is a parameter that takes no gradient and holds a
given value.  :meth:`ParameterDict.save` and
:meth:`~ParameterDict.load` write and read MXNet's ``.params`` files.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import initializer
from ..base import MXNetError
from ..context import Context, current_context, resolve_device
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd_mod

__all__ = ["Constant", "DeferredInitializationError", "Parameter",
           "ParameterDict", "shape_is_known"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "int32": torch.int32, "uint8": torch.uint8}


_aux_local = threading.local()


@contextlib.contextmanager
def aux_into(sink):
    """Within the scope, in this thread, a layer's auxiliary update
    (:meth:`Parameter._update_aux`) calls ``sink(param, value)`` in
    place of writing the parameter: ``HybridBlock.functionalize``
    returns the updates where the JAX package's trace collects them."""
    prev = getattr(_aux_local, "sink", None)
    _aux_local.sink = sink
    try:
        yield
    finally:
        _aux_local.sink = prev


class DeferredInitializationError(MXNetError):
    """Parameter touched before its deferred shape was inferred."""


def shape_is_known(shape):
    if shape is None:
        return False
    return all(s is not None and s > 0 for s in shape)


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError("unsupported parameter dtype %r" % (dtype,)) \
            from None


def _one_ctx(ctx):
    """The device of ``ctx``: a context, a device spelling, or a list of
    them (the first: a parameter keeps one copy)."""
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0] if ctx else None
    return resolve_device(ctx)


class Parameter:
    """A weight or auxiliary tensor of a Block.

    On a mesh (:mod:`mxnet_tpu_torch.parallel`) ``_sharding`` is its
    :class:`~mxnet_tpu_torch.parallel.NamedSharding`: the tensor is this
    rank's shard of the value (the whole value when replicated), the
    declared ``shape`` the global one.  A full-shaped value given to
    :meth:`set_data` is cut to the shard."""

    _sharding = None    # NamedSharding on a mesh, else None
    _placed = False     # the value was placed on the mesh's ranks

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        # ``stype``/``grad_stype`` are accepted and unused, as in the JAX
        # package: a parameter and its gradient are dense tensors
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = _dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._data = None           # tensor once initialized
        self._deferred_init = None  # (init, device, default_init, generator)

    # -- shape ---------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if shape_is_known(self._shape) and new_shape != self._shape:
            raise MXNetError("cannot reset shape of %s from %s to %s"
                             % (self.name, self._shape, new_shape))
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("bad grad_req %r" % req)
        self._grad_req = req
        if self._data is not None:
            self._data = self._wrap(self._data.detach())

    # -- init ----------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, *, device=None, generator=None):
        """Allocate and fill the tensor on ``ctx`` (or ``device``: the GPU
        unless the caller asks for the CPU), or defer until the shape is
        known."""
        if self._data is not None and not force_reinit:
            return
        device = _one_ctx(device if ctx is None else ctx)
        default_init = default_init or initializer.Uniform()
        if not shape_is_known(self._shape):
            if not self._allow_deferred_init:
                raise MXNetError("cannot initialize %s: shape %s unknown "
                                 "and deferred init not allowed"
                                 % (self.name, self._shape))
            self._data = None
            self._deferred_init = (init, device, default_init, generator)
            return
        self._finish_init(init, device, default_init, generator)

    def _finish_init(self, init, device, default_init, generator):
        ini = initializer.create(init or self.init or default_init)
        data = torch.empty(self._shape, dtype=self.dtype, device=device)
        ini(self.name, data, generator)
        if self._sharding is not None:
            # rank 0's value, then this rank's shard of it
            from ..parallel.tensor_parallel import place_value
            data = place_value(data, self._sharding)
            self._placed = True
        self._data = self._wrap(data)
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not shape_is_known(self._shape):
            raise DeferredInitializationError(
                "parameter %s has unknown shape %s" % (self.name,
                                                       self._shape))
        self._finish_init(*self._deferred_init)

    def _wrap(self, tensor):
        if self._grad_req == "null" or not tensor.is_floating_point():
            # an integer tensor (an int8 op's weight) takes no gradient
            p = tensor
        else:
            p = torch.nn.Parameter(tensor, requires_grad=True)
            p._mx_grad_req = self._grad_req    # read by autograd.backward
        if self._sharding is not None:
            p._mx_sharding = self._sharding
            p._mx_global_shape = self._shape
        return p

    # -- access --------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "parameter %s deferred; forward once or set shape"
                    % self.name)
            raise MXNetError("parameter %s not initialized; call "
                             ".initialize()" % self.name)

    def data(self, ctx=None):
        """The value as an NDArray over the parameter's tensor."""
        self._check_initialized()
        return NDArray(self._data)

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        """The context of the one copy."""
        self._check_initialized()
        return [Context.of_tensor(self._data)]

    def grad(self, ctx=None):
        """The gradient of the last backward as an NDArray over it
        (zeros before the first)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError("parameter %s has grad_req='null'" % self.name)
        g = self._data.grad
        return NDArray(torch.zeros_like(self._data) if g is None else g)

    def list_grad(self):
        return [self.grad()]

    @property
    def grad_or_none(self):
        """:meth:`grad`, or None where there is no gradient (not
        initialized, or ``grad_req="null"``)."""
        if self._data is None or self._grad_req == "null":
            return None
        return self.grad()

    @torch.no_grad()
    def zero_grad(self):
        """Set the gradient to zeros, in place."""
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (a parameter whose initialization is
        deferred will land there)."""
        device = _one_ctx(ctx)
        if self._data is not None:
            self._data = self._wrap(self._data.detach().to(device))
        elif self._deferred_init is not None:
            init, _dev, default_init, generator = self._deferred_init
            self._deferred_init = (init, device, default_init, generator)

    def var(self):
        """The parameter as a variable of a symbol graph
        (``mx.sym.var(name, shape=, dtype=)``), as ``export`` writes
        it."""
        from ..symbol import var
        return var(self.name, shape=self.shape,
                   dtype=str(self.dtype).replace("torch.", ""))

    def _reduce(self):
        """The value to save."""
        return self.data()

    @torch.no_grad()
    def set_data(self, data):
        """Rebind the value, kept at the declared dtype.  A gradient-
        taking parameter is overwritten in place (its tensor stays the
        one the optimizer and autograd hold); an auxiliary one is
        rebound."""
        data = _as_tensor(data)
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError("parameter %s not initialized" % self.name)
            self.shape = data.shape
            self._finish_deferred_init()
        data = self._shard_of(data)
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError("set_data: %s has shape %s, got %s"
                             % (self.name, tuple(self._data.shape),
                                tuple(data.shape)))
        if self._grad_req == "null":
            self._data = data.detach().to(self._data.device, self.dtype)
        else:
            self._data.copy_(data)

    def _shard_of(self, data):
        """This rank's shard of a full-shaped value of a sharded
        parameter (``data`` itself otherwise)."""
        sh = self._sharding
        if sh is None or sh.is_replicated \
                or tuple(data.shape) != tuple(self._shape) \
                or tuple(data.shape) == tuple(self._data.shape):
            return data
        return data[sh.local_slices(data.shape)]

    @torch.no_grad()
    def _update_aux(self, value):
        """Write a layer's new auxiliary value (``BatchNorm``'s running
        statistics) into the parameter's tensor in place, at its dtype:
        a CUDA graph that captured the layer keeps reading and updating
        the same tensor.  A user's :meth:`set_data` still rebinds.
        Inside :func:`aux_into` the value goes to that scope's dict and
        the parameter's tensor is left as it is."""
        sink = getattr(_aux_local, "sink", None)
        if sink is not None:
            sink(self, value.detach())
            return
        rebind = self._data is None \
            or tuple(value.shape) != tuple(self._data.shape) \
            or (self._data.is_inference()
                and not torch.is_inference_mode_enabled())
        if rebind:
            self.set_data(value)
        elif value is not self._data:
            self._data.copy_(value)

    @torch.no_grad()
    def _load(self, data, ctx=None, cast_dtype=False):
        """Take a loaded value.  An initialized parameter goes through
        :meth:`set_data`; one not yet allocated takes the value's shape
        and lands on ``ctx``, else on the device its deferred
        initialization recorded, else on the current context, at its
        declared dtype (the value's own with ``cast_dtype``)."""
        data = _as_tensor(data)
        if self._data is not None:
            self.set_data(data)
            return
        self._shape = tuple(data.shape)
        if self._sharding is not None and not self._sharding.is_replicated:
            data = data[self._sharding.local_slices(data.shape)]
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if ctx is not None:
            device = resolve_device(ctx)
        elif self._deferred_init is not None:
            device = self._deferred_init[1]
        else:
            device = current_context().torch_device()
        if cast_dtype:
            self.dtype = data.dtype
        self._deferred_init = None
        self._data = self._wrap(data.detach().to(device, self.dtype,
                                                 copy=True))

    def cast(self, dtype):
        self.dtype = _dtype(dtype)
        if self._data is not None:
            self._data = self._wrap(self._data.detach().to(self.dtype))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self._shape, self.dtype)


def _as_tensor(data):
    """A tensor from an NDArray, a tensor or an array-like."""
    if isinstance(data, NDArray):
        return data._data
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.array(data, copy=True))


class Constant(Parameter):
    """A parameter that takes no gradient and holds ``value`` (reference:
    ``gluon.Constant``)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = _nd_mod._host_tensor(np.asarray(value))
        self.value = NDArray(value)
        src = value.detach()

        class _CInit(initializer.Initializer):
            def _init_weight(self, _name, arr, _generator):
                arr.copy_(src)

        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """Prefix-scoped dictionary of Parameters; ``get`` creates or
    shares."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full in self._params:
            param = self._params[full]
            shape = kwargs.get("shape")
            if shape is not None and not shape_is_known(param.shape):
                param._shape = (shape,) if isinstance(shape, int) \
                    else tuple(shape)
            return param
        if self._shared is not None and full in self._shared._params:
            self._params[full] = self._shared._params[full]
            return self._params[full]
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def get_constant(self, name, value=None):
        """The :class:`Constant` ``prefix + name``, made from ``value``
        on first use."""
        full = self._prefix + name
        if full not in self._params:
            if value is None:
                raise MXNetError("constant %s has no value" % full)
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        """Add ``other``'s parameters; a name bound to another parameter
        raises."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """Initialize every parameter on ``ctx`` (or ``device``), those
        without an initializer of their own by ``init``."""
        default = initializer.create(init)
        for p in self.values():
            p.initialize(None, ctx, default, force_reinit, device=device,
                         generator=generator)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult``, ...)."""
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to a ``.params`` file under its full
        name, less ``strip_prefix``."""
        arg = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p._reduce()
        _nd_mod.save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set parameters from a ``.params`` file written by
        :meth:`save` (names prefixed with ``restore_prefix``)."""
        loaded = _nd_mod.load_tensors(filename)
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError("parameter %s missing from file" % name)
        for name, data in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("unknown parameter %s in file" % name)
                continue
            self._params[name]._load(data, ctx, cast_dtype=True)
