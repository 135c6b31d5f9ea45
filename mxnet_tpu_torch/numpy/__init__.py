"""``mx.np``: the NumPy-compatible array API (counterpart of
``mxnet_tpu/numpy/__init__.py``; reference ``python/mxnet/numpy/``,
MXNet 2.x's primary interface).

``mx.np.ndarray`` is an ``mx.nd.NDArray``: a view subclass that shares
the tensor and the gradient buffer of the array it was made from, so
the two worlds mix and everything here differentiates.  Each function
runs one op of the port's op table through
:func:`mxnet_tpu_torch.ndarray.invoke`, as ``mx.nd`` does; only names
and semantics are NumPy's (``concatenate``, ``matmul``, ``.T``, NumPy's
default dtypes with 64-bit types narrowed to 32).

Only the functions here and the members of :class:`ndarray` that
override ``NDArray``'s return an ``mx.np.ndarray``; arithmetic,
indexing and the other ``NDArray`` methods return a plain ``NDArray``,
as in the JAX package.  With no ``ctx``, arrays land on the current
context (the card unless a ``with mx.cpu():`` scope says otherwise).
"""
from __future__ import annotations

import numpy as _onp

from ..base import MXNetError
# current_context is in the namespace as in the JAX package's mx.np
from ..context import current_context  # noqa: F401
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd_mod
from ..ops.registry import get_op

__all__ = ["ndarray", "array", "asarray", "zeros", "ones", "empty",
           "full", "eye",
           "arange", "linspace", "concatenate", "stack", "split", "dot",
           "matmul", "tensordot", "einsum", "where", "maximum", "minimum",
           "clip", "abs", "exp", "log", "sqrt", "square", "power", "sum",
           "mean", "var", "std", "prod", "max", "min", "argmax", "argmin",
           "reshape", "transpose", "expand_dims", "squeeze", "tile",
           "repeat", "flip", "cumsum", "isnan", "isinf", "isfinite",
           "sort", "argsort", "take", "vstack", "hstack", "dstack",
           "pi", "e", "inf", "nan", "newaxis", "random"]

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None


class ndarray(NDArray):
    """NumPy-flavoured NDArray view (reference: ``numpy.ndarray`` in
    ``python/mxnet/numpy/multiarray.py``)."""

    __slots__ = ()

    @property
    def T(self):
        return transpose(self)

    def __repr__(self):
        return "array(%s)" % _onp.array2string(self.asnumpy(),
                                               separator=", ")

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _view(super().reshape(shape))

    def item(self):
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    @property
    def size(self):
        return int(_onp.prod(self.shape)) if self.shape else 1

    def copy(self):
        return _view(super().copy())

    def astype(self, dtype):
        return _view(super().astype(dtype))

    def mean(self, axis=None, keepdims=False):
        return mean(self, axis=axis, keepdims=keepdims)

    def sum(self, axis=None, keepdims=False):
        return sum(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return min(self, axis=axis, keepdims=keepdims)


def _view(a):
    """``a`` as an ``mx.np.ndarray`` sharing its tensor and its gradient
    buffer (an ``attach_grad`` after the view is made rebinds only the
    array it is called on); anything else unchanged."""
    if isinstance(a, ndarray):
        return a
    if isinstance(a, NDArray):
        out = ndarray.__new__(ndarray)
        out._data = a._data
        out._grad = a._grad
        return out
    return a


def _views(x):
    if isinstance(x, list):
        return [_view(v) for v in x]
    return _view(x)


def _call(opname, tensor_args, **params):
    return _views(_nd_mod.invoke(get_op(opname), tensor_args, params))


def _shape(shape):
    return tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)


# ----------------------------------------------------------------------
# creation
# ----------------------------------------------------------------------

def array(object, dtype=None, ctx=None):
    """NumPy semantics: ``array()`` copies (``asarray`` shares)."""
    if isinstance(object, NDArray):
        object = object.asnumpy()
    arr = _onp.asarray(object)
    if dtype is None:
        # NumPy's default dtypes, float64 narrowed to float32
        dtype = _onp.float32 if arr.dtype == _onp.float64 else arr.dtype
    return _view(_nd_mod.array(arr, ctx=ctx, dtype=dtype))


def asarray(object, dtype=None, ctx=None):
    """A view when possible: an NDArray shares its tensor and tape."""
    if isinstance(object, NDArray) and dtype is None:
        return _view(object)
    return array(object, dtype=dtype, ctx=ctx)


def zeros(shape, dtype="float32", ctx=None):
    return _view(_nd_mod.zeros(_shape(shape), ctx=ctx, dtype=dtype))


def ones(shape, dtype="float32", ctx=None):
    return _view(_nd_mod.ones(_shape(shape), ctx=ctx, dtype=dtype))


def empty(shape, dtype="float32", ctx=None):
    return zeros(shape, dtype, ctx)


def full(shape, fill_value, dtype="float32", ctx=None):
    return _view(_nd_mod.full(_shape(shape), fill_value, ctx=ctx,
                              dtype=dtype))


def eye(N, M=None, k=0, dtype="float32", ctx=None):
    return array(_onp.eye(N, M, k, dtype=dtype), ctx=ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    return array(_onp.arange(start, stop, step, dtype=dtype), ctx=ctx)


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None):
    return array(_onp.linspace(start, stop, num, endpoint=endpoint,
                               dtype=dtype or _onp.float32), ctx=ctx)


# ----------------------------------------------------------------------
# joining / shaping
# ----------------------------------------------------------------------

def concatenate(seq, axis=0):
    return _call("Concat", list(seq), dim=axis)


def stack(seq, axis=0):
    return _call("stack", list(seq), axis=axis)


def split(ary, indices_or_sections, axis=0):
    if not isinstance(indices_or_sections, int):
        raise MXNetError("mx.np.split supports integer sections")
    outs = _call("split", [ary], num_outputs=indices_or_sections,
                 axis=axis)
    return outs if isinstance(outs, list) else [outs]


def reshape(a, newshape):
    return _view(a.reshape(newshape) if isinstance(a, NDArray)
                 else array(a).reshape(newshape))


def transpose(a, axes=None):
    params = {} if axes is None else {"axes": tuple(axes)}
    return _call("transpose", [a], **params)


def expand_dims(a, axis):
    return _call("expand_dims", [a], axis=axis)


def squeeze(a, axis=None):
    params = {} if axis is None else {"axis": axis}
    return _call("squeeze", [a], **params)


def tile(a, reps):
    return _call("tile", [a], reps=tuple(reps)
                 if isinstance(reps, (list, tuple)) else (reps,))


def repeat(a, repeats, axis=None):
    params = {"repeats": repeats}
    if axis is not None:
        params["axis"] = axis
    return _call("repeat", [a], **params)


def flip(a, axis=None):
    if axis is None:
        # NumPy semantics: flip every axis
        axis = tuple(range(len(a.shape)))
    return _call("flip", [a], axis=axis)


# ----------------------------------------------------------------------
# math (generated thin wrappers over ops of the table)
# ----------------------------------------------------------------------

def _unary_fn(opname, npname=None):
    def fn(a):
        return _call(opname, [a])
    fn.__name__ = npname or opname
    return fn


abs = _unary_fn("abs")
exp = _unary_fn("exp")
log = _unary_fn("log")
log2 = _unary_fn("log2")
log10 = _unary_fn("log10")
sqrt = _unary_fn("sqrt")
square = _unary_fn("square")
sin = _unary_fn("sin")
cos = _unary_fn("cos")
tan = _unary_fn("tan")
tanh = _unary_fn("tanh")
sign = _unary_fn("sign")
floor = _unary_fn("floor")
ceil = _unary_fn("ceil")
isnan = _unary_fn("isnan")
isinf = _unary_fn("isinf")
isfinite = _unary_fn("isfinite")
negative = _unary_fn("negative")


def power(a, b):
    if isinstance(b, (int, float)):
        return _call("_power_scalar", [a], scalar=float(b))
    return _call("broadcast_power", [a, b])


def maximum(a, b):
    if isinstance(b, (int, float)):
        return _call("_maximum_scalar", [a], scalar=float(b))
    return _call("broadcast_maximum", [a, b])


def minimum(a, b):
    if isinstance(b, (int, float)):
        return _call("_minimum_scalar", [a], scalar=float(b))
    return _call("broadcast_minimum", [a, b])


def clip(a, a_min, a_max):
    return _call("clip", [a], a_min=a_min, a_max=a_max)


def where(condition, x, y):
    return _call("where", [condition, x, y])


def dot(a, b):
    return _call("dot", [a, b])


def matmul(a, b):
    return _call("matmul", [a, b])


def tensordot(a, b, axes=2):
    return _call("tensordot", [a, b], axes=axes)


def einsum(subscripts, *operands):
    return _call("einsum", list(operands), subscripts=subscripts)


def _reduce_fn(opname, npname):
    def fn(a, axis=None, keepdims=False):
        params = {"keepdims": keepdims}
        if axis is not None:
            params["axis"] = axis
        return _call(opname, [a], **params)
    fn.__name__ = npname
    return fn


sum = _reduce_fn("sum", "sum")
mean = _reduce_fn("mean", "mean")
prod = _reduce_fn("prod", "prod")
max = _reduce_fn("max", "max")
min = _reduce_fn("min", "min")


def var(a, axis=None, ddof=0, keepdims=False):
    params = {"ddof": ddof, "keepdims": keepdims}
    if axis is not None:
        params["axis"] = axis
    return _call("_np_var", [a], **params)


def std(a, axis=None, ddof=0, keepdims=False):
    params = {"ddof": ddof, "keepdims": keepdims}
    if axis is not None:
        params["axis"] = axis
    return _call("_np_std", [a], **params)


def argmax(a, axis=None):
    params = {} if axis is None else {"axis": axis}
    return _call("argmax", [a], **params)


def argmin(a, axis=None):
    params = {} if axis is None else {"axis": axis}
    return _call("argmin", [a], **params)


def cumsum(a, axis=None):
    params = {} if axis is None else {"axis": axis}
    return _call("cumsum", [a], **params)


def sort(a, axis=-1):
    return _call("sort", [a], axis=axis)


def argsort(a, axis=-1):
    return _call("argsort", [a], axis=axis)


def take(a, indices, axis=None):
    idx = indices if isinstance(indices, NDArray) else array(indices)
    if axis is None:
        # NumPy semantics: take from the flattened array; out-of-range
        # indices clip (as the JAX package's static-shape gather does)
        # where NumPy raises
        a = reshape(a, (-1,))
        axis = 0
    return _call("take", [a, idx], axis=axis)


def vstack(seq):
    return _call("vstack", list(seq))


def hstack(seq):
    return _call("hstack", list(seq))


def dstack(seq):
    return _call("dstack", list(seq))


# ----------------------------------------------------------------------
# random (reference: python/mxnet/numpy/random.py), drawn from the
# port's generator of the array's device (mxnet_tpu_torch.random)
# ----------------------------------------------------------------------

class _Random:
    @staticmethod
    def seed(s):
        from .. import random as rnd
        rnd.seed(s)

    @staticmethod
    def uniform(low=0.0, high=1.0, size=None, ctx=None):
        from ..ndarray import random as nd_random
        return _view(nd_random.uniform(low, high, shape=_size(size),
                                       ctx=ctx))

    @staticmethod
    def normal(loc=0.0, scale=1.0, size=None, ctx=None):
        from ..ndarray import random as nd_random
        return _view(nd_random.normal(loc, scale, shape=_size(size),
                                      ctx=ctx))

    @staticmethod
    def randint(low, high=None, size=None, ctx=None):
        from ..ndarray import random as nd_random
        if high is None:
            low, high = 0, low
        return _view(nd_random.randint(low, high, shape=_size(size),
                                       ctx=ctx))

    @staticmethod
    def rand(*shape):
        return _Random.uniform(size=shape)

    @staticmethod
    def randn(*shape):
        return _Random.normal(size=shape)


def _size(size):
    return () if size is None else _shape(size)


random = _Random()
