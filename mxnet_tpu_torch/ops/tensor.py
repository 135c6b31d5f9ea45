"""Tensor operators: elementwise, broadcast, reduce, shape, indexing,
init and ordering (counterpart of ``mxnet_tpu/ops/tensor.py``).

Plain functions on tensors, entered into the op table behind ``mx.nd``
under the JAX package's names and aliases.  They keep the JAX package's
semantics where PyTorch's differ:

- comparisons and logical ops return the input's dtype, not ``bool``;
- ``broadcast_mod`` is a floor modulo (``torch.remainder``);
- ``argmax``/``argmin`` and the index outputs of ``argsort``/``topk``
  are float32 by default;
- a scalar operand takes the array's dtype (``_plus_scalar`` of an
  int32 array by 2.5 adds 2);
- ``gamma`` is ``exp(gammaln(x))``;
- ``Reshape`` reads MXNet's special codes 0, -1, -2, -3 and -4;
- reductions over no axis return the input; ``mean`` of integers is
  float32.

Shape ops return views where PyTorch does (``Reshape``, ``transpose``,
basic ``slice``), as MXNet's own NDArray does; ``identity`` copies.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import Flatten, pick, slice_axis
from .table import register, torch_dtype

# ----------------------------------------------------------------------
# Elementwise binary (broadcasting).  The broadcast_* names are aliases
# of the elemwise_* ops, as in the JAX package.
# ----------------------------------------------------------------------


def _binary(name, fn, aliases=()):
    def op(lhs, rhs):
        return fn(lhs, rhs)
    op.__name__ = op.__qualname__ = name
    register(name, args=("lhs", "rhs"), aliases=aliases)(op)
    return op


def _as_dtype_of(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


_binary("elemwise_add", torch.add,
        aliases=("broadcast_add", "broadcast_plus", "_plus"))
_binary("elemwise_sub", torch.sub,
        aliases=("broadcast_sub", "broadcast_minus", "_minus"))
_binary("elemwise_mul", torch.mul, aliases=("broadcast_mul", "_mul"))
_binary("elemwise_div", torch.true_divide, aliases=("broadcast_div", "_div"))
_binary("broadcast_mod", torch.remainder, aliases=("_mod",))
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))
_binary("broadcast_hypot", torch.hypot)
_binary("broadcast_equal", _as_dtype_of(torch.eq), aliases=("_equal",))
_binary("broadcast_not_equal", _as_dtype_of(torch.ne),
        aliases=("_not_equal",))
_binary("broadcast_greater", _as_dtype_of(torch.gt), aliases=("_greater",))
_binary("broadcast_greater_equal", _as_dtype_of(torch.ge),
        aliases=("_greater_equal",))
_binary("broadcast_lesser", _as_dtype_of(torch.lt), aliases=("_lesser",))
_binary("broadcast_lesser_equal", _as_dtype_of(torch.le),
        aliases=("_lesser_equal",))
_binary("broadcast_logical_and", _as_dtype_of(torch.logical_and))
_binary("broadcast_logical_or", _as_dtype_of(torch.logical_or))
_binary("broadcast_logical_xor", _as_dtype_of(torch.logical_xor))
_binary("arctan2", torch.atan2)
_binary("ldexp", lambda a, b: a * torch.pow(2.0, b))


# ----------------------------------------------------------------------
# Elementwise unary.
# ----------------------------------------------------------------------

def _unary(name, fn, aliases=()):
    def op(data):
        return fn(data)
    op.__name__ = op.__qualname__ = name
    register(name, aliases=aliases)(op)
    return op


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("rint", torch.round)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("negative", torch.neg)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", F.softsign)
_unary("identity", torch.clone, aliases=("_copy", "stop_gradient_off"))


@register("BlockGrad", aliases=("stop_gradient",))
def BlockGrad(data):
    """Stop gradient flow."""
    return data.detach()


@register("Cast", aliases=("cast",))
def Cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, a_min, a_max)


# scalar forms: the scalar takes the array's dtype
def _sc(data, scalar):
    if data.is_floating_point():
        return float(scalar)
    if data.dtype == torch.bool:
        return bool(scalar)
    return int(scalar)


def _scalar(name, fn, default):
    def op(data, scalar=default):
        return fn(data, scalar)
    op.__name__ = op.__qualname__ = name
    register(name)(op)
    return op


_scalar("_plus_scalar", lambda d, s: d + _sc(d, s), 0.0)
_scalar("_minus_scalar", lambda d, s: d - _sc(d, s), 0.0)
_scalar("_rminus_scalar", lambda d, s: _sc(d, s) - d, 0.0)
_scalar("_mul_scalar", lambda d, s: d * _sc(d, s), 1.0)
_scalar("_div_scalar", lambda d, s: d / _sc(d, s), 1.0)
_scalar("_rdiv_scalar", lambda d, s: _sc(d, s) / d, 1.0)
_scalar("_power_scalar", lambda d, s: d ** _sc(d, s), 1.0)
_scalar("_rpower_scalar", lambda d, s: _sc(d, s) ** d, 1.0)
_scalar("_mod_scalar", lambda d, s: torch.remainder(d, _sc(d, s)), 1.0)
_scalar("_maximum_scalar", lambda d, s: torch.clamp_min(d, _sc(d, s)), 0.0)
_scalar("_minimum_scalar", lambda d, s: torch.clamp_max(d, _sc(d, s)), 0.0)
_scalar("_equal_scalar", lambda d, s: (d == s).to(d.dtype), 0.0)
_scalar("_not_equal_scalar", lambda d, s: (d != s).to(d.dtype), 0.0)
_scalar("_greater_scalar", lambda d, s: (d > s).to(d.dtype), 0.0)
_scalar("_greater_equal_scalar", lambda d, s: (d >= s).to(d.dtype), 0.0)
_scalar("_lesser_scalar", lambda d, s: (d < s).to(d.dtype), 0.0)
_scalar("_lesser_equal_scalar", lambda d, s: (d <= s).to(d.dtype), 0.0)


# ----------------------------------------------------------------------
# Reductions.  MXNet's ``exclude`` reduces over the axes NOT listed.
# ----------------------------------------------------------------------

def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _prod(data, dim, keepdim):
    for d in sorted(dim, reverse=True):
        data = torch.prod(data, dim=d, keepdim=keepdim)
    return data


def _mean(data, dim, keepdim):
    if not data.is_floating_point():
        data = data.float()
    return torch.mean(data, dim=dim, keepdim=keepdim)


def _nanprod(data, dim, keepdim):
    return _prod(torch.where(torch.isnan(data), 1.0, data), dim, keepdim)


def _reduce(name, fn, aliases=()):
    def op(data, axis=None, keepdims=False, exclude=False):
        dim = _norm_axis(axis, data.dim(), exclude)
        if not dim:
            return data
        return fn(data, dim, keepdims)
    op.__name__ = op.__qualname__ = name
    register(name, aliases=aliases)(op)
    return op


_reduce("sum", lambda d, a, k: torch.sum(d, dim=a, keepdim=k),
        aliases=("sum_axis",))
_reduce("mean", _mean)
_reduce("prod", _prod)
_reduce("nansum", lambda d, a, k: torch.nansum(d, dim=a, keepdim=k))
_reduce("nanprod", _nanprod)
_reduce("max", lambda d, a, k: torch.amax(d, dim=a, keepdim=k),
        aliases=("max_axis",))
_reduce("min", lambda d, a, k: torch.amin(d, dim=a, keepdim=k),
        aliases=("min_axis",))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    dim = _norm_axis(axis, data.dim())
    if ord == 1:
        return torch.sum(torch.abs(data), dim=dim, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=dim,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=axis, keepdim=keepdims)
    return out.float()


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("cumsum")
def cumsum(data, axis=None, dtype=None):
    if axis is None:
        data, axis = data.reshape(-1), 0
    return torch.cumsum(data, dim=axis,
                        dtype=torch_dtype(dtype) if dtype else None)


@register("logsumexp")
def logsumexp(data, axis=None, keepdims=False):
    return torch.logsumexp(data, dim=_norm_axis(axis, data.dim()),
                           keepdim=keepdims)


# ----------------------------------------------------------------------
# Matrix and shape ops.
# ----------------------------------------------------------------------

@register("dot", args=("lhs", "rhs"))
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` against the first of
    ``rhs``."""
    if transpose_a:
        lhs = torch.movedim(lhs, 0, -1) if lhs.dim() > 2 else lhs.t()
    if transpose_b:
        rhs = torch.movedim(rhs, -1, 0) if rhs.dim() > 2 else rhs.t()
    return torch.tensordot(lhs, rhs, dims=1)


@register("batch_dot", args=("lhs", "rhs"))
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("transpose")
def transpose(data, axes=None):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


def _mx_reshape_infer(src_shape, target):
    """MXNet's reshape codes: 0 copies this dim, -1 infers one, -2 copies
    all remaining dims, -3 merges two, -4 splits one into the next two
    target values."""
    out = []
    src = list(src_shape)
    target = list(target)
    i = t = 0
    while t < len(target):
        v = target[t]
        if v == 0:
            out.append(src[i])
            i += 1
        elif v == -1:
            out.append(-1)
            i += 1
        elif v == -2:
            out.extend(src[i:])
            i = len(src)
        elif v == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif v == -4:
            a, b = target[t + 1], target[t + 2]
            d = src[i]
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b])
            i += 1
            t += 2
        else:
            out.append(v)
            i += 1
        t += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape: more than one -1 after code expansion")
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def Reshape(data, shape=(), reverse=False):
    if reverse:
        shape = _mx_reshape_infer(data.shape[::-1], list(shape)[::-1])[::-1]
    else:
        shape = _mx_reshape_infer(data.shape, shape)
    return data.reshape(shape)


@register("reshape_like", args=("lhs", "rhs"))
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("shape_array")
def shape_array(data):
    return torch.tensor(list(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, axis if isinstance(axis, int)
                         else tuple(axis))


register("Flatten", aliases=("flatten",))(Flatten)


@register("reverse", aliases=("flip",))
def reverse(data, axis=0):
    return torch.flip(data, (axis,) if isinstance(axis, int)
                      else tuple(axis))


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, (reps,) if isinstance(reps, int)
                      else tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("Pad", aliases=("pad",))
def Pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """N-d padding; ``pad_width`` is MXNet's flat (before, after) per
    axis; modes ``constant``, ``edge`` and ``reflect``."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for b, a in reversed(pw):
            flat += [b, a]
        return F.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: bad mode %r" % (mode,))
    for ax, (b, a) in enumerate(pw):
        if b or a:
            idx = _pad_index(data.shape[ax], b, a, mode, data.device)
            data = torch.index_select(data, ax, idx)
    return data


@register("slice")
def slice_(data, begin=(), end=(), step=()):
    """MXNet ``slice``; ``None`` in begin/end means the full extent, and
    a negative step walks backwards."""
    ndim = data.dim()
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = (list(step) + [None] * (ndim - len(step))) if step \
        else [None] * ndim
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        sl = slice(b, e, s)
        if s is None or s > 0:
            data = data[(slice(None),) * ax + (sl,)]
        else:
            idx = list(range(*sl.indices(data.shape[ax])))
            data = torch.index_select(
                data, ax, torch.tensor(idx, dtype=torch.long,
                                       device=data.device))
    return data


register("slice_axis")(slice_axis)


@register("slice_like", args=("data", "shape_like"))
def slice_like(data, shape_like, axes=()):
    axes = tuple(axes) if axes else tuple(range(data.dim()))
    for a in axes:
        data = data.narrow(a, 0, shape_like.shape[a])
    return data


@register("broadcast_to")
def broadcast_to(data, shape=()):
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like", args=("lhs", "rhs"))
def broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("Concat", variadic=True, aliases=("concat",))
def Concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@register("stack", variadic=True)
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register("split", aliases=("SliceChannel",))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``: a tuple when more than
    one."""
    if data.shape[axis] % num_outputs:
        raise MXNetError("split: axis %d of size %d does not divide into "
                         "%d parts" % (axis, data.shape[axis], num_outputs))
    outs = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs) if num_outputs > 1 else outs[0]


@register("add_n", args=("args",), variadic=True,
          aliases=("ElementWiseSum",))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("where", args=("condition", "x", "y"))
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("diag")
def diag(data, k=0):
    return torch.diag(data, k) if data.dim() <= 2 \
        else torch.diagonal(data, k)


@register("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        dim = tuple(range(1, data.dim()))
    elif mode == "channel":
        dim = (1,)
    else:
        dim = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=dim,
                                       keepdim=True) + eps)


# ----------------------------------------------------------------------
# Indexing.
# ----------------------------------------------------------------------

@register("take", args=("a", "indices"))
def take(a, indices, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis``; indices out of range are clipped
    (``clip``, ``raise``) or wrapped (``wrap``)."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register("pick", args=("data", "index"))(pick)


@register("one_hot", args=("indices",))
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Rows of an identity of size ``depth``; an index out of range
    gives a row of ``off_value``."""
    classes = torch.arange(depth, device=indices.device)
    oh = (indices.long().unsqueeze(-1) == classes).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("gather_nd", args=("data", "indices"))
def gather_nd(data, indices):
    return data[tuple(indices[i].long() for i in range(indices.shape[0]))]


@register("scatter_nd", args=("data", "indices"))
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    idx = tuple(indices[i].long() for i in range(indices.shape[0]))
    return out.index_put(idx, data)


@register("boolean_mask", args=("data", "index"))
def boolean_mask(data, index, axis=0):
    return torch.index_select(data, axis,
                              torch.nonzero(index.bool()).reshape(-1))


def _steps(maxlen, axis, ndim, device):
    shape = [1] * ndim
    shape[axis] = maxlen
    return torch.arange(maxlen, device=device).reshape(shape)


@register("SequenceMask", args=("data", "sequence_length"))
def SequenceMask(data, sequence_length, use_sequence_length=False,
                 value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = _steps(data.shape[axis], axis, data.dim(), data.device)
    lshape = [1] * data.dim()
    lshape[1 - axis] = sequence_length.shape[0]
    mask = steps < sequence_length.reshape(lshape)
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", args=("data", "sequence_length"))
def SequenceLast(data, sequence_length, use_sequence_length=False, axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    idx = sequence_length.long() - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    return data[idx, batch] if axis == 0 else data[batch, idx]


@register("SequenceReverse", args=("data", "sequence_length"))
def SequenceReverse(data, sequence_length, use_sequence_length=False,
                    axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    if axis != 0:
        raise MXNetError("SequenceReverse: only axis=0 (time-major) "
                         "supported")
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[rev, batch]


# ----------------------------------------------------------------------
# Ordering.
# ----------------------------------------------------------------------

@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    if ret_typ not in ("indices", "value", "both"):
        raise MXNetError("topk: ret_typ %r not supported" % (ret_typ,))
    key = torch.movedim(-data if is_ascend else data, axis, -1)
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    vals = torch.gather(torch.movedim(data, axis, -1), -1, idx)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx


# ----------------------------------------------------------------------
# Init ops: no tensor inputs; ``device`` comes from the caller's context.
# ----------------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros", args=())
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                       device=device)


@register("_ones", args=())
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                      device=device)


@register("_full", args=())
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("_eye", args=())
def _eye(N=1, M=0, k=0, dtype="float32", device=None):
    rows = torch.arange(N, device=device)[:, None]
    cols = torch.arange(M or N, device=device)[None, :]
    return (rows + k == cols).to(torch_dtype(dtype))


@register("_arange", args=())
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    if stop is None:
        start, stop = 0, start
    n = max(0, math.ceil((stop - start) / step))
    out = (start + step * torch.arange(n, dtype=torch.float64,
                                       device=device)).to(torch_dtype(dtype))
    return torch.repeat_interleave(out, repeat) if repeat > 1 else out


@register("_linspace", args=())
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              device=None):
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else 0.0
    out = start + step * torch.arange(num, dtype=torch.float64,
                                      device=device)
    if endpoint and num > 1:
        out[-1] = stop
    return out.to(torch_dtype(dtype))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("arange_like")
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    n = data.numel() if axis is None else data.shape[axis]
    shape = data.shape if axis is None else (n,)
    out = start + step * torch.arange(n, device=data.device).to(data.dtype)
    return out.reshape(shape)


# ----------------------------------------------------------------------
# numpy-surface ops.
# ----------------------------------------------------------------------

@register("matmul", args=("a", "b"))
def matmul(a, b):
    return torch.matmul(a, b)


@register("einsum", variadic=True)
def einsum(*operands, subscripts=""):
    return torch.einsum(subscripts, *operands)


@register("tensordot", args=("a", "b"))
def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


@register("isnan")
def isnan(data):
    return torch.isnan(data)


@register("isinf")
def isinf(data):
    return torch.isinf(data)


@register("isfinite")
def isfinite(data):
    return torch.isfinite(data)


def _axis(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@register("_np_var")
def _np_var(data, axis=None, ddof=0, keepdims=False):
    return torch.var(data, dim=_axis(axis), correction=ddof,
                     keepdim=keepdims)


@register("_np_std")
def _np_std(data, axis=None, ddof=0, keepdims=False):
    return torch.std(data, dim=_axis(axis), correction=ddof,
                     keepdim=keepdims)


@register("vstack", variadic=True)
def vstack(*data):
    return torch.vstack(data)


@register("hstack", variadic=True)
def hstack(*data):
    return torch.hstack(data)


@register("dstack", variadic=True)
def dstack(*data):
    return torch.dstack(data)
