"""NDArray: the imperative tensor (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

An :class:`NDArray` is a thin wrapper over one ``torch.Tensor`` (its
``_data``), not a subclass: ``size``, ``grad``, ``backward``,
``reshape`` and the ``axis=`` reductions mean MXNet's things here, not
``torch.Tensor``'s.  Every op goes through :func:`invoke` over the op
table (:mod:`mxnet_tpu_torch.ops.table`).

- Operations are recorded for backward only inside
  ``autograd.record()``: outside it ``invoke`` runs under
  ``torch.no_grad()``.  ``attach_grad`` makes the array a leaf; its
  ``grad`` is an NDArray that each backward rebinds (``grad_req``
  ``"write"``) or adds to (``"add"``), see :mod:`..autograd`.
- In-place forms (``+=``, ``a[...] = v``, ``copyto``) write into the
  tensor, so views see them, as in MXNet; inside ``record()`` they are
  refused on an array that requires a gradient.
- Dtypes follow the JAX package with 64-bit types off: numpy float64
  becomes float32 and int64 int32, and so do op results.
- With no ``ctx``, arrays are made on :func:`~..context.current_context`,
  the card unless a ``with mx.cpu():`` scope says otherwise; without
  CUDA that raises.
- :func:`save` and :func:`load` read and write MXNet's ``.params``
  container, byte for byte the JAX package's file.
"""
from __future__ import annotations

import struct
import time
import weakref

import numpy as np
import torch

from .. import autograd
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import Context, current_context
from ..ops.table import OpSpec, canonical, lookup, torch_dtype

__all__ = ["NDArray", "arange", "array", "concat", "concatenate", "empty",
           "full", "invoke", "load", "moveaxis", "ones", "onehot_encode",
           "save", "transpose", "waitall", "zeros"]

_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
              torch.float64: np.float64, torch.int32: np.int32,
              torch.int64: np.int64, torch.int8: np.int8,
              torch.uint8: np.uint8, torch.bool: np.bool_}


def waitall():
    """Block until all work queued on the card has finished (the wait is
    the ``dispatch.host_sync_time`` timer's, the goodput ledger's
    host_sync category, while telemetry is on)."""
    from .. import _capture
    t0 = time.perf_counter() if _telemetry._ENABLED else None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _capture.synchronize()
    if t0 is not None:
        _telemetry.hooks.host_sync("waitall", time.perf_counter() - t0)


def _place(t, ctx):
    """``t`` moved to ``ctx`` (pinned host memory for ``cpu_pinned``,
    when CUDA is there to pin for).  A copy from the host to the card is
    asynchronous; one to the host is not."""
    if ctx.pinned:
        t = t.cpu()
        return t.pin_memory() if torch.cuda.is_available() else t
    return t.to(ctx.torch_device(), non_blocking=t.device.type == "cpu")


def _host_tensor(arr, dtype=None):
    """A CPU tensor holding a copy of the numpy array ``arr`` at
    ``dtype`` (by default ``arr``'s, with 64-bit types narrowed)."""
    tdt = torch_dtype(arr.dtype if dtype is None else dtype)
    if tdt is torch.bfloat16:
        return torch.from_numpy(np.array(arr, np.float32)).to(tdt)
    return torch.from_numpy(np.array(arr, _NP_DTYPES[tdt], order="C"))


def _resolve_ctx(ctx):
    return Context(ctx) if ctx is not None else current_context()


class NDArray:
    """An n-dimensional array on a device context."""

    __slots__ = ("_data", "_grad", "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = _host_tensor(np.asarray(data))
            ctx = _resolve_ctx(ctx)
        if ctx is not None:
            data = _place(data, Context(ctx))
        self._data = data
        self._grad = None

    # -- basic properties ---------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` for bf16, which numpy
        lacks)."""
        np_dt = _NP_DTYPES.get(self._data.dtype)
        return np.dtype(np_dt) if np_dt is not None else self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def context(self):
        return Context.of_tensor(self._data)

    ctx = context

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # -- sync / conversion --------------------------------------------
    def asnumpy(self):
        """A host copy as a numpy array (bf16 as float32); waits for the
        card (timed as a ``host_sync`` while telemetry is on)."""
        if _telemetry._ENABLED:
            t0 = time.perf_counter()
            out = self._host_copy()
            _telemetry.hooks.host_sync("asnumpy", time.perf_counter() - t0)
            return out
        return self._host_copy()

    def _host_copy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("converting an NDArray to numpy always copies")
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("asscalar: array is not scalar-sized")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise MXNetError("len() of 0-d NDArray")
        return self.shape[0]

    def wait_to_read(self):
        from .. import _capture
        t0 = time.perf_counter() if _telemetry._ENABLED else None
        if self._data.is_cuda:
            _capture.synchronize(self._data.device)
        if t0 is not None:
            _telemetry.hooks.host_sync("wait_to_read",
                                       time.perf_counter() - t0)

    wait_to_write = wait_to_read

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return invoke("Cast", [self], {"dtype": dtype})

    def copy(self):
        return invoke("identity", [self], {})

    def copyto(self, other):
        """A copy on a context, or written into the NDArray ``other``."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(
                other.torch_device(), copy=True))
        if isinstance(other, NDArray):
            other._inplace_guard()
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        raise MXNetError("copyto: bad target %r" % (other,))

    def as_in_context(self, ctx):
        """This array if it is on ``ctx``, else a copy there (detached
        unless recording)."""
        ctx = Context(ctx)
        if ctx == self.context:
            return self
        t = self._data if autograd.is_recording() else self._data.detach()
        return NDArray(_place(t, ctx))

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage not supported in this build")
        return self

    # -- autograd ------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf of backward with a zero gradient buffer,
        detached from any graph it was part of (``stype`` is accepted and
        the buffer dense, as in the JAX package)."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError("bad grad_req %r" % (grad_req,))
        t = self._data.detach()
        zeros = torch.zeros_like(t)
        if grad_req != "null":
            t.requires_grad_(True)
            t.grad = zeros
        t._mx_grad_req = grad_req
        t._mx_owner = weakref.ref(self)
        self._data = t
        self._grad = NDArray(zeros)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def _is_tracked(self):
        return self._data.requires_grad

    def _inplace_guard(self):
        # an in-place write to an array in a recorded graph would corrupt
        # the tape
        if autograd.is_recording() and self._is_tracked():
            raise MXNetError(
                "in-place operation on an array that requires grad inside "
                "autograd.record() is not allowed; use out-of-place ops")

    def _write(self, value):
        """Write ``value`` (a tensor of this array's shape) in place."""
        self._inplace_guard()
        if tuple(value.shape) != self.shape:
            raise MXNetError("in-place result of shape %s does not fit an "
                             "array of shape %s" % (tuple(value.shape),
                                                    self.shape))
        with torch.no_grad():
            self._data.copy_(value)
        return self

    # -- indexing ------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            kd = key._data
            if kd.dtype == torch.bool:
                return NDArray(self._data[kd])
            return invoke("take", [self, key], {"axis": 0})
        return NDArray(self._data[_index(key)])

    def __setitem__(self, key, value):
        self._inplace_guard()
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)
        if autograd.is_recording():
            self._data[_index(key)] = value
        else:
            with torch.no_grad():
                self._data[_index(key)] = value

    # -- arithmetic ----------------------------------------------------
    def _binop(self, other, opname, reverse=False):
        if isinstance(other, (int, float, bool, np.number)):
            sop = _SCALAR_OP.get((opname, reverse))
            if sop is not None:
                return invoke(sop, [self], {"scalar": other})
        if isinstance(other, NDArray):
            rhs = other
        else:
            rhs = NDArray(_host_tensor(np.asarray(other), self._data.dtype)
                          .to(self._data.device))
        lhs = self
        if reverse:
            lhs, rhs = rhs, lhs
        return invoke(opname, [lhs, rhs], {})

    def __add__(self, o):
        return self._binop(o, "elemwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod")

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", reverse=True)

    def __matmul__(self, o):
        return invoke("dot", [self, o], {})

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def __eq__(self, o):
        return self._binop(o, "broadcast_equal")

    def __ne__(self, o):
        return self._binop(o, "broadcast_not_equal")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal")

    __hash__ = object.__hash__

    def __iadd__(self, o):
        return self._write(self.__add__(o)._data)

    def __isub__(self, o):
        return self._write(self.__sub__(o)._data)

    def __imul__(self, o):
        return self._write(self.__mul__(o)._data)

    def __itruediv__(self, o):
        return self._write(self.__truediv__(o)._data)

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            np.array2string(self.asnumpy(), precision=4, suppress_small=True),
            "x".join(str(s) for s in self.shape) or "scalar", self.context)

    # -- method forms of ops -------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("Reshape", [self], {"shape": shape, **kwargs})

    def reshape_like(self, other):
        return invoke("reshape_like", [self, other], {})

    def flatten(self):
        return invoke("Flatten", [self], {})

    def transpose(self, axes=None):
        return invoke("transpose", [self], {"axes": axes})

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None):
        return invoke("argmax", [self], {"axis": axis})

    def argmin(self, axis=None):
        return invoke("argmin", [self], {"axis": axis})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return invoke("abs", [self], {})

    def sqrt(self):
        return invoke("sqrt", [self], {})

    def square(self):
        return invoke("square", [self], {})

    def exp(self):
        return invoke("exp", [self], {})

    def log(self):
        return invoke("log", [self], {})

    def sigmoid(self):
        return invoke("sigmoid", [self], {})

    def tanh(self):
        return invoke("tanh", [self], {})

    def relu(self):
        return invoke("relu", [self], {})

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", [self, index], {"axis": axis,
                                              "keepdims": keepdims})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], {"depth": depth, **kw})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", [self], {"axis": axis, "k": k,
                                       "ret_typ": ret_typ,
                                       "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def flip(self, axis):
        return invoke("reverse", [self], {"axis": axis})

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def zeros_like(self):
        return invoke("zeros_like", [self], {})

    def ones_like(self):
        return invoke("ones_like", [self], {})


def _index(key):
    """An NDArray index as tensors (integer ones as int64)."""
    if isinstance(key, NDArray):
        t = key._data
        return t if t.dtype == torch.bool else t.long()
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    return key


# scalar-operand ops of NDArray._binop
_SCALAR_OP = {
    ("elemwise_add", False): "_plus_scalar",
    ("elemwise_add", True): "_plus_scalar",
    ("elemwise_sub", False): "_minus_scalar",
    ("elemwise_sub", True): "_rminus_scalar",
    ("elemwise_mul", False): "_mul_scalar",
    ("elemwise_mul", True): "_mul_scalar",
    ("elemwise_div", False): "_div_scalar",
    ("elemwise_div", True): "_rdiv_scalar",
    ("broadcast_power", False): "_power_scalar",
    ("broadcast_power", True): "_rpower_scalar",
    ("broadcast_mod", False): "_mod_scalar",
    ("broadcast_equal", False): "_equal_scalar",
    ("broadcast_equal", True): "_equal_scalar",
    ("broadcast_not_equal", False): "_not_equal_scalar",
    ("broadcast_not_equal", True): "_not_equal_scalar",
    ("broadcast_greater", False): "_greater_scalar",
    ("broadcast_greater", True): "_lesser_scalar",
    ("broadcast_greater_equal", False): "_greater_equal_scalar",
    ("broadcast_greater_equal", True): "_lesser_equal_scalar",
    ("broadcast_lesser", False): "_lesser_scalar",
    ("broadcast_lesser", True): "_greater_scalar",
    ("broadcast_lesser_equal", False): "_lesser_equal_scalar",
    ("broadcast_lesser_equal", True): "_greater_equal_scalar",
}


# ----------------------------------------------------------------------
# Op dispatch
# ----------------------------------------------------------------------

def _wrap(raw):
    if isinstance(raw, (tuple, list)):
        return [NDArray(canonical(r)) for r in raw]
    return NDArray(canonical(raw))


def invoke(op, tensor_args, kwargs, out=None):
    """Run one op of the table eagerly on NDArrays (reference:
    ``Imperative::Invoke``).  ``op`` is an op name, alias, spec or
    :class:`~mxnet_tpu_torch.ops.registry.Op`.
    Operands that are not NDArrays (numpy arrays, scalars) are placed
    with the NDArray operands; an op that makes a tensor from none runs
    on ``ctx``, by default the current context.  Outside
    ``autograd.record()`` nothing is recorded for backward."""
    spec = op if isinstance(op, OpSpec) else \
        lookup(op) if isinstance(op, str) else op.spec
    if _telemetry._ENABLED:
        _telemetry.hooks.op_dispatch(spec.name)
    params = dict(kwargs)
    params.pop("name", None)
    ctx = params.pop("ctx", None) if spec.creates else None
    for k in params:
        if k not in spec.params:
            raise MXNetError("op %s: unknown argument %r" % (spec.name, k))
    if "training" in spec.params and "training" not in params:
        params["training"] = autograd.is_training()
    device = next((a._data.device for a in tensor_args
                   if isinstance(a, NDArray)), None)
    tensors = []
    for a in tensor_args:
        if isinstance(a, NDArray):
            tensors.append(a._data)
        elif a is None or isinstance(a, torch.Tensor):
            tensors.append(a)
        else:
            if device is None:
                device = current_context().torch_device()
            tensors.append(_host_tensor(np.asarray(a)).to(device))
    if spec.creates:
        params["device"] = _resolve_ctx(ctx).torch_device()
    if autograd.is_recording():
        raw = spec.fn(*tensors, **params)
    else:
        with torch.no_grad():
            raw = spec.fn(*tensors, **params)
    result = _wrap(raw)
    if out is not None:
        src = result[0] if isinstance(result, list) else result
        return out._write(src._data)
    return result


# ----------------------------------------------------------------------
# Creation functions
# ----------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of any array-like on ``ctx`` (float64
    becomes float32 and int64 int32 unless ``dtype`` says otherwise)."""
    ctx = _resolve_ctx(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach().to(
            torch_dtype(dtype or source_array.dtype), copy=True)
        return NDArray(_place(t, ctx))
    arr = np.asarray(source_array)
    return NDArray(_place(_host_tensor(arr, dtype), ctx))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return invoke("_zeros", [], {"shape": shape, "dtype": dtype, "ctx": ctx})


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return invoke("_ones", [], {"shape": shape, "dtype": dtype, "ctx": ctx})


def full(shape, val, ctx=None, dtype="float32"):
    return invoke("_full", [], {"shape": shape, "value": val,
                                "dtype": dtype, "ctx": ctx})


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype, "ctx": ctx})


def moveaxis(data, source, destination):
    return NDArray(torch.movedim(data._data, source, destination))


def onehot_encode(indices, out):
    return invoke("one_hot", [indices], {"depth": out.shape[-1]}, out=out)


def concat(*data, dim=1):
    return invoke("Concat", list(data), {"dim": dim})


def concatenate(arrays, axis=0):
    return invoke("Concat", list(arrays), {"dim": axis})


def transpose(data, axes=None):
    return invoke("transpose", [data], {"axes": axes})


# ----------------------------------------------------------------------
# Serialization: MXNet's .params container (magic numbers
# kMXAPINDArrayListMagic=0x112 and NDARRAY_V2_MAGIC=0xF993FAC9, the
# layout of ``mxnet_tpu/ndarray/ndarray.py :: save``).  bfloat16 has the
# JAX package's flag 100 and is stored as its raw 16-bit patterns.
# ----------------------------------------------------------------------

_LIST_MAGIC = 0x112
_ND_MAGIC = 0xF993FAC9
_BF16_FLAG = 100
_FLAG_TO_NP = {0: np.dtype("float32"), 1: np.dtype("float64"),
               2: np.dtype("float16"), 3: np.dtype("uint8"),
               4: np.dtype("int32"), 5: np.dtype("int8"),
               6: np.dtype("int64")}
_NP_TO_FLAG = {v: k for k, v in _FLAG_TO_NP.items()}


def _host_array(arr):
    """``(flag, C-contiguous numpy array)`` of an NDArray, a tensor or
    a numpy array; bfloat16 comes back as its uint16 bit patterns."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.contiguous().view(torch.int16)
            return _BF16_FLAG, t.cpu().numpy().view(np.uint16)
        a = t.cpu().numpy()
    else:
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":      # ml_dtypes, as JAX gives it
            return _BF16_FLAG, np.array(a, order="C").view(np.uint16)
    try:
        flag = _NP_TO_FLAG[a.dtype]
    except KeyError:
        raise MXNetError("save: dtype %s has no .params flag" % a.dtype) \
            from None
    # np.require, unlike ascontiguousarray, keeps a 0-d array 0-d
    return flag, np.require(a, requirements="C")


def _save_one(f, arr):
    flag, a = _host_array(arr)
    f.write(struct.pack("<IiI", _ND_MAGIC, 0, a.ndim))  # dense storage
    f.write(struct.pack("<%dq" % a.ndim, *a.shape))
    f.write(struct.pack("<iii", 1, 0, flag))            # cpu(0), dtype
    f.write(memoryview(a.reshape(-1)).cast("B"))


def save(fname, data):
    """Write NDArrays, tensors or host numpy arrays -- a list or a
    ``{name: array}`` dict, or one NDArray or tensor -- to ``fname`` in
    the ``.params`` format.  The file is written in place; state
    checkpoints go through :func:`mxnet_tpu_torch.checkpoint.commit` for
    torn-write safety."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data, names = [data], []
    elif isinstance(data, dict):
        names = list(data.keys())
        data = [data[k] for k in names]
    else:
        data, names = list(data), []
    # a serialization primitive writing the path its caller staged;
    # torn-write safety is checkpoint.core.commit's, around it
    with open(fname, "wb") as f:  # mxlint: disable=bare-state-write
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(data)))
        for arr in data:
            _save_one(f, arr)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _read(f, fmt):
    size = struct.calcsize(fmt)
    raw = f.read(size)
    if len(raw) != size:
        raise MXNetError("truncated .params file")
    return struct.unpack(fmt, raw)


def _load_one(f):
    magic, _stype, ndim = _read(f, "<IiI")
    if magic != _ND_MAGIC:
        raise MXNetError("bad NDArray magic 0x%x" % magic)
    shape = _read(f, "<%dq" % ndim)
    _dev_type, _dev_id, flag = _read(f, "<iii")
    if flag == _BF16_FLAG:
        dtype = np.dtype("int16")
    elif flag in _FLAG_TO_NP:
        dtype = _FLAG_TO_NP[flag]
    else:
        raise MXNetError("unknown .params dtype flag %d" % flag)
    a = np.empty(shape, dtype)
    if f.readinto(memoryview(a.reshape(-1)).cast("B")) != a.nbytes:
        raise MXNetError("truncated .params file")
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if flag == _BF16_FLAG else t


def load_tensors(fname):
    """The arrays of a ``.params`` file as CPU tensors at the file's
    dtypes: a ``{name: tensor}`` dict, or a list when the file names
    none."""
    with open(fname, "rb") as f:
        magic, _reserved, count = _read(f, "<QQQ")
        if magic != _LIST_MAGIC:
            raise MXNetError("bad .params magic 0x%x" % magic)
        arrays = [_load_one(f) for _ in range(count)]
        nnames, = _read(f, "<Q")
        names = []
        for _ in range(nnames):
            ln, = _read(f, "<Q")
            raw = f.read(ln)
            if len(raw) != ln:
                raise MXNetError("truncated .params file")
            names.append(raw.decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays


def load(fname, ctx=None):
    """Load a ``.params`` file as NDArrays on ``ctx`` (the current
    context by default); 64-bit arrays become 32-bit, as ``array``
    makes them."""
    ctx = _resolve_ctx(ctx)
    loaded = load_tensors(fname)
    if isinstance(loaded, dict):
        return {k: NDArray(_place(canonical(t), ctx))
                for k, t in loaded.items()}
    return [NDArray(_place(canonical(t), ctx)) for t in loaded]
