"""The port's imperative NDArray API (``mxnet_tpu_torch.nd``) against the
JAX package's ``mx.nd`` on the CPU: the behaviour of
``tests/test_ndarray.py`` (save/load excepted: not ported yet), one case
per op name and alias of the port's op table (the optimizer update ops
excepted: ``tests/test_torch_optimizer_ops.py`` holds them) with the same
numpy inputs through both, and the list of the JAX package's tensor and
random op names the port still lacks.

Tolerance: 1e-5 relative and 1e-6 absolute, the JAX tests' own
``assert_almost_equal`` rtol; dtypes and shapes must be equal.  Random
ops draw from other generators in the two packages: 20,000 draws each,
means and standard deviations within 5 standard errors of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import OP_REGISTRY

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import table

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.asnumpy() if isinstance(got, mx.nd.NDArray) else got
    want = want.asnumpy() if isinstance(want, jmx.nd.NDArray) else want
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# -- tests/test_ndarray.py, on the port --------------------------------

def test_creation():
    a = mx.nd.zeros((2, 3))
    assert a.shape == (2, 3) and a.dtype == np.float32
    b = mx.nd.ones((4,), dtype="int32")
    assert b.dtype == np.int32
    c = mx.nd.array([[1, 2], [3, 4]])
    _close(c, np.array([[1, 2], [3, 4]], np.float32))
    assert c.dtype == jmx.nd.array([[1, 2], [3, 4]]).dtype == np.int32
    d = mx.nd.full((2, 2), 7.0)
    assert d.asnumpy().ravel().tolist() == [7, 7, 7, 7]
    e = mx.nd.arange(0, 10, 2)
    assert e.asnumpy().tolist() == [0, 2, 4, 6, 8]
    assert mx.nd.empty((3,)).shape == (3,)


def test_float64_downcast():
    a = mx.nd.array(np.zeros((2, 2), dtype=np.float64))
    assert a.dtype == np.float32
    assert mx.nd.array(np.arange(3, dtype=np.int64)).dtype == np.int32


def test_arithmetic():
    a = mx.nd.array([[1., 2.], [3., 4.]])
    b = mx.nd.array([[10., 20.], [30., 40.]])
    _close(a + b, [[11, 22], [33, 44]])
    _close(b - a, [[9, 18], [27, 36]])
    _close(a * 2 + 1, [[3, 5], [7, 9]])
    _close(1 / a, [[1, .5], [1 / 3, .25]])
    _close(a ** 2, [[1, 4], [9, 16]])
    _close(-a, [[-1, -2], [-3, -4]])
    _close(2 ** a, [[2, 4], [8, 16]])
    _close(a % 3, [[1, 2], [0, 1]])
    _close(abs(-a), a.asnumpy())


def test_inplace_ops():
    a = mx.nd.ones((2, 2))
    view = a.reshape((4,))
    a += 1
    _close(a, np.full((2, 2), 2.0))
    a *= 3
    _close(a, np.full((2, 2), 6.0))
    a /= 2
    _close(a, np.full((2, 2), 3.0))
    a -= 1
    _close(a, np.full((2, 2), 2.0))
    _close(view, np.full((4,), 2.0))     # in place, as in MXNet


def test_indexing():
    a = mx.nd.array(np.arange(12).reshape(3, 4))
    _close(a[1], np.arange(4, 8))
    _close(a[0:2, 1], np.array([1, 5]))
    idx = mx.nd.array([0, 2], dtype="int32")
    _close(a[idx], np.arange(12).reshape(3, 4)[[0, 2]])
    mask = mx.nd.array([1, 0, 1]).astype("bool")
    _close(a[mask], np.arange(12).reshape(3, 4)[[0, 2]])


def test_setitem():
    a = mx.nd.zeros((3, 3))
    a[1] = 5.0
    assert a.asnumpy()[1].tolist() == [5, 5, 5]
    a[0, 0] = 1.0
    assert a.asnumpy()[0, 0] == 1
    a[:] = 2.0
    assert (a.asnumpy() == 2).all()
    b = mx.nd.ones((3,))
    a[2] = b * 4
    assert a.asnumpy()[2].tolist() == [4, 4, 4]


def test_setitem_on_a_leaf_that_requires_grad():
    x = mx.nd.ones((3,))
    x.attach_grad()
    x[1] = 7.0                           # outside record: allowed
    assert x.asnumpy().tolist() == [1, 7, 1]
    with mx.autograd.record():
        with pytest.raises(MXNetError, match="in-place"):
            x[0] = 2.0
        with pytest.raises(MXNetError, match="in-place"):
            x += 1
        y = (x * 2).sum()
    y.backward()
    assert x.grad.asnumpy().tolist() == [2, 2, 2]


def test_shape_methods():
    a = mx.nd.array(np.arange(24).reshape(2, 3, 4))
    assert a.reshape(6, 4).shape == (6, 4)
    assert a.reshape((-1, 4)).shape == (6, 4)
    assert a.reshape(0, -1).shape == (2, 12)
    assert a.transpose().shape == (4, 3, 2)
    assert a.transpose((0, 2, 1)).shape == (2, 4, 3)
    assert a.flatten().shape == (2, 12)
    assert a.expand_dims(0).shape == (1, 2, 3, 4)
    assert a.swapaxes(0, 2).shape == (4, 3, 2)
    assert a.T.shape == (4, 3, 2)
    assert a.size == 24 and a.ndim == 3 and len(a) == 2


@pytest.mark.parametrize("shape,codes,reverse", [
    ((2, 3, 4), (0, -3), False), ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (-4, 1, 2, 0, 0), False), ((2, 3, 4), (-1, 0), True),
    ((2, 3, 4), (4, -1), False), ((6, 4), (-4, 2, -1, -2), False)])
def test_mxnet_reshape_codes(shape, codes, reverse):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = jmx.nd.array(x).reshape(codes, reverse=reverse)
    got = mx.nd.array(x).reshape(codes, reverse=reverse)
    assert got.shape == want.shape
    _close(got, want)


def test_reductions():
    a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert a.sum().asscalar() == 15
    _close(a.sum(axis=0), [3, 5, 7])
    _close(a.mean(axis=1), [1, 4])
    assert a.max().asscalar() == 5
    assert a.min().asscalar() == 0
    assert a.argmax(axis=1).asnumpy().tolist() == [2, 2]
    assert a.argmax(axis=1).dtype == np.float32
    _close(a.norm(), np.sqrt((np.arange(6) ** 2).sum()), rtol=1e-4)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "prod"])
def test_reduce_exclude_and_int_dtypes(op):
    x = np.arange(1, 25, dtype=np.int32).reshape(2, 3, 4) % 5 + 1
    for kw in ({"axis": 1, "exclude": True}, {"axis": (0, 2)}, {}):
        want = getattr(jmx.nd, op)(jmx.nd.array(x), **kw)
        got = getattr(mx.nd, op)(mx.nd.array(x), **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want)


def test_comparison():
    a = mx.nd.array([1., 2., 3.])
    b = mx.nd.array([2., 2., 2.])
    assert (a == b).asnumpy().tolist() == [0, 1, 0]
    assert (a > b).asnumpy().tolist() == [0, 0, 1]
    assert (a <= b).asnumpy().tolist() == [1, 1, 0]
    assert (a == b).dtype == np.float32
    assert (a < 2).asnumpy().tolist() == [1, 0, 0]
    assert (2 < a).asnumpy().tolist() == [0, 0, 1]


def test_scalar_takes_the_arrays_dtype():
    x = np.array([1, 2, 3], np.int32)
    for name in ("_plus_scalar", "_mul_scalar", "_minus_scalar"):
        want = getattr(jmx.nd, name)(jmx.nd.array(x), scalar=2.5)
        got = getattr(mx.nd, name)(mx.nd.array(x), scalar=2.5)
        assert got.dtype == want.dtype == np.int32
        assert got.asnumpy().tolist() == want.asnumpy().tolist()


def test_scalar_conversion():
    assert float(mx.nd.array([3.5])) == 3.5
    assert int(mx.nd.array([3])) == 3
    assert mx.nd.array([[7.0]]).asscalar() == 7.0
    with pytest.raises(MXNetError):
        mx.nd.ones((2, 2)).asscalar()


def test_copy_context():
    a = mx.nd.ones((2, 2), ctx=mx.cpu())
    assert a.context == mx.cpu(0)
    b = a.copy()
    b[:] = 0
    assert (a.asnumpy() == 1).all()
    c = a.as_in_context(mx.cpu(0))
    assert c is a
    d = mx.nd.zeros((2, 2))
    a.copyto(d)
    assert (d.asnumpy() == 1).all()
    e = a.copyto(mx.cpu())
    assert e is not a and (e.asnumpy() == 1).all()


def test_asnumpy_is_a_copy():
    a = mx.nd.ones((3,))
    h = a.asnumpy()
    h[0] = 9
    assert a.asnumpy().tolist() == [1, 1, 1]
    src = np.zeros(3, np.float32)
    b = mx.nd.array(src)
    src[0] = 5
    assert b.asnumpy().tolist() == [0, 0, 0]


def test_astype():
    a = mx.nd.ones((2,), dtype="float32")
    assert a.astype("int32").dtype == np.int32
    assert a.astype(np.float16).dtype == np.float16
    assert a.astype("float32", copy=False) is a


def test_concat_stack():
    a, b = mx.nd.ones((2, 3)), mx.nd.zeros((2, 3))
    assert mx.nd.concat(a, b, dim=0).shape == (4, 3)
    assert mx.nd.concat(a, b, dim=1).shape == (2, 6)
    assert mx.nd.stack(a, b, axis=0).shape == (2, 2, 3)
    assert mx.nd.concatenate([a, b]).shape == (4, 3)


def test_waitall():
    a = mx.nd.ones((8, 8))
    for _ in range(5):
        a = mx.nd.dot(a, a)
    mx.nd.waitall()
    a.wait_to_read()


def test_out_and_unknown_argument():
    a = mx.nd.array([[1., -2.], [3., 4.]])
    out = mx.nd.zeros((2, 2))
    res = mx.nd.abs(a, out=out)
    assert res is out and out.asnumpy().tolist() == [[1, 2], [3, 4]]
    with pytest.raises(MXNetError, match="unknown argument"):
        mx.nd.sum(a, axes=0)
    # parameters positionally after the tensor arguments, as generated
    _close(mx.nd.sum(a, 1), jmx.nd.sum(jmx.nd.array(a.asnumpy()), 1))


def test_array_without_a_context_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx_stack = mx.Context._default_ctx.stack
    saved = list(ctx_stack)
    ctx_stack.clear()
    try:
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.current_context()
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.nd.array([1.0, 2.0])
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.nd.zeros((2,))
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.nd.array([1.0], ctx=mx.gpu())
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.nd.NDArray(np.ones(3))
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.nd.NDArray([1.0, 2.0])
        assert mx.nd.array([1.0], ctx=mx.cpu()).context == mx.cpu()
        assert mx.nd.NDArray(np.ones(3), ctx=mx.cpu()).context == mx.cpu()
        assert mx.num_gpus() == 0
    finally:
        ctx_stack.extend(saved)


def test_context_stack():
    assert mx.current_context() == mx.cpu()
    with mx.cpu_pinned():
        assert mx.current_context() == mx.cpu_pinned()
    assert mx.current_context() == mx.cpu()
    assert repr(mx.gpu(1)) == "gpu(1)" and mx.gpu(0) != mx.cpu(0)
    assert {mx.cpu(): 1}[mx.Context("cpu", 0)] == 1


# -- every op name and alias against the JAX package -------------------

def _u(*shape, lo=-2.0, hi=2.0, seed=0):
    rng = np.random.RandomState(seed + len(shape))
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _ints(*shape, hi=3, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape) \
        .astype(np.float32)


def _spd(b, n):
    a = _u(b, n, n)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def _lower(b, n):
    return np.tril(_u(b, n, n)) + 3 * np.eye(n, dtype=np.float32)


def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


def _boxes(*shape, seed=0):
    xy = _u(*shape, 2, lo=0.0, hi=6.0, seed=seed)
    return np.concatenate([xy, xy + _u(*shape, 2, lo=0.5, hi=4.0,
                                       seed=seed + 1)], axis=-1)


_RANGES = [np.float32(v) for v in (-2.0, 1.5, -0.5, 0.75, -1.0, 1.0)]
_ROIS = np.array([[0, 0, 0, 14, 14], [1, 2, 4, 9, 13], [0, 5, 3, 6, 4]],
                 np.float32)
POS = dict(lo=0.5, hi=3.0)
UNIT = dict(lo=-0.9, hi=0.9)
HALVES = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7]],
                  np.float32)
SEQ = _u(5, 3, 2), np.array([2, 5, 3], np.float32)
NANS = np.array([[1.0, np.nan, 2.0], [np.inf, -1.0, -np.inf]], np.float32)

UNARY_DOMAINS = {
    "sqrt": POS, "rsqrt": POS, "log": POS, "log10": POS, "log2": POS,
    "gamma": POS, "gammaln": POS, "reciprocal": POS, "rcbrt": POS,
    "log1p": dict(lo=-0.5, hi=2.0), "arcsin": UNIT, "arccos": UNIT,
    "arctanh": UNIT, "erfinv": UNIT, "arccosh": dict(lo=1.1, hi=3.0)}
ROUNDING = ("rint", "round", "ceil", "floor", "trunc", "fix")

# canonical op name -> (numpy inputs, parameters)
SPECS = {
    "broadcast_mod": ([_u(3, 4, lo=-3, hi=3), np.sign(_u(1, 4)) *
                       _u(1, 4, **POS)], {}),
    "broadcast_power": ([_u(3, 4, **POS), _u(3, 4, lo=-2, hi=2, seed=1)],
                        {}),
    "ldexp": ([_u(3, 4), _ints(3, 4, hi=5) - 2], {}),
    "BlockGrad": ([_u(3, 4)], {}),
    "Cast": ([_u(3, 4, lo=-3, hi=3)], {"dtype": "int32"}),
    "clip": ([_u(3, 4)], {"a_min": -1.0, "a_max": 0.5}),
    "_power_scalar": ([_u(3, 4, **POS)], {"scalar": 1.5}),
    "_rpower_scalar": ([_u(3, 4)], {"scalar": 2.0}),
    "_mod_scalar": ([_u(3, 4, lo=-3, hi=3)], {"scalar": 1.5}),
    "_div_scalar": ([_u(3, 4)], {"scalar": 1.5}),
    "_rdiv_scalar": ([_u(3, 4, **POS)], {"scalar": 1.5}),
    "sum": ([_u(2, 3, 4)], {"axis": (0, 2), "keepdims": True}),
    "mean": ([_u(2, 3, 4)], {"axis": 1}),
    "prod": ([_u(2, 3, 4, lo=0.7, hi=1.3)], {"axis": (1, 2)}),
    "nansum": ([NANS[:, :2]], {"axis": 1}),
    "nanprod": ([np.where(np.isnan(_u(3, 4) - 1.9), np.nan, _u(3, 4))],
                {"axis": 0}),
    "max": ([_u(2, 3, 4)], {"axis": 2, "exclude": True}),
    "min": ([_u(2, 3, 4)], {}),
    "norm": ([_u(3, 4)], {"ord": 2, "axis": 1}),
    "argmax": ([_u(3, 4)], {"axis": 1}),
    "argmin": ([_u(3, 4)], {"axis": 0, "keepdims": True}),
    "cumsum": ([_u(3, 4)], {"axis": 1}),
    "logsumexp": ([_u(3, 4)], {"axis": 1, "keepdims": True}),
    "dot": ([_u(4, 3), _u(4, 5)], {"transpose_a": True}),
    "batch_dot": ([_u(2, 3, 4), _u(2, 5, 4)], {"transpose_b": True}),
    "transpose": ([_u(2, 3, 4)], {"axes": (1, 0, 2)}),
    "swapaxes": ([_u(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "Reshape": ([_u(2, 3, 4)], {"shape": (0, -1)}),
    "reshape_like": ([_u(2, 3, 4), _u(6, 4)], {}),
    "shape_array": ([_u(2, 3, 4)], {}),
    "size_array": ([_u(2, 3, 4)], {}),
    "expand_dims": ([_u(2, 3)], {"axis": 1}),
    "squeeze": ([_u(2, 1, 4)], {"axis": 1}),
    "Flatten": ([_u(2, 3, 4)], {}),
    "reverse": ([_u(3, 4)], {"axis": 1}),
    "tile": ([_u(2, 3)], {"reps": (2, 1)}),
    "repeat": ([_u(2, 3)], {"repeats": 2, "axis": 0}),
    "Pad": ([_u(1, 1, 3, 4)], {"mode": "reflect",
                               "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "slice": ([_u(3, 4, 5)], {"begin": (0, 1, 4), "end": (2, None, 0),
                              "step": (1, 2, -1)}),
    "slice_axis": ([_u(3, 4)], {"axis": 1, "begin": 1, "end": 3}),
    "slice_like": ([_u(3, 4), _u(2, 3)], {}),
    "broadcast_to": ([_u(1, 4)], {"shape": (3, 0)}),
    "broadcast_like": ([_u(1, 4), _u(3, 4)], {}),
    "broadcast_axis": ([_u(1, 4)], {"axis": 0, "size": 3}),
    "Concat": ([_u(2, 3), _u(2, 2, seed=1)], {"dim": 1}),
    "stack": ([_u(2, 3), _u(2, 3, seed=1)], {"axis": 1}),
    "split": ([_u(4, 6)], {"num_outputs": 3, "axis": 1}),
    "add_n": ([_u(2, 3), _u(2, 3, seed=1), _u(2, 3, seed=2)], {}),
    "where": ([_ints(3, 4, hi=2), _u(3, 4), _u(3, 4, seed=1)], {}),
    "diag": ([_u(4, 4)], {"k": 1}),
    "L2Normalization": ([_u(2, 3, 4)], {"mode": "instance"}),
    "take": ([_u(5, 3), np.array([[0, 4], [7, -1]], np.float32)], {}),
    "pick": ([_u(3, 4), np.array([0, 3, 1], np.float32)], {"axis": 1}),
    "one_hot": ([np.array([0, 2, 5, 1], np.float32)], {"depth": 4}),
    "gather_nd": ([_u(3, 4), np.array([[0, 2], [1, 3]], np.float32)], {}),
    "scatter_nd": ([np.array([1.0, 2.0], np.float32),
                    np.array([[0, 2], [1, 3]], np.float32)],
                   {"shape": (3, 4)}),
    "boolean_mask": ([_u(4, 3), np.array([1, 0, 1, 1], np.float32)], {}),
    "SequenceMask": (list(SEQ), {"use_sequence_length": True,
                                 "value": -1.0}),
    "SequenceLast": (list(SEQ), {"use_sequence_length": True}),
    "SequenceReverse": (list(SEQ), {"use_sequence_length": True}),
    "sort": ([_u(3, 4)], {"axis": 1, "is_ascend": False}),
    "argsort": ([_u(3, 4)], {"axis": 1, "is_ascend": False}),
    "topk": ([_u(3, 5)], {"k": 2, "ret_typ": "both"}),
    "_zeros": ([], {"shape": (2, 3)}),
    "_ones": ([], {"shape": (2, 3), "dtype": "int32"}),
    "_full": ([], {"shape": (2, 3), "value": 2.5}),
    "_eye": ([], {"N": 3, "M": 4, "k": 1}),
    "_arange": ([], {"start": 1, "stop": 7, "step": 1.5}),
    "_linspace": ([], {"start": 0, "stop": 1, "num": 5, "endpoint": False}),
    "zeros_like": ([_u(2, 3)], {}),
    "ones_like": ([_u(2, 3)], {}),
    "full_like": ([_u(2, 3)], {"fill_value": 3.0}),
    "arange_like": ([_u(2, 3)], {"start": 1.0, "step": 0.5}),
    "matmul": ([_u(2, 3, 4), _u(4, 5)], {}),
    "einsum": ([_u(2, 3), _u(3, 4)], {"subscripts": "ij,jk->ik"}),
    "tensordot": ([_u(2, 3, 4), _u(3, 4, 5)], {"axes": 2}),
    "isnan": ([NANS], {}),
    "isinf": ([NANS], {}),
    "isfinite": ([NANS], {}),
    "_np_var": ([_u(3, 4)], {"axis": 1, "ddof": 1}),
    "_np_std": ([_u(3, 4)], {"axis": 1, "ddof": 1}),
    "Activation": ([_u(3, 4)], {"act_type": "softrelu"}),
    "Convolution": ([_u(2, 3, 6, 6), _u(4, 3, 3, 3), _u(4)],
                    {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}),
    "FullyConnected": ([_u(2, 5), _u(3, 5), _u(3)], {"num_hidden": 3}),
    "Pooling": ([_u(2, 3, 6, 6)], {"kernel": (2, 2), "stride": (2, 2),
                                   "pool_type": "avg"}),
    "Dropout": ([_u(3, 4)], {"p": 0.5}),
    # the fused RNN op of the symbolic slice (every mode, gradients and
    # dropout in tests/test_torch_rnn.py): lstm, T 5, N 2, input 3, 4 wide
    "RNN": ([_u(5, 2, 3), 0.3 * _u(144), _u(1, 2, 4), _u(1, 2, 4)],
            {"state_size": 4, "num_layers": 1, "mode": "lstm"}),
    "Embedding": ([np.array([[0, 2], [1, 3]], np.float32), _u(4, 5)],
                  {"input_dim": 4, "output_dim": 5}),
    "LayerNorm": ([_u(2, 3, 4), _u(4, **POS), _u(4)], {}),
    "log_softmax": ([_u(3, 4)], {"axis": 1}),
    "softmax": ([_u(3, 4)], {"axis": 0}),
    "softmax_cross_entropy": ([_u(3, 4), np.array([0, 3, 1], np.float32)],
                              {}),
    # the layer ops of the layer slice (forward here; gradients, every
    # option and the regression outputs in tests/test_torch_nd_layer_ops.py)
    "BatchNorm": ([_u(2, 3, 4, 4), _u(3, **POS), _u(3), _u(3),
                   _u(3, **POS)], {"fix_gamma": False}),
    "fused_batch_norm_relu": ([_u(2, 4, 4, 3), _u(3, **POS), _u(3), _u(3),
                               _u(3, **POS)], {"axis": 3,
                                               "fix_gamma": False}),
    "BilinearResize2D": ([_u(2, 3, 4, 5)], {"height": 7, "width": 3}),
    "UpSampling": ([_u(2, 3, 4, 5)], {"scale": 2}),
    "Deconvolution": ([_u(2, 3, 4, 4), _u(3, 2, 3, 3), _u(2)],
                      {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                       "adj": (1, 1), "num_filter": 2, "no_bias": False}),
    "InstanceNorm": ([_u(2, 3, 4, 4), _u(3, **POS), _u(3)], {}),
    "GroupNorm": ([_u(2, 4, 3, 3), _u(4, **POS), _u(4)],
                  {"num_groups": 2}),
    "LeakyReLU": ([_u(3, 4)], {"act_type": "elu", "slope": 0.3}),
    "_prelu": ([_u(3, 4), _u(4)], {}),
    "softmin": ([_u(3, 4)], {"axis": 0}),
    "smooth_l1": ([_u(3, 4)], {"scalar": 1.5}),
    "moments": ([_u(2, 3, 4)], {"axes": (0, 2)}),
    "MakeLoss": ([_u(3, 4)], {"grad_scale": 2.0}),
    "SoftmaxOutput": ([_u(3, 4), np.array([0, 3, 1], np.float32)], {}),
    "im2col": ([_u(2, 3, 5, 5)], {"kernel": (2, 2), "stride": (1, 2)}),
    "col2im": ([_u(2, 12, 8)], {"output_size": (5, 5), "kernel": (2, 2),
                                "stride": (1, 2)}),
    "CTCLoss": ([_u(6, 2, 4), np.array([[1, 2], [3, -1]], np.float32)],
                {}),
    "flash_attention": ([_u(2, 5, 4), _u(2, 5, 4, seed=1),
                         _u(2, 5, 4, seed=2)], {"causal": True}),
    "flash_attention_masked": ([_u(2, 5, 4), _u(2, 5, 4, seed=1),
                                _u(2, 5, 4, seed=2),
                                np.tril(np.ones((1, 5, 5), np.float32))],
                               {"heads": 2}),
    # the linalg, interleaved-matmul, int8, box and ROI ops
    "linalg_gemm": ([_u(2, 3, 4), _u(2, 4, 5, seed=1), _u(2, 3, 5, seed=2)],
                    {"alpha": 2.0, "beta": 0.5}),
    "linalg_gemm2": ([_u(3, 4), _u(5, 4, seed=1)],
                     {"transpose_b": True, "alpha": 1.5}),
    "linalg_potrf": ([_spd(2, 4)], {}),
    "linalg_potri": ([_lower(2, 4)], {}),
    "linalg_trsm": ([_lower(2, 4), _u(2, 3, 4, seed=1)],
                    {"rightside": True, "transpose": True, "alpha": 2.0}),
    "linalg_trmm": ([_u(2, 4, 4), _u(2, 4, 3, seed=1)],
                    {"lower": False, "transpose": True}),
    "linalg_syrk": ([_u(2, 3, 4)], {"transpose": True, "alpha": 0.5}),
    "linalg_sumlogdiag": ([_spd(2, 4)], {}),
    "linalg_extractdiag": ([_u(2, 4, 4)], {"offset": 1}),
    "linalg_makediag": ([_u(2, 3)], {"offset": -1}),
    "linalg_extracttrian": ([_u(2, 4, 4)], {"offset": -1, "lower": False}),
    "linalg_maketrian": ([_u(2, 10)], {"lower": False}),
    "linalg_inverse": ([_spd(2, 4)], {}),
    "linalg_det": ([_spd(2, 3)], {}),
    "linalg_slogdet": ([_u(2, 3, 3) + 2 * np.eye(3, dtype=np.float32)], {}),
    "interleaved_matmul_selfatt_qk": ([_u(5, 2, 24)], {"heads": 2}),
    "interleaved_matmul_selfatt_valatt": ([_u(5, 2, 24), _u(4, 5, 5)],
                                          {"heads": 2}),
    "interleaved_matmul_encdec_qk": ([_u(3, 2, 8), _u(5, 2, 16, seed=1)],
                                     {"heads": 2}),
    "interleaved_matmul_encdec_valatt": ([_u(5, 2, 16), _u(4, 3, 5)],
                                         {"heads": 2}),
    "quantize_v2": ([_u(3, 4)], {"min_calib_range": -1.5,
                                 "max_calib_range": 1.2}),
    "quantize": ([_u(3, 4), np.float32(-1.5), np.float32(1.0)], {}),
    "dequantize": ([_i8(3, 4), np.float32(-1.5), np.float32(1.0)], {}),
    "requantize": ([_i8(3, 4).astype(np.int32) * 90, np.float32(-3.0),
                    np.float32(2.0)], {}),
    "quantized_fully_connected": (
        [_i8(3, 8), _i8(4, 8, seed=1), _i8(4, seed=2)] + _RANGES,
        {"num_hidden": 4, "no_bias": False}),
    "quantized_conv": (
        [_i8(2, 3, 5, 5), _i8(4, 3, 3, 3, seed=1), _i8(4, seed=2)]
        + _RANGES, {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4,
                    "no_bias": False}),
    "quantized_pooling": ([_i8(2, 3, 4, 4), np.float32(-1.0),
                           np.float32(2.0)],
                          {"kernel": (2, 2), "stride": (2, 2),
                           "pool_type": "avg"}),
    "box_iou": ([_boxes(3), _boxes(2, seed=1)], {"format": "corner"}),
    "box_nms": ([np.concatenate([_ints(2, 6, 1, hi=2), _u(2, 6, 1, lo=0.0,
                                                       hi=1.0),
                                 _boxes(2, 6)], axis=-1)],
                {"overlap_thresh": 0.3, "valid_thresh": 0.1}),
    "ROIPooling": ([_u(2, 3, 8, 8), _ROIS], {"pooled_size": (2, 3),
                                             "spatial_scale": 0.5}),
    "ROIAlign": ([_u(2, 3, 8, 8), _ROIS], {"pooled_size": (3, 2),
                                           "spatial_scale": 0.5}),
}
RANDOM = {
    "_random_uniform": ([], {"low": -1.0, "high": 3.0, "shape": (20000,)}),
    "_random_normal": ([], {"loc": 1.0, "scale": 2.0, "shape": (20000,)}),
    "_random_gamma": ([], {"alpha": 2.0, "beta": 1.5, "shape": (20000,)}),
    "_random_exponential": ([], {"lam": 2.0, "shape": (20000,)}),
    "_random_poisson": ([], {"lam": 3.0, "shape": (20000,)}),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.4,
                                       "shape": (20000,)}),
    "_random_randint": ([], {"low": -2, "high": 5, "shape": (20000,)}),
    "_sample_multinomial": ([np.array([0.1, 0.2, 0.7], np.float32)],
                            {"shape": 20000}),
    "_shuffle": ([np.arange(20000, dtype=np.float32)], {}),
    "_sample_unique_zipfian": ([], {"range_max": 50, "shape": (20000,)}),
    "_random_uniform_like": ([np.zeros(20000, np.float32)],
                             {"low": 2.0, "high": 4.0}),
    "_random_normal_like": ([np.zeros(20000, np.float32)],
                            {"loc": -1.0, "scale": 0.5}),
}


def _default_spec(spec):
    """Inputs for an elementwise op with no entry in SPECS."""
    if spec.name in ROUNDING:
        return [HALVES], {}
    if spec.args == ("lhs", "rhs"):
        if "equal" in spec.name or "logical" in spec.name \
                or "greater" in spec.name or "lesser" in spec.name:
            return [_ints(3, 4), _ints(1, 4, seed=1)], {}
        return [_u(3, 4), _u(1, 4, seed=1)], {}
    if spec.name == "logical_not":
        return [_ints(3, 4)], {}
    if spec.name.endswith("_scalar"):
        if "equal" in spec.name or "greater" in spec.name \
                or "lesser" in spec.name:
            return [_ints(3, 4)], {"scalar": 1.0}
        return [_u(3, 4)], {"scalar": 1.5}
    if spec.name.startswith("_") or len(spec.args) != 1 or spec.params:
        raise KeyError(spec.name)
    return [_u(3, 4, **UNARY_DOMAINS.get(spec.name, {}))], {}


def _inputs(name):
    spec = table.lookup(name)
    if spec.name in SPECS:
        return SPECS[spec.name]
    if spec.name in RANDOM:
        return RANDOM[spec.name]
    return _default_spec(spec)


def _jax_op(name, inputs, params):
    """The JAX package's ``mx.nd.<name>`` on ``inputs``; an op whose
    output shape depends on its data, or (``linalg_maketrian``) on a
    traced value, cannot run through that package's eager jit, so its
    compute function runs directly."""
    if name in ("boolean_mask", "linalg_maketrian"):
        return jmx.nd.NDArray(OP_REGISTRY[name].fcompute(
            *[jnp.asarray(x) for x in inputs], **params))
    return getattr(jmx.nd, name)(*[jmx.nd.array(x) for x in inputs],
                                 **params)


def _outputs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


# the optimizer update ops have their own cases:
# tests/test_torch_optimizer_ops.py; so do the regression outputs, whose
# JAX ops fail in their own forward (tests/test_torch_nd_layer_ops.py)
REGRESSION_OUTPUTS = ("LinearRegressionOutput", "LogisticRegressionOutput",
                      "MAERegressionOutput")
# eigen- and singular vectors are fixed up to a sign each, which LAPACK
# and XLA choose their own ways: tests/test_torch_linalg.py holds them
SIGN_FREE = ("linalg_syevd", "linalg_svd")
TENSOR_OPS = [n for n in table.names()
              if not table.lookup(n).fn.__module__.endswith(".optimizer_ops")
              and n not in REGRESSION_OUTPUTS + SIGN_FREE]


@pytest.mark.parametrize("name", TENSOR_OPS)
def test_op_matches_the_jax_package(name):
    spec = table.lookup(name)
    inputs, params = _inputs(name)
    want = _outputs(_jax_op(name, inputs, params))
    got = _outputs(getattr(mx.nd, name)(
        *[mx.nd.array(x) for x in inputs], **params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if spec.name not in RANDOM:
            _close(g, w)
            continue
        gv, wv = g.asnumpy().astype(np.float64), w.asnumpy().astype(
            np.float64)
        if spec.name == "_shuffle":
            assert sorted(gv.tolist()) == sorted(wv.tolist())
            assert (gv != wv).any()
            continue
        se = max(wv.std(), 1e-3) / np.sqrt(wv.size)
        assert abs(gv.mean() - wv.mean()) < 5 * se * np.sqrt(2), name
        assert abs(gv.std() - wv.std()) < 5 * se * np.sqrt(2) * 1.5, name


def test_the_port_names_every_tensor_and_random_op():
    """The JAX package's names in ``ops/tensor.py`` and
    ``ops/random_ops.py`` that the port lacks: none may be missing
    unless listed here."""
    later = set()
    jax_names = {n for n, op in OP_REGISTRY.items()
                 if op.fcompute.__module__ in ("mxnet_tpu.ops.tensor",
                                               "mxnet_tpu.ops.random_ops")}
    assert len(jax_names) > 200
    assert jax_names - set(table.names()) == later
    assert all(hasattr(mx.nd, n) for n in jax_names - later)


@pytest.mark.parametrize("sampler,kwargs", [
    ("uniform", {"low": 1.0, "high": 2.0}),
    ("normal", {"loc": -1.0, "scale": 3.0}),
    ("gamma", {"alpha": 2.0, "beta": 0.5}),
    ("exponential", {"scale": 2.0}),
    ("poisson", {"lam": 4.0}),
    ("negative_binomial", {"k": 2, "p": 0.5}),
    ("randint", {"low": 0, "high": 10})])
def test_nd_random_samplers_match_the_jax_package(sampler, kwargs):
    mx.random.seed(3)
    got = getattr(mx.nd.random, sampler)(shape=(20000,), **kwargs)
    want = getattr(jmx.nd.random, sampler)(shape=(20000,), **kwargs)
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.asnumpy().astype(np.float64), want.asnumpy().astype(
        np.float64)
    se = w.std() / np.sqrt(w.size)
    assert abs(g.mean() - w.mean()) < 5 * se * np.sqrt(2)
    assert got.context == mx.cpu()


def test_nd_random_seed_repeats_draws():
    mx.random.seed(7)
    a = mx.nd.random.normal(shape=(5,)).asnumpy()
    b = mx.nd.random.randn(5).asnumpy()
    mx.random.seed(7)
    assert (mx.nd.random.normal(shape=(5,)).asnumpy() == a).all()
    assert (mx.nd.random.randn(5).asnumpy() == b).all()
    x = mx.nd.array(np.arange(6, dtype=np.float32))
    assert sorted(mx.nd.random.shuffle(x).asnumpy().tolist()) == \
        list(range(6))
    m = mx.nd.random.multinomial(mx.nd.array([[0.0, 1.0], [1.0, 0.0]]))
    assert m.asnumpy().tolist() == [1, 0] and m.dtype == np.int32
    assert mx.nd.random.uniform_like(x).shape == (6,)
    assert mx.nd.random.normal_like(x).shape == (6,)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_modes(mode):
    x = _u(1, 2, 3, 4)
    kw = dict(mode=mode, pad_width=(0, 0, 0, 0, 2, 1, 1, 3),
              constant_value=0.5)
    _close(mx.nd.Pad(mx.nd.array(x), **kw),
           jmx.nd.Pad(jmx.nd.array(x), **kw))
