"""The port's NumPy front end (``mxnet_tpu_torch.np``/``npx``) against the
JAX package's ``mx.np``/``mx.npx`` on the CPU: one case per name of
``mxnet_tpu.numpy.__all__``, per name that ``_unary_fn`` generates
beside them, per ``npx`` function and per member of ``mx.np.ndarray``,
each with the same numpy inputs through both packages; the cases of
``tests/test_numpy_api.py`` on the port; and the slice as a whole: a
narrow BERT under ``npx.set_np()`` fed ``mx.np`` arrays, its masked-LM
and next-sentence losses written with ``npx.log_softmax``, ``npx.pick``
and ``np.mean``,
forward, backward and two ``Trainer("adam")`` steps against the JAX
package with its kernel tier armed (``MXNET_TPU_KERNELS=1``: flash
attention and LayerNorm as Pallas kernels in interpret mode).

Each case compares values, dtype, shape and the result's type (an
``mx.np.ndarray`` or a plain ``NDArray``).  Tolerance: 1e-5 relative
and 1e-6 absolute, the JAX tests' ``assert_almost_equal``; sorts and
arg-ops exactly.  Random draws come from other generators in the two
packages: 20,000 each, means and standard deviations within 5 standard
errors.  The BERT slice is held to ``tests/test_torch_bert.py``'s
tolerances: forward outputs 1e-5 absolute, losses 1e-5 relative,
gradients and weights 2e-4 relative / 2e-6 absolute, but for the key
third of each ``qkv_bias``, whose exact gradient is 0 (softmax ignores
a shift of a row's scores): Adam turns the rounding noise there into a
step of either sign, so those weights are held within lr a step of
their start (the rule of ``tests/test_torch_bert_pretrain.py``).
"""
import math

import jax
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu import numpy as jnp_mod
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.kernels import registry

np, npx = mx.np, mx.npx
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _inputs(seed=0):
    rng = onp.random.default_rng(seed)
    pos = rng.uniform(0.5, 1.5, (3, 4)).astype(onp.float32)
    pos2 = rng.uniform(0.5, 1.5, (3, 4)).astype(onp.float32)
    sym = rng.uniform(-1.0, 1.0, (3, 4)).astype(onp.float32)
    # distinct values a row, so sorts and arg-ops have no ties
    perm = onp.stack([rng.permutation(4) for _ in range(3)]).astype(
        onp.float32) + onp.arange(3, dtype=onp.float32)[:, None] * 0.25
    odd = onp.array([[1.0, onp.nan, -onp.inf], [onp.inf, 0.0, -2.0]],
                    onp.float32)
    return {"pos": pos, "pos2": pos2, "sym": sym, "perm": perm, "odd": odd,
            "cond": pos > 1.0, "ints": onp.arange(6, dtype=onp.int64),
            "mat": rng.uniform(-1, 1, (4, 5)).astype(onp.float32),
            "cube": rng.uniform(-1, 1, (2, 3, 4)).astype(onp.float32)}


def _arr(m, a):
    """``a`` as the package's ``mx.np`` array."""
    return m.np.array(a)


# each case: (function of the package ``m`` and the inputs ``X``, exact)
NP_CASES = {
    "ndarray": (lambda m, X: m.np.ndarray.__mro__[1].__name__, True),
    "array": (lambda m, X: [m.np.array(X["pos"]), m.np.array(X["ints"]),
                            m.np.array(X["cond"]),
                            m.np.array([[1, 2], [3, 4]]),
                            m.np.array(X["pos"], dtype="int32")], True),
    "asarray": (lambda m, X: [m.np.asarray(m.nd.array(X["pos"])),
                              m.np.asarray([1.5, 2.5]),
                              m.np.asarray(m.nd.array(X["pos"]),
                                           dtype="float16")], True),
    "zeros": (lambda m, X: [m.np.zeros((2, 3)),
                            m.np.zeros(4, dtype="int32")], True),
    "ones": (lambda m, X: [m.np.ones((2, 3)), m.np.ones(4)], True),
    "empty": (lambda m, X: [m.np.empty((2, 3)).shape], True),
    "full": (lambda m, X: [m.np.full((2, 3), 7.5),
                           m.np.full(3, 2, dtype="int32")], True),
    "eye": (lambda m, X: [m.np.eye(3), m.np.eye(3, 4, k=1)], True),
    "arange": (lambda m, X: [m.np.arange(6), m.np.arange(2, 8, 2),
                             m.np.arange(0.0, 1.0, 0.25)], True),
    "linspace": (lambda m, X: [m.np.linspace(0, 1, 5),
                               m.np.linspace(-2, 2, 4, endpoint=False)],
                 False),
    "concatenate": (lambda m, X: [m.np.concatenate(
        [_arr(m, X["pos"]), _arr(m, X["sym"])], axis=1)], True),
    "stack": (lambda m, X: [m.np.stack([_arr(m, X["pos"]),
                                        _arr(m, X["sym"])], axis=1)], True),
    "split": (lambda m, X: m.np.split(_arr(m, X["pos"]), 2, axis=1)
              + m.np.split(_arr(m, X["cube"]), 3, axis=1), True),
    "dot": (lambda m, X: [m.np.dot(_arr(m, X["pos"]), _arr(m, X["mat"]))],
            False),
    "matmul": (lambda m, X: [m.np.matmul(_arr(m, X["pos"]),
                                         _arr(m, X["mat"]))], False),
    "tensordot": (lambda m, X: [
        m.np.tensordot(_arr(m, X["pos"]), _arr(m, X["sym"]),
                       axes=([1], [1])),
        m.np.tensordot(_arr(m, X["pos"]), _arr(m, X["sym"]), axes=2)],
        False),
    "einsum": (lambda m, X: [m.np.einsum("ij,kj->ik", _arr(m, X["pos"]),
                                         _arr(m, X["sym"]))], False),
    "where": (lambda m, X: [m.np.where(_arr(m, X["cond"]),
                                       _arr(m, X["pos"]),
                                       _arr(m, X["sym"]))], True),
    "maximum": (lambda m, X: [m.np.maximum(_arr(m, X["pos"]), 1.0),
                              m.np.maximum(_arr(m, X["pos"]),
                                           _arr(m, X["pos2"]))], True),
    "minimum": (lambda m, X: [m.np.minimum(_arr(m, X["pos"]), 1.0),
                              m.np.minimum(_arr(m, X["pos"]),
                                           _arr(m, X["pos2"]))], True),
    "clip": (lambda m, X: [m.np.clip(_arr(m, X["sym"]), -0.5, 0.25)], True),
    "power": (lambda m, X: [m.np.power(_arr(m, X["pos"]), 2),
                            m.np.power(_arr(m, X["pos"]), 0.5),
                            m.np.power(_arr(m, X["pos"]),
                                       _arr(m, X["pos2"]))], False),
    "sum": (lambda m, X: [m.np.sum(_arr(m, X["pos"])),
                          m.np.sum(_arr(m, X["pos"]), axis=1),
                          m.np.sum(_arr(m, X["cube"]), axis=(0, 2),
                                   keepdims=True)], False),
    "mean": (lambda m, X: [m.np.mean(_arr(m, X["pos"])),
                           m.np.mean(_arr(m, X["pos"]), axis=0,
                                     keepdims=True)], False),
    "var": (lambda m, X: [m.np.var(_arr(m, X["pos"])),
                          m.np.var(_arr(m, X["pos"]), axis=1, ddof=1)],
            False),
    "std": (lambda m, X: [m.np.std(_arr(m, X["pos"])),
                          m.np.std(_arr(m, X["pos"]), axis=0,
                                   keepdims=True)], False),
    "prod": (lambda m, X: [m.np.prod(_arr(m, X["pos"])),
                           m.np.prod(_arr(m, X["pos"]), axis=1)], False),
    "max": (lambda m, X: [m.np.max(_arr(m, X["perm"])),
                          m.np.max(_arr(m, X["perm"]), axis=1)], True),
    "min": (lambda m, X: [m.np.min(_arr(m, X["perm"])),
                          m.np.min(_arr(m, X["perm"]), axis=0,
                                   keepdims=True)], True),
    "argmax": (lambda m, X: [m.np.argmax(_arr(m, X["perm"])),
                             m.np.argmax(_arr(m, X["perm"]), axis=1)], True),
    "argmin": (lambda m, X: [m.np.argmin(_arr(m, X["perm"])),
                             m.np.argmin(_arr(m, X["perm"]), axis=0)], True),
    "reshape": (lambda m, X: [m.np.reshape(_arr(m, X["pos"]), (4, 3)),
                              m.np.reshape(X["pos"], (-1,))], True),
    "transpose": (lambda m, X: [m.np.transpose(_arr(m, X["cube"])),
                                m.np.transpose(_arr(m, X["cube"]),
                                               (1, 0, 2))], True),
    "expand_dims": (lambda m, X: [m.np.expand_dims(_arr(m, X["pos"]), 1)],
                    True),
    "squeeze": (lambda m, X: [
        m.np.squeeze(m.np.expand_dims(_arr(m, X["pos"]), 0)),
        m.np.squeeze(m.np.ones((1, 3, 1)), axis=2)], True),
    "tile": (lambda m, X: [m.np.tile(_arr(m, X["pos"]), (2, 1)),
                           m.np.tile(_arr(m, X["pos"]), 2)], True),
    "repeat": (lambda m, X: [m.np.repeat(_arr(m, X["pos"]), 2, axis=0),
                             m.np.repeat(_arr(m, X["pos"]), 2)], True),
    "flip": (lambda m, X: [m.np.flip(_arr(m, X["cube"])),
                           m.np.flip(_arr(m, X["cube"]), axis=1)], True),
    "cumsum": (lambda m, X: [m.np.cumsum(_arr(m, X["pos"])),
                             m.np.cumsum(_arr(m, X["pos"]), axis=1)], False),
    "sort": (lambda m, X: [m.np.sort(_arr(m, X["perm"])),
                           m.np.sort(_arr(m, X["perm"]), axis=0)], True),
    "argsort": (lambda m, X: [m.np.argsort(_arr(m, X["perm"])),
                              m.np.argsort(_arr(m, X["perm"]), axis=0)],
                True),
    # no axis: the flattened array, out-of-range indices clipped
    "take": (lambda m, X: [
        m.np.take(_arr(m, X["perm"]), m.np.array([0.0, 5.0, 11.0, 40.0])),
        m.np.take(_arr(m, X["perm"]), [2, 0], axis=1)], True),
    "vstack": (lambda m, X: [m.np.vstack([_arr(m, X["pos"]),
                                          _arr(m, X["sym"])])], True),
    "hstack": (lambda m, X: [m.np.hstack([_arr(m, X["pos"]),
                                          _arr(m, X["sym"])])], True),
    "dstack": (lambda m, X: [m.np.dstack([_arr(m, X["pos"]),
                                          _arr(m, X["sym"])])], True),
    "pi": (lambda m, X: [m.np.pi], True),
    "e": (lambda m, X: [m.np.e], True),
    "inf": (lambda m, X: [m.np.inf], True),
    "nan": (lambda m, X: [math.isnan(m.np.nan)], True),
    "newaxis": (lambda m, X: [m.np.newaxis], True),
    # draws are compared by their moments in test_random_draws_*; here
    # the shapes, dtypes and types of each sampler
    "random": (lambda m, X: [
        (type(d).__name__, d.shape, str(d.dtype)) for d in (
            m.np.random.uniform(size=(2, 3)), m.np.random.normal(size=4),
            m.np.random.randint(5, size=(3,)), m.np.random.rand(2, 2),
            m.np.random.randn(3), m.np.random.uniform())], True),
}

UNARY = {
    "abs": "sym", "exp": "sym", "log": "pos", "log2": "pos", "log10": "pos",
    "sqrt": "pos", "square": "sym", "sin": "sym", "cos": "sym",
    "tan": "sym", "tanh": "sym", "sign": "sym", "floor": "sym",
    "ceil": "sym", "isnan": "odd", "isinf": "odd", "isfinite": "odd",
    "negative": "sym",
}
for _name, _key in UNARY.items():
    NP_CASES.setdefault(_name, (
        lambda m, X, _n=_name, _k=_key: [getattr(m.np, _n)(_arr(m, X[_k]))],
        False))


def _conv_inputs(X):
    rng = onp.random.default_rng(1)
    return (rng.standard_normal((2, 3, 6, 6)).astype(onp.float32),
            rng.standard_normal((4, 3, 3, 3)).astype(onp.float32),
            rng.standard_normal((4,)).astype(onp.float32))


def _bn_inputs(X):
    rng = onp.random.default_rng(2)
    return [rng.standard_normal(s).astype(onp.float32) for s in
            ((2, 3, 4, 4), (3,), (3,), (3,))] + \
        [rng.uniform(0.5, 2.0, (3,)).astype(onp.float32)]


NPX_CASES = {
    "relu": (lambda m, X: [m.npx.relu(_arr(m, X["sym"]))], True),
    "sigmoid": (lambda m, X: [m.npx.sigmoid(_arr(m, X["sym"]))], False),
    "softmax": (lambda m, X: [m.npx.softmax(_arr(m, X["sym"])),
                              m.npx.softmax(_arr(m, X["sym"]), axis=0)],
                False),
    "log_softmax": (lambda m, X: [m.npx.log_softmax(_arr(m, X["sym"]))],
                    False),
    "activation": (lambda m, X: [
        m.npx.activation(_arr(m, X["sym"]), act_type=t)
        for t in ("relu", "sigmoid", "tanh", "softrelu")], False),
    "fully_connected": (lambda m, X: [
        m.npx.fully_connected(_arr(m, X["pos"]), _arr(m, X["mat"].T),
                              _arr(m, X["mat"][0]), num_hidden=5),
        m.npx.fully_connected(_arr(m, X["cube"]), _arr(m, X["mat"][:, :4]),
                              num_hidden=4, flatten=False)], False),
    "convolution": (lambda m, X: [m.npx.convolution(
        *[_arr(m, a) for a in _conv_inputs(X)], kernel=(3, 3), pad=(1, 1),
        num_filter=4), m.npx.convolution(
        *[_arr(m, a) for a in _conv_inputs(X)[:2]], kernel=(3, 3),
        stride=(2, 2), num_filter=4)], False),
    "pooling": (lambda m, X: [
        m.npx.pooling(_arr(m, _conv_inputs(X)[0])),
        m.npx.pooling(_arr(m, _conv_inputs(X)[0]), kernel=(3, 3),
                      stride=(1, 1), pool_type="avg")], False),
    "batch_norm": (lambda m, X: [m.npx.batch_norm(
        *[_arr(m, a) for a in _bn_inputs(X)])], False),
    "layer_norm": (lambda m, X: [m.npx.layer_norm(
        _arr(m, X["cube"]), _arr(m, X["pos"][0]), _arr(m, X["sym"][0])),
        m.npx.layer_norm(_arr(m, X["cube"]), _arr(m, X["pos"][:, 0]),
                         _arr(m, X["sym"][:, 0]), axis=1, eps=1e-3)],
        False),
    "embedding": (lambda m, X: [m.npx.embedding(
        m.np.array([[0.0, 3.0], [2.0, 3.0]]), _arr(m, X["mat"]),
        input_dim=4, output_dim=5)], True),
    "one_hot": (lambda m, X: [m.npx.one_hot(m.np.array([0.0, 2.0, 1.0]), 3),
                              m.npx.one_hot(m.np.array([1.0, 0.0]), 4,
                                            on_value=5.0, off_value=-1.0)],
                True),
    "pick": (lambda m, X: [
        m.npx.pick(_arr(m, X["perm"]), m.np.array([0.0, 3.0, 1.0])),
        m.npx.pick(_arr(m, X["perm"]), m.np.array([2.0, 0.0, 1.0, 1.0]),
                   axis=0, keepdims=True)], True),
    "topk": (lambda m, X: [m.npx.topk(_arr(m, X["perm"]), k=2),
                           m.npx.topk(_arr(m, X["perm"]), k=1, axis=0,
                                      ret_typ="value")], True),
    "reshape_like": (lambda m, X: [m.npx.reshape_like(
        _arr(m, X["pos"]), m.np.zeros((2, 6)))], True),
}

MEMBER_CASES = {
    "T": (lambda m, X: [_arr(m, X["pos"]).T], True),
    "__repr__": (lambda m, X: [repr(_arr(m, X["pos"][:2, :2])),
                               repr(m.np.arange(3))], True),
    "reshape": (lambda m, X: [_arr(m, X["pos"]).reshape(2, 6),
                              _arr(m, X["pos"]).reshape((12,)),
                              _arr(m, X["pos"]).reshape([4, -1])], True),
    "item": (lambda m, X: [m.np.array([2.5]).item(),
                           m.np.arange(1).item()], True),
    "tolist": (lambda m, X: [_arr(m, X["perm"]).tolist()], True),
    "size": (lambda m, X: [_arr(m, X["cube"]).size,
                           m.np.array(3.0).size], True),
    "copy": (lambda m, X: [_arr(m, X["pos"]).copy()], True),
    "astype": (lambda m, X: [_arr(m, X["pos"]).astype("int32"),
                             m.np.arange(4).astype("float32")], True),
    "mean": (lambda m, X: [_arr(m, X["pos"]).mean(),
                           _arr(m, X["pos"]).mean(axis=1, keepdims=True)],
             False),
    "sum": (lambda m, X: [_arr(m, X["pos"]).sum(),
                          _arr(m, X["pos"]).sum(axis=0)], False),
    "max": (lambda m, X: [_arr(m, X["perm"]).max(),
                          _arr(m, X["perm"]).max(axis=1, keepdims=True)],
            True),
    "min": (lambda m, X: [_arr(m, X["perm"]).min(),
                          _arr(m, X["perm"]).min(axis=0)], True),
}


def _kind(x):
    """The result's type: ``"ndarray"`` for an ``mx.np.ndarray``,
    ``"NDArray"`` for a plain one."""
    return "ndarray" if isinstance(x, (np.ndarray, jnp_mod.ndarray)) \
        else "NDArray"


def _same(got, want, exact):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, exact)
        return
    if isinstance(want, jmx.nd.NDArray):
        assert isinstance(got, mx.nd.NDArray), type(got)
        assert _kind(got) == _kind(want)
        g, w = got.asnumpy(), want.asnumpy()
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        if exact:
            onp.testing.assert_array_equal(g, w)
        else:
            onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        return
    assert got == want or (got is None and want is None), (got, want)


def _run_both(cases, name):
    fn, exact = cases[name]
    want = fn(jmx, _inputs())
    got = fn(mx, _inputs())
    _same(got, want, exact)


def test_every_numpy_name_has_a_case():
    generated = {n for n, v in vars(jnp_mod).items()
                 if callable(v) and getattr(v, "__name__", "") == n
                 and v.__qualname__.startswith("_unary_fn.")}
    assert set(UNARY) == generated
    assert set(NP_CASES) == set(jnp_mod.__all__) | generated
    assert set(np.__all__) == set(jnp_mod.__all__)
    for n in generated:
        assert callable(getattr(np, n))


@pytest.mark.parametrize("name", sorted(NP_CASES))
def test_numpy_function_matches_the_jax_package(name):
    _run_both(NP_CASES, name)


def test_every_npx_function_has_a_case():
    jax_fns = {n for n, v in vars(jmx.npx).items()
               if callable(v) and not n.startswith("_")
               and getattr(v, "__module__", "") == jmx.npx.__name__}
    controls = {"set_np", "reset_np", "is_np_array", "is_np_shape", "save",
                "load", "seed", "waitall"}
    assert jax_fns == set(NPX_CASES) | controls
    for n in jax_fns:
        assert callable(getattr(npx, n)), n


@pytest.mark.parametrize("name", sorted(NPX_CASES))
def test_npx_function_matches_the_jax_package(name):
    _run_both(NPX_CASES, name)


@pytest.mark.parametrize("name", sorted(MEMBER_CASES))
def test_ndarray_member_matches_the_jax_package(name):
    assert name in vars(jnp_mod.ndarray) and name in vars(np.ndarray)
    _run_both(MEMBER_CASES, name)


@pytest.mark.parametrize("expr", [
    "np.square(a) * 3.0", "a + nd.ones((2, 2))", "nd.ones((2, 2)) + a",
    "a[0]", "a.sum()", "a.T", "a.exp()", "-a", "a @ a", "a.reshape(4)",
    "np.sum(a, axis=1)", "a.astype('float16')", "a.copy()",
    "np.asarray(nd.ones((2,)))", "nd.array(a)"])
def test_result_types_match_the_jax_package(expr):
    """Only the front end's functions and ``mx.np.ndarray``'s own
    members return an ``mx.np.ndarray``; ``NDArray`` arithmetic,
    indexing and methods return plain ``NDArray``s."""
    X = onp.array([[1.0, 2.0], [3.0, 4.0]], onp.float32)
    want = eval(expr, {"np": jmx.np, "nd": jmx.nd, "a": jmx.np.array(X)})
    got = eval(expr, {"np": np, "nd": mx.nd, "a": np.array(X)})
    _same(got, want, exact=False)


# -- tests/test_numpy_api.py, on the port -------------------------------

def test_creation_and_props():
    a = np.array([[1.0, 2], [3, 4]])
    assert isinstance(a, np.ndarray) and isinstance(a, mx.nd.NDArray)
    assert a.shape == (2, 2) and a.size == 4
    assert a.dtype == onp.float32
    onp.testing.assert_allclose(a.T.asnumpy(), [[1, 3], [2, 4]])
    assert np.zeros((2, 3)).asnumpy().sum() == 0
    assert np.ones(4).asnumpy().sum() == 4
    onp.testing.assert_allclose(np.eye(3).asnumpy(), onp.eye(3))
    onp.testing.assert_allclose(np.arange(2, 8, 2).asnumpy(), [2, 4, 6])
    onp.testing.assert_allclose(np.linspace(0, 1, 5).asnumpy(),
                                onp.linspace(0, 1, 5), rtol=1e-6)
    onp.testing.assert_allclose(np.full((2,), 7.0).asnumpy(), [7, 7])
    assert np.arange(6).dtype == jmx.np.arange(6).dtype == onp.int32
    assert np.array(onp.zeros(2)).dtype == onp.float32


def test_math_matches_numpy():
    x = onp.random.RandomState(0).rand(3, 4).astype(onp.float32) + 0.5
    a = np.array(x)
    onp.testing.assert_allclose(np.exp(a).asnumpy(), onp.exp(x), rtol=1e-5)
    onp.testing.assert_allclose(np.sum(a, axis=1).asnumpy(), x.sum(1),
                                rtol=1e-5)
    onp.testing.assert_allclose(np.mean(a).asnumpy(), x.mean(), rtol=1e-5)
    onp.testing.assert_allclose(np.var(a, ddof=1).asnumpy(),
                                x.var(ddof=1), rtol=1e-4)
    onp.testing.assert_allclose(np.std(a).asnumpy(), x.std(), rtol=1e-4)
    onp.testing.assert_allclose((a @ a.T).asnumpy(), x @ x.T, rtol=1e-5)
    onp.testing.assert_allclose(np.matmul(a, a.T).asnumpy(), x @ x.T,
                                rtol=1e-5)
    onp.testing.assert_allclose(
        np.tensordot(a, a, axes=([1], [1])).asnumpy(),
        onp.tensordot(x, x, axes=([1], [1])), rtol=1e-5)
    onp.testing.assert_allclose(np.einsum("ij,kj->ik", a, a).asnumpy(),
                                onp.einsum("ij,kj->ik", x, x), rtol=1e-5)
    onp.testing.assert_allclose(np.power(a, 2).asnumpy(), x ** 2,
                                rtol=1e-5)
    onp.testing.assert_allclose(np.maximum(a, 1.0).asnumpy(),
                                onp.maximum(x, 1.0))


def test_shaping():
    a = np.arange(12).reshape(3, 4)
    assert a.shape == (3, 4)
    assert np.transpose(a).shape == (4, 3)
    assert np.expand_dims(a, 0).shape == (1, 3, 4)
    assert np.squeeze(np.expand_dims(a, 0)).shape == (3, 4)
    assert np.concatenate([a, a], axis=0).shape == (6, 4)
    assert np.stack([a, a]).shape == (2, 3, 4)
    parts = np.split(a, 2, axis=1)
    assert len(parts) == 2 and parts[0].shape == (3, 2)
    assert np.vstack([a, a]).shape == (6, 4)
    assert np.hstack([a, a]).shape == (3, 8)
    with pytest.raises(MXNetError, match="integer sections"):
        np.split(a, [1, 2])


def test_autograd_through_np():
    """mx.np arrays ride the same tape as mx.nd, and the JAX package's
    gradient is the port's."""
    x = onp.array([[1.0, 2], [3, 4]], onp.float32)
    grads = []
    for m, ag in ((mx, autograd), (jmx, jautograd)):
        a = m.np.array(x)
        a.attach_grad()
        with ag.record():
            loss = m.np.sum(m.np.square(a) * 3.0)
        loss.backward()
        assert _kind(a.grad) == "NDArray"
        grads.append(a.grad.asnumpy())
    onp.testing.assert_allclose(grads[0], 6 * x)
    onp.testing.assert_array_equal(grads[0], grads[1])


def test_view_shares_the_tensor_and_the_gradient_buffer():
    src = mx.nd.ones((2,))
    src.attach_grad()
    viewed = np.asarray(src)
    assert viewed._data is src._data and viewed._grad is src._grad
    with autograd.record():
        loss = (viewed * 2.0).sum()
    loss.backward()
    onp.testing.assert_array_equal(src.grad.asnumpy(), [2, 2])
    onp.testing.assert_array_equal(viewed.grad.asnumpy(), [2, 2])


def test_np_nd_interop():
    a = np.ones((2, 3))
    b = mx.nd.ones((2, 3))
    c = a + b
    assert c.asnumpy().sum() == 12 and _kind(c) == "NDArray"


def test_random():
    np.random.seed(0)
    u = np.random.uniform(size=(100,))
    assert 0 <= float(np.min(u).asnumpy()) and \
        float(np.max(u).asnumpy()) <= 1
    n = np.random.randn(50, 50)
    assert abs(float(np.mean(n).asnumpy())) < 0.1
    r = np.random.randint(0, 5, size=(20,))
    assert set(onp.unique(r.asnumpy())) <= {0, 1, 2, 3, 4}
    np.random.seed(3)
    a = np.random.normal(size=8).asnumpy()
    npx.seed(3)
    onp.testing.assert_array_equal(np.random.normal(size=8).asnumpy(), a)


RANDOM_DRAWS = {
    "uniform": lambda m: m.np.random.uniform(-1.0, 3.0, size=(20000,)),
    "normal": lambda m: m.np.random.normal(2.0, 0.5, size=(100, 200)),
    "randint": lambda m: m.np.random.randint(3, 11, size=20000),
    "randint_high": lambda m: m.np.random.randint(7, size=(20000,)),
    "rand": lambda m: m.np.random.rand(100, 200),
    "randn": lambda m: m.np.random.randn(20000),
}


@pytest.mark.parametrize("name", sorted(RANDOM_DRAWS))
def test_random_draws_match_the_jax_package(name):
    jmx.np.random.seed(0)
    np.random.seed(0)
    want = RANDOM_DRAWS[name](jmx)
    got = RANDOM_DRAWS[name](mx)
    assert _kind(got) == _kind(want) == "ndarray"
    assert got.shape == want.shape and got.dtype == want.dtype
    g = got.asnumpy().astype(onp.float64)
    w = want.asnumpy().astype(onp.float64)
    se = w.std() / onp.sqrt(w.size)
    assert abs(g.mean() - w.mean()) < 5 * se * onp.sqrt(2)
    assert abs(g.std() - w.std()) < 5 * se * onp.sqrt(2) * 1.5
    assert g.min() >= w.min() - 8 * w.std() and g.max() <= w.max() + \
        8 * w.std()


def test_npx_ops():
    x = np.array([[1.0, -1.0], [0.5, -0.5]])
    onp.testing.assert_allclose(npx.relu(x).asnumpy(), [[1, 0], [0.5, 0]])
    s = npx.softmax(x)
    onp.testing.assert_allclose(s.asnumpy().sum(axis=1), [1, 1], rtol=1e-6)
    out = npx.fully_connected(x, np.ones((4, 2)), num_hidden=4,
                              no_bias=True)
    assert out.shape == (2, 4)
    onp.testing.assert_allclose(npx.one_hot(np.array([0.0, 1.0]), 3)
                                .asnumpy(), [[1, 0, 0], [0, 1, 0]])


@pytest.mark.parametrize("hybridize", [False, True])
def test_npx_set_np_reaches_gluon(hybridize):
    assert not npx.is_np_array() and not npx.is_np_shape()
    net = gluon.nn.Dense(3)
    net.initialize(device="cpu")
    if hybridize:
        net.hybridize()
    assert _kind(net(np.ones((2, 4)))) == "NDArray"
    try:
        npx.set_np()
        assert npx.is_np_array() and npx.is_np_shape()
        for _ in range(2):
            out = net(np.ones((2, 4)))
            assert isinstance(out, np.ndarray)
            assert out.T.shape == (3, 2)
        split = gluon.nn.HybridLambda(lambda F, x: F.split(x, 2, axis=1))
        parts = split(mx.nd.ones((2, 4)))
        assert [_kind(p) for p in parts] == ["ndarray", "ndarray"]
    finally:
        npx.reset_np()
    assert not npx.is_np_array()
    assert _kind(net(np.ones((2, 4)))) == "NDArray"


def test_set_np_leaves_the_symbolic_route_alone():
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    try:
        npx.set_np()
        out = net(mx.sym.var("data"))
    finally:
        npx.reset_np()
    assert isinstance(out, mx.sym.Symbol)


def test_np_semantics_numpy_edge_cases():
    a = np.array([[1.0, 2], [3, 4]])
    onp.testing.assert_allclose(np.flip(a).asnumpy(), [[4, 3], [2, 1]])
    onp.testing.assert_allclose(
        np.take(np.arange(6).reshape(2, 3), np.array([0.0, 4.0]))
        .asnumpy(), [0, 4])
    # array() copies the buffer; asarray() shares it at creation time
    src = mx.nd.ones((2,))
    copied = np.array(src)
    viewed = np.asarray(src)
    assert viewed._data is src._data
    assert copied._data is not src._data
    src[:] = 5.0
    onp.testing.assert_array_equal(viewed.asnumpy(), [5, 5])
    onp.testing.assert_array_equal(copied.asnumpy(), [1, 1])


def test_npx_save_load(tmp_path):
    f = str(tmp_path / "x.params")
    npx.save(f, {"a": np.ones((2, 2)), "b": np.arange(3)})
    back = npx.load(f)
    assert isinstance(back["a"], np.ndarray)
    onp.testing.assert_allclose(back["a"].asnumpy(), onp.ones((2, 2)))
    # the same bytes as the JAX package's npx.save, and each loads the
    # other's file
    g = str(tmp_path / "j.params")
    jmx.npx.save(g, {"a": jmx.np.ones((2, 2)), "b": jmx.np.arange(3)})
    assert open(f, "rb").read() == open(g, "rb").read()
    jback = jmx.npx.load(f)
    assert isinstance(jback["b"], jmx.np.ndarray)
    onp.testing.assert_array_equal(jback["b"].asnumpy(),
                                   npx.load(g)["b"].asnumpy())


def test_without_cuda_an_array_needs_a_context():
    """No ``with mx.cpu():`` in force (a new thread) and no CUDA:
    ``np.array`` raises as ``mx.nd.array`` does (the port's first
    deviation); it moves nothing to the CPU."""
    import threading
    import torch
    errors = []

    def make():
        for fn in (lambda: np.array([1.0]), lambda: mx.nd.array([1.0]),
                   lambda: np.zeros(2)):
            try:
                fn()
                errors.append(None)
            except MXNetError as e:
                errors.append(e)

    t = threading.Thread(target=make)
    t.start()
    t.join()
    if torch.cuda.is_available():
        assert errors == [None] * 3
    else:
        assert all(isinstance(e, MXNetError) for e in errors), errors


# -- the slice as a whole: a narrow BERT under npx.set_np() -------------

NARROW = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
              num_heads=2, max_length=16)
BATCH, SEQ, STEPS = 2, 16, 2
ADAM = {"learning_rate": 1e-3}


def _bert_batch(seed=4):
    rng = onp.random.default_rng(seed)
    v = NARROW["vocab_size"]
    return (rng.integers(0, v, (BATCH, SEQ)).astype(onp.float32),
            rng.integers(0, v, (BATCH, SEQ)).astype(onp.float32),
            rng.integers(0, 2, (BATCH,)).astype(onp.float32))


def _ce(m, scores, labels):
    return m.np.mean(m.np.negative(
        m.npx.pick(m.npx.log_softmax(scores), labels)))


def _bert_run(m, ag, net, trainer):
    """Under ``set_np()``: ``STEPS`` steps of the imperative loop on
    ``mx.np`` inputs; the first forward's outputs and gradients, each
    step's loss and weights, and the type of every result."""
    ids, labels, nsp_labels = (m.np.array(a) for a in _bert_batch())
    types = m.np.zeros((BATCH, SEQ))
    out = {"losses": [], "weights": [], "kinds": []}
    params = net.collect_params()
    for s in range(STEPS):
        with ag.record():
            mlm, nsp = net(ids, types)
            mlm_loss = _ce(m, mlm, labels)
            loss = mlm_loss + _ce(m, nsp, nsp_labels)
        out["kinds"].append([_kind(x) for x in (mlm, nsp, mlm_loss, loss)])
        loss.backward()
        if s == 0:
            out["outs"] = (mlm.asnumpy(), nsp.asnumpy())
            out["grads"] = {n[len(net.prefix):]: p.grad().asnumpy()
                            for n, p in params.items()
                            if p.grad_req != "null"}
        trainer.step(1)
        out["losses"].append(float(loss.asnumpy()))
        out["weights"].append({n[len(net.prefix):]: p.data().asnumpy()
                               for n, p in params.items()})
    return out


@pytest.fixture(scope="module")
def jax_bert():
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_KERNELS", "1")
    try:
        with jax.default_matmul_precision("highest"):
            onp.random.seed(0)
            jnet = JBERTModel(dropout=0.0, use_flash=True, **NARROW)
            jnet.initialize(ctx=jmx.cpu())
            with jautograd.pause():
                jnet(jmx.nd.array(_bert_batch()[0]))
            arrays = {n: p.data().asnumpy()
                      for n, p in jnet.collect_params().items()}
            trainer = jgluon.Trainer(jnet.collect_params(), "adam",
                                     dict(ADAM))
            jmx.npx.set_np()
            try:
                run = _bert_run(jmx, jautograd, jnet, trainer)
            finally:
                jmx.npx.reset_np()
    finally:
        mp.undo()
    return arrays, run


def _split_key_bias(snap):
    u = NARROW["units"]
    held = {k: (onp.concatenate([v[:u], v[2 * u:]])
                if k.endswith("qkv_bias") else v) for k, v in snap.items()}
    keys = {k: v[u:2 * u] for k, v in snap.items() if k.endswith("qkv_bias")}
    return held, keys


def test_bert_under_set_np_matches_the_jax_package(jax_bert):
    arrays, want = jax_bert
    net = BERTModel(dropout=0.0, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
    registry.reset_launches()
    npx.set_np()
    try:
        got = _bert_run(mx, autograd, net, trainer)
    finally:
        npx.reset_np()
    # every block output and the front end's results mx.np.ndarrays on
    # both sides, NDArray arithmetic (the sum of the terms) a plain one
    assert got["kinds"] == want["kinds"] == \
        [["ndarray", "ndarray", "ndarray", "NDArray"]] * STEPS
    for g, w in zip(got["outs"], want["outs"]):
        onp.testing.assert_allclose(g, w, atol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, w in want["grads"].items():
        onp.testing.assert_allclose(got["grads"][name], w, rtol=2e-4,
                                    atol=2e-6, err_msg=name)
    onp.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert want["losses"][-1] < want["losses"][0]
    start = _split_key_bias({k[len(net.prefix):]: v
                             for k, v in arrays.items()})[1]
    for s in range(STEPS):
        held, keys = _split_key_bias(got["weights"][s])
        jheld, _ = _split_key_bias(want["weights"][s])
        for name, w in jheld.items():
            onp.testing.assert_allclose(held[name], w, rtol=2e-4,
                                        atol=2e-6,
                                        err_msg="%s step %d" % (name, s))
        for name, k in keys.items():
            lim = ADAM["learning_rate"] * (s + 1) * 1.01
            assert onp.abs(k - start[name]).max() <= lim, name
    # the CPU ran the plain versions: nothing counted as a launch
    assert registry.launches("flash_attention_fwd") == 0
    assert registry.launches("layernorm_fwd") == 0
