"""The port's ``linalg_*`` ops and ``moments`` against the JAX package's
on the CPU: every case of ``tests/test_op_families.py``'s linalg part
through both packages, then every op forward and backward -- the
gradient of ``sum(out * c)`` for fixed random ``c`` with respect to
each input, through each package's ``autograd``.

Eigenvectors (``linalg_syevd``) and singular vectors (``linalg_svd``)
are fixed only up to a sign each, which LAPACK (the port's CPU route)
and XLA choose their own ways: their vectors are held after each is
turned so that its largest component is positive, their reconstructions
directly, and their gradients through functions that do not see the
sign (the values, and the vectors' squares).

Tolerance: 1e-4 relative and 1e-5 absolute (float32 factorizations in
two libraries; the JAX tests hold their own to 1e-3-1e-5).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd

TOL = dict(rtol=1e-4, atol=1e-5)
_R = np.random.RandomState(0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _spd(n=4, batch=()):
    a = _R.randn(*batch, n, n).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


def _both(fn):
    """``fn(mx)`` through the port and through the JAX package, as numpy
    lists."""
    out = []
    for pkg in (tmx, jmx):
        res = fn(pkg)
        res = res if isinstance(res, (list, tuple)) else [res]
        out.append([np.asarray(r.asnumpy() if hasattr(r, "asnumpy") else r)
                    for r in res])
    return out


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


# -- tests/test_op_families.py, linalg ----------------------------------

def test_linalg_gemm_family():
    A = _R.randn(3, 4).astype(np.float32)
    B = _R.randn(4, 5).astype(np.float32)
    C = _R.randn(3, 5).astype(np.float32)
    got, want = _both(lambda mx: [
        mx.nd.linalg_gemm(mx.nd.array(A), mx.nd.array(B), mx.nd.array(C),
                          alpha=2.0, beta=0.5),
        mx.nd.linalg_gemm2(mx.nd.array(A), mx.nd.array(A),
                           transpose_b=True)])
    _close(got, want)
    np.testing.assert_allclose(got[0], 2 * A @ B + 0.5 * C, rtol=1e-5)
    np.testing.assert_allclose(got[1], A @ A.T, rtol=1e-5)


def test_linalg_cholesky_chain():
    S = _spd()

    def chain(mx):
        L = mx.nd.linalg_potrf(mx.nd.array(S))
        return [L, mx.nd.linalg_potri(L), mx.nd.linalg_sumlogdiag(L)]
    got, want = _both(chain)
    _close(got, want)
    L, inv, sld = got
    np.testing.assert_allclose(L @ L.T, S, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inv, np.linalg.inv(S), rtol=1e-3, atol=1e-3)
    assert abs(2 * float(sld) - np.linalg.slogdet(S)[1]) < 1e-3


def test_linalg_trsm_trmm():
    S = _spd()
    L = np.linalg.cholesky(S).astype(np.float32)
    B = _R.randn(4, 3).astype(np.float32)
    got, want = _both(lambda mx: [
        mx.nd.linalg_trsm(mx.nd.array(L), mx.nd.array(B)),
        mx.nd.linalg_trmm(mx.nd.array(L), mx.nd.array(B))])
    _close(got, want)
    np.testing.assert_allclose(L @ got[0], B, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], np.tril(L) @ B, rtol=1e-4)


def test_linalg_decompositions():
    S = _spd()
    got, want = _both(lambda mx: list(mx.nd.linalg_syevd(mx.nd.array(S)))
                      + list(mx.nd.linalg_slogdet(mx.nd.array(S)))
                      + [mx.nd.linalg_det(mx.nd.array(S)),
                         mx.nd.linalg_inverse(mx.nd.array(S))])
    UT, w = got[:2]
    np.testing.assert_allclose(UT.T @ np.diag(w) @ UT, S, rtol=1e-3,
                               atol=1e-3)
    _close([_signed_rows(UT)] + got[1:], [_signed_rows(want[0])] + want[1:])
    assert got[2] == 1.0
    np.testing.assert_allclose(got[4], np.linalg.det(S), rtol=1e-3)
    np.testing.assert_allclose(got[5] @ S, np.eye(4), atol=1e-3)


def test_linalg_grad_flows():
    S = _spd()

    def grad(mx, ag):
        x = mx.nd.array(S)
        x.attach_grad()
        with ag.record():
            y = mx.nd.linalg_sumlogdiag(mx.nd.linalg_potrf(x))
        y.backward()
        return x.grad
    got, want = grad(tmx, autograd).asnumpy(), grad(jmx, jautograd).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, 0.5 * np.linalg.inv(S), rtol=1e-3,
                               atol=1e-4)


def test_moments():
    x = _R.randn(4, 5).astype(np.float32)
    got, want = _both(lambda mx: mx.nd.moments(mx.nd.array(x), axes=(1,)))
    _close(got, want)
    np.testing.assert_allclose(got[0], x.mean(1), rtol=1e-5)
    np.testing.assert_allclose(got[1], x.var(1), rtol=1e-4)


# -- every op, forward and backward -------------------------------------

def _lower(n=4, batch=(2,)):
    return np.tril(_R.randn(*batch, n, n).astype(np.float32)) \
        + 3 * np.eye(n, dtype=np.float32)


CASES = {
    "linalg_gemm": ([_R.randn(2, 3, 4), _R.randn(2, 4, 5),
                     _R.randn(2, 3, 5)],
                    {"transpose_a": False, "alpha": 0.7, "beta": -1.5}),
    "linalg_gemm2": ([_R.randn(4, 3), _R.randn(5, 4)],
                     {"transpose_a": True, "transpose_b": True}),
    "linalg_potrf": ([_spd(4, (2,))], {}),
    "linalg_potri": ([_lower()], {}),
    "linalg_trsm": ([_lower(), _R.randn(2, 4, 3)], {"alpha": 1.5}),
    "linalg_trsm_right": ([_lower(), _R.randn(2, 3, 4)],
                          {"rightside": True, "lower": False,
                           "transpose": True}),
    "linalg_trmm": ([_R.randn(2, 4, 4), _R.randn(2, 3, 4)],
                    {"rightside": True, "alpha": 2.0}),
    "linalg_syrk": ([_R.randn(2, 3, 5)], {"alpha": 1.5}),
    "linalg_sumlogdiag": ([_spd(3, (2,))], {}),
    "linalg_extractdiag": ([_R.randn(2, 4, 4)], {"offset": -1}),
    "linalg_makediag": ([_R.randn(2, 3)], {"offset": 1}),
    "linalg_extracttrian": ([_R.randn(2, 4, 4)], {"offset": 0}),
    "linalg_maketrian": ([_R.randn(2, 6)], {}),
    "linalg_syevd": ([_spd(4, (2,))], {}),
    "linalg_inverse": ([_spd(3, (2,))], {}),
    "inverse": ([_spd(3)], {}),
    "linalg_det": ([_R.randn(2, 3, 3) + 3 * np.eye(3)], {}),
    "det": ([_R.randn(3, 3) + 3 * np.eye(3)], {}),
    "linalg_slogdet": ([_R.randn(2, 3, 3) - 3 * np.eye(3)], {}),
    "slogdet": ([_R.randn(3, 3) + 3 * np.eye(3)], {}),
    "linalg_svd": ([_R.randn(2, 3, 5)], {}),
    "moments": ([_R.randn(3, 4, 5)], {"axes": (0, 2), "keepdims": True}),
}
SIGN_FREE = ("linalg_syevd", "linalg_svd")


def _signed_rows(a):
    """Each row (the last axis) turned so its largest component is
    positive."""
    idx = np.abs(a).argmax(axis=-1)[..., None]
    return a * np.sign(np.take_along_axis(a, idx, axis=-1))


def _run(mx, ag, name, inputs, params, fixed):
    op = getattr(mx.nd, name.replace("_right", ""))
    xs = [mx.nd.array(np.asarray(x, np.float32)) for x in inputs]
    for x in xs:
        x.attach_grad()
    with ag.record():
        outs = op(*xs, **params)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        if name == "linalg_syevd":
            terms = [outs[1], outs[0] * outs[0]]
        elif name == "linalg_svd":
            terms = [outs[1], outs[0] * outs[0], outs[2] * outs[2]]
        else:
            terms = [o for o in outs if o.dtype == np.float32]
        loss = None
        for t, c in zip(terms, fixed):
            s = (t * mx.nd.array(c[:t.size].reshape(t.shape))).sum()
            loss = s if loss is None else loss + s
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _run_jax_compute(name, inputs, params, fixed):
    """The JAX op's compute function and its ``jax.vjp``: the JAX
    package's ``linalg_maketrian`` reads a traced value as an int, so it
    cannot run through that package's eager jit."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import OP_REGISTRY
    fn = OP_REGISTRY[name].fcompute
    xs = [jnp.asarray(np.asarray(x, np.float32)) for x in inputs]
    out, pull = jax.vjp(lambda *a: fn(*a, **params), *xs)
    cot = jnp.asarray(fixed[0][:out.size].reshape(out.shape))
    return [np.asarray(out)], [np.asarray(g) for g in pull(cot)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_op_forward_and_backward(name):
    inputs, params = CASES[name]
    fixed = [np.random.RandomState(9 + i).randn(400).astype(np.float32)
             for i in range(3)]
    outs, grads = _run(tmx, autograd, name, inputs, params, fixed)
    if name == "linalg_maketrian":
        jouts, jgrads = _run_jax_compute(name, inputs, params, fixed)
    else:
        jouts, jgrads = _run(jmx, jautograd, name, inputs, params, fixed)
    assert [o.shape for o in outs] == [o.shape for o in jouts]
    assert [o.dtype for o in outs] == [o.dtype for o in jouts]
    if name in SIGN_FREE:
        vec = [0] if name == "linalg_syevd" else [0, 2]
        outs = [_signed_rows(o) if i in vec else o
                for i, o in enumerate(outs)]
        jouts = [_signed_rows(o) if i in vec else o
                 for i, o in enumerate(jouts)]
    _close(outs, jouts)
    _close(grads, jgrads, rtol=2e-4, atol=2e-5)


def test_svd_and_syevd_reconstruct_their_input():
    a = _R.randn(2, 3, 5).astype(np.float32)
    with tmx.cpu():
        ut, s, v = tmx.nd.linalg_svd(tmx.nd.array(a))
        u, w = tmx.nd.linalg_syevd(tmx.nd.array(_spd(4, (2,))))
    recon = np.swapaxes(ut.asnumpy(), -1, -2) @ (s.asnumpy()[..., None]
                                                 * v.asnumpy())
    np.testing.assert_allclose(recon, a, rtol=1e-4, atol=1e-5)
    assert (np.diff(w.asnumpy(), axis=-1) > 0).all()
    eye = u.asnumpy() @ np.swapaxes(u.asnumpy(), -1, -2)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)


def test_maketrian_needs_offset_zero_in_both():
    with pytest.raises(NotImplementedError):
        tmx.nd.linalg_maketrian(tmx.nd.ones((2, 6)), offset=1)
