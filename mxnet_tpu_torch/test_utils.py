"""Testing toolkit (counterpart of ``mxnet_tpu/test_utils.py``; reference
``python/mxnet/test_utils.py :: assert_almost_equal,
check_numeric_gradient, check_consistency, default_context``).

``check_consistency`` runs one op of the table on a list of contexts
and compares each result with the first: the reference's cpu-vs-gpu
pattern, ``cpu(0)`` against ``gpu(0)`` by default when a card is
present.
"""
from __future__ import annotations

import numpy as np

from . import autograd
from . import context as _ctx_mod
from .ndarray import NDArray, array
from .ndarray.ndarray import invoke

__all__ = ["DummyIter", "assert_almost_equal", "check_consistency",
           "check_numeric_gradient", "default_context", "rand_ndarray"]


def default_context():
    """``gpu(0)`` when CUDA is present, else ``cpu(0)`` (reference:
    ``default_context``)."""
    if _ctx_mod.num_gpus() > 0:
        return _ctx_mod.gpu(0)
    return _ctx_mod.cpu(0)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")):
    a = a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
    b = b.asnumpy() if isinstance(b, NDArray) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg="%s vs %s" % names)


def rand_ndarray(shape, ctx=None, dtype="float32", scale=1.0):
    return array(np.random.normal(0, scale, size=shape).astype(dtype),
                 ctx=ctx)


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-4,
                           wrt=None):
    """Finite-difference check of recorded gradients.

    ``fn(*NDArrays) -> scalar NDArray``; compares the gradients of a
    recorded backward with central differences (reference:
    ``check_numeric_gradient``).
    """
    nds = [array(i) if not isinstance(i, NDArray) else i for i in inputs]
    wrt = list(range(len(nds))) if wrt is None else wrt
    for i in wrt:
        nds[i].attach_grad()
    with autograd.record():
        out = fn(*nds)
    out.backward()
    for i in wrt:
        base = nds[i].asnumpy().astype(np.float64)
        num = np.zeros_like(base)
        flat = base.ravel()
        numflat = num.ravel()
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = fn(*[array(base.astype(np.float32)) if k == i else nds[k]
                      for k in range(len(nds))]).asscalar()
            flat[j] = orig - eps
            fm = fn(*[array(base.astype(np.float32)) if k == i else nds[k]
                      for k in range(len(nds))]).asscalar()
            flat[j] = orig
            numflat[j] = (fp - fm) / (2 * eps)
        got = nds[i].grad.asnumpy()
        np.testing.assert_allclose(got, num, rtol=rtol, atol=atol,
                                   err_msg="gradient wrt input %d" % i)


def check_consistency(op_name, tensor_inputs, params=None, ctx_list=None,
                      rtol=5e-3, atol=1e-5):
    """Run one op on every context of ``ctx_list`` and compare each
    result with the first context's (reference: ``check_consistency``);
    by default ``cpu(0)``, then ``gpu(0)`` when a card is present.  The
    tolerances are the JAX package's."""
    params = params or {}
    if ctx_list is None:
        ctx_list = [_ctx_mod.cpu(0)]
        if _ctx_mod.num_gpus():
            ctx_list.append(_ctx_mod.gpu(0))
    results = []
    for ctx in ctx_list:
        args = [array(t, ctx=ctx) for t in tensor_inputs]
        out = invoke(op_name, args, dict(params))
        outs = out if isinstance(out, list) else [out]
        results.append([o.asnumpy() for o in outs])
    ref = results[0]
    for got, ctx in zip(results[1:], ctx_list[1:]):
        for r, g in zip(ref, got):
            np.testing.assert_allclose(
                g, r, rtol=rtol, atol=atol,
                err_msg="%s inconsistent between %s and %s"
                        % (op_name, ctx_list[0], ctx))


class DummyIter:
    """Infinite constant-batch iterator (reference: ``DummyIter``)."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch
