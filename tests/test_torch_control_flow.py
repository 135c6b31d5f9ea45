"""The port's control-flow constructs (``mx.nd.contrib.foreach``,
``while_loop`` and ``cond``, and ``F.contrib.*`` in a ``hybrid_forward``)
against the JAX package's on the CPU: ``tests/test_op_families.py``'s
control-flow cases through both packages; the closure-constant rule (an
array the body only captures gets no gradient, in both); the gradient of
``cond`` with a branch not taken whose gradient is NaN or infinite; and
all three constructs in a hybridized block, forward and gradients,
against the JAX package's hybridized block with the same weights.

Tolerance: 1e-5 relative and 1e-6 absolute, the JAX tests' own; the
hybridized block's outputs and gradients (two float32 programs fused
their own ways, some entries cancelling) 1e-5 relative and 1e-5 of the
array's largest magnitude.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon

TOL = dict(rtol=1e-5, atol=1e-6)
PKGS = ((tmx, autograd), (jmx, jautograd))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(fn):
    return [fn(mx, ag) for mx, ag in PKGS]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


# -- tests/test_op_families.py -------------------------------------------

def test_foreach_cumsum_and_grad():
    def run(mx, ag):
        data = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        outs, final = mx.nd.contrib.foreach(
            lambda x, s: (x + s, x + s), data, mx.nd.zeros((3,)))
        x = mx.nd.ones((4, 3))
        x.attach_grad()
        with ag.record():
            o, _ = mx.nd.contrib.foreach(
                lambda t, s: (t * 2.0 + s, s + t), x, mx.nd.zeros((3,)))
            o.sum().backward()
        return [outs.asnumpy(), final.asnumpy(), x.grad.asnumpy()]
    got, want = _both(run)
    _close(got, want)
    expect = np.cumsum(np.arange(12).reshape(4, 3), axis=0)
    np.testing.assert_allclose(got[0], expect)
    np.testing.assert_allclose(got[1], expect[-1])
    np.testing.assert_allclose(got[2][:, 0], [5, 4, 3, 2])


def _cond_fn(i, s):
    return i < 5.0


def _body_fn(i, s):
    return s, (i + 1.0, s + i)


def test_while_loop():
    def run(mx, ag):
        outs, (i_f, s_f) = mx.nd.contrib.while_loop(
            _cond_fn, _body_fn, (mx.nd.zeros(()), mx.nd.zeros(())),
            max_iterations=8)
        return [outs.asnumpy(), i_f.asnumpy(), s_f.asnumpy()]
    got, want = _both(run)
    _close(got, want)
    assert got[1] == 5.0 and got[2] == 10.0
    np.testing.assert_array_equal(got[0], [0, 0, 1, 3, 6, 0, 0, 0])
    with pytest.raises(MXNetError, match="max_iterations"):
        tmx.nd.contrib.while_loop(_cond_fn, _body_fn,
                                  (tmx.nd.zeros(()), tmx.nd.zeros(())))


def test_cond():
    def run(mx, ag):
        five = mx.nd.array(np.array(5.0, np.float32))
        return [mx.nd.contrib.cond(mx.nd.array(np.array(p)),
                                   lambda a: a * 2, lambda a: a * 3,
                                   [five]).asnumpy() for p in (1.0, 0.0)]
    got, want = _both(run)
    _close(got, want)
    assert got == [10.0, 15.0]


# -- structure, gradients and the closure rule -----------------------------

def test_multiple_data_states_and_outputs():
    rng = np.random.RandomState(1)
    a, b = rng.randn(5, 2, 3), rng.randn(5, 3)
    h, c = rng.randn(2, 3), rng.randn(3)

    def body(xs, states):
        x, y = xs
        s, t = states
        return [x * s + y, s - t], [s * 0.5 + x, t + y]

    def run(mx, ag):
        xs = [mx.nd.array(a.astype(np.float32)),
              mx.nd.array(b.astype(np.float32))]
        st = [mx.nd.array(h.astype(np.float32)),
              mx.nd.array(c.astype(np.float32))]
        for v in xs + st:
            v.attach_grad()
        with ag.record():
            outs, finals = mx.nd.contrib.foreach(body, xs, st)
            loss = (outs[0] * outs[0]).sum() + outs[1].sum() \
                + (finals[0] * finals[1]).sum()
        loss.backward()
        return [o.asnumpy() for o in outs + finals] + \
            [v.grad.asnumpy() for v in xs + st]
    got, want = _both(run)
    assert len(got) == len(want) == 8
    _close(got, want)


def test_while_loop_gradient_through_loop_vars():
    def run(mx, ag):
        v = mx.nd.array(np.array([0.5, -1.5], np.float32))
        v.attach_grad()
        with ag.record():
            outs, (i, acc) = mx.nd.contrib.while_loop(
                lambda i, a: i < 3.0,
                lambda i, a: ([a * a, i], (i + 1.0, a * 1.5 + 1.0)),
                (mx.nd.zeros(()), v), max_iterations=5)
            loss = acc.sum() + (outs[0] * outs[0]).sum()
        loss.backward()
        return [outs[0].asnumpy(), outs[1].asnumpy(), acc.asnumpy(),
                v.grad.asnumpy()]
    got, want = _both(run)
    _close(got, want)


def test_an_array_only_the_closure_captures_gets_no_gradient():
    """``w`` enters only through the body's closure: a constant to the
    gradient in both packages; ``x`` (the data) gets its gradient."""
    def run(mx, ag):
        w = mx.nd.array(np.array([2.0, -1.0, 0.5], np.float32))
        w.attach_grad()
        x = mx.nd.ones((4, 3))
        x.attach_grad()
        with ag.record():
            o, s = mx.nd.contrib.foreach(
                lambda t, s: (t * w + s, s + t * w), x, mx.nd.zeros((3,)))
            (o.sum() + s.sum()).backward()
        return [w.grad.asnumpy(), x.grad.asnumpy()]
    got, want = _both(run)
    _close(got, want)
    np.testing.assert_array_equal(got[0], 0.0)
    assert np.abs(got[1]).sum() > 0


@pytest.mark.parametrize("pred,bad", [(1.0, "sqrt"), (1.0, "log"),
                                      (0.0, "sqrt"), (0.0, "log")])
def test_cond_gradient_ignores_a_nan_branch_not_taken(pred, bad):
    """The branch not taken has a NaN or infinite gradient at these
    inputs (``sqrt`` at 0, ``log`` of a negative); the gradient of the
    inputs is the taken branch's alone, finite, as the JAX package's
    ``lax.cond`` gives it.  The branches give two outputs: the JAX
    package cannot differentiate a one-output ``cond`` (its backward
    receives a leaf where its forward gave a tuple), so that form is
    held to the analytic gradient in the port alone."""
    v0 = np.array([0.0, -1.0, 2.0], np.float32)

    def run(mx, ag, two=True):
        v = mx.nd.array(v0)
        v.attach_grad()
        nan = mx.nd.sqrt if bad == "sqrt" else mx.nd.log
        safe = [lambda a: a * a * 3.0, lambda a: a]
        branch = [nan, lambda a: a * 2.0]
        if not two:
            safe, branch = safe[:1], branch[:1]

        def safe_f(a):
            return [f(a) for f in safe] if two else safe[0](a)

        def nan_f(a):
            return [f(a) for f in branch] if two else branch[0](a)
        then_f, else_f = (safe_f, nan_f) if pred else (nan_f, safe_f)
        with ag.record():
            y = mx.nd.contrib.cond(mx.nd.array(np.array(pred, np.float32)),
                                   then_f, else_f, [v])
            ys = y if two else [y]
            loss = ys[0].sum()
            for extra in ys[1:]:
                loss = loss + extra.sum()
            loss.backward()
        return [o.asnumpy() for o in ys] + [v.grad.asnumpy()]
    got, want = _both(run)
    _close(got, want)
    assert np.isfinite(got[-1]).all()
    np.testing.assert_allclose(got[-1], 6.0 * v0 + 1.0, **TOL)
    one = run(tmx, autograd, two=False)
    np.testing.assert_allclose(one[-1], 6.0 * v0, **TOL)


# -- hybridized ---------------------------------------------------------------

def _flow_block(gl):
    class Flow(gl.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = gl.nn.Dense(4, in_units=4, flatten=False)

        def hybrid_forward(self, F, x, h):
            outs, h = F.contrib.foreach(
                lambda xt, s: [F.tanh(xt + s)] * 2, x, h)
            _, (i, acc) = F.contrib.while_loop(
                lambda i, a: i < 2.0, lambda i, a: (a, (i + 1.0, a * 1.5)),
                (h.sum() * 0, h), max_iterations=4)
            y = F.contrib.cond(acc.sum() > 0, lambda a: a * 2.0,
                               lambda a: a - 1.0, [acc])
            return self.cell(y + outs.sum(axis=0))
    return Flow(prefix="flow_")


def test_all_three_constructs_hybridized():
    rng = np.random.RandomState(3)
    x0 = rng.randn(5, 2, 4).astype(np.float32)
    h0 = rng.randn(2, 4).astype(np.float32)
    w = rng.randn(4, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    res = []
    for (mx, ag), gl in zip(PKGS, (gluon, jgluon)):
        net = _flow_block(gl)
        if mx is tmx:
            net.initialize(device="cpu")
        else:
            net.initialize(ctx=mx.cpu())
        net.hybridize()
        x, h = mx.nd.array(x0), mx.nd.array(h0)
        net(x, h)
        net.cell.weight.set_data(mx.nd.array(w))
        net.cell.bias.set_data(mx.nd.array(b))
        x.attach_grad()
        h.attach_grad()
        outs = []
        for _ in range(2):
            with ag.record():
                y = net(x, h)
                (y * y).sum().backward()
            outs += [y.asnumpy(), x.grad.asnumpy(), h.grad.asnumpy(),
                     net.cell.weight.grad().asnumpy()]
        res.append(outs)
    for g, w in zip(*res):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
