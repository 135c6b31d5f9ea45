"""The port's autograd on NDArrays against the JAX package's, on the CPU:
the behaviour of ``tests/test_autograd.py``, MXNet's gradient requests
(``write`` overwrites at each backward where PyTorch accumulates,
``add`` accumulates, ``null`` gives none) on NDArrays and on gluon
parameters, and gradients of the same numpy inputs through both
packages.  Tolerance 1e-5 relative / 1e-6 absolute, the JAX tests'
``assert_almost_equal`` rtol."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


# -- tests/test_autograd.py, on the port -------------------------------

def test_record_pause():
    x = mx.nd.ones((2,))
    x.attach_grad()
    assert not autograd.is_recording()
    with autograd.record():
        assert autograd.is_recording()
        assert autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
        y = x * 2
    y.backward()
    assert x.grad.asnumpy().tolist() == [2, 2]


def test_train_predict_mode():
    with autograd.record(train_mode=False):
        assert not autograd.is_training()
        with autograd.train_mode():
            assert autograd.is_training()
    with autograd.predict_mode():
        assert not autograd.is_training()


def test_grad_req_add():
    x = mx.nd.ones((3,))
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            y = (x * 2).sum()
        y.backward()
    assert x.grad.asnumpy().tolist() == [6, 6, 6]


def test_grad_req_write_overwrites():
    x = mx.nd.ones((3,))
    x.attach_grad()
    g = x.grad
    assert g.asnumpy().tolist() == [0, 0, 0]
    for k in (2, 5):
        with autograd.record():
            y = (x * k).sum()
        y.backward()
        assert x.grad.asnumpy().tolist() == [k, k, k]
        assert g.asnumpy().tolist() == [k, k, k]   # the same NDArray


def test_grad_req_null():
    x = mx.nd.ones((3,))
    x.attach_grad(grad_req="null")
    w = mx.nd.ones((3,))
    w.attach_grad()
    with autograd.record():
        y = (x * w).sum()
    y.backward()
    assert w.grad.asnumpy().tolist() == [1, 1, 1]
    assert x.grad.asnumpy().tolist() == [0, 0, 0]


def test_multiple_use_accumulates():
    x = mx.nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x + x
    y.backward()
    assert x.grad.asscalar() == pytest.approx(5.0)


def test_head_grad():
    x = mx.nd.array([1., 2.])
    x.attach_grad()
    with autograd.record():
        y = x * 3
    y.backward(mx.nd.array([10., 100.]))
    assert x.grad.asnumpy().tolist() == [30, 300]


def test_detach_blocks():
    x = mx.nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    assert x.grad.asscalar() == pytest.approx(4.0)


def test_block_grad_op():
    x = mx.nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = mx.nd.BlockGrad(x * x) * x
    y.backward()
    assert x.grad.asscalar() == pytest.approx(4.0)


def test_deep_chain():
    x = mx.nd.array([1.5])
    x.attach_grad()
    with autograd.record():
        y = x
        for _ in range(30):
            y = y * 1.1
    y.backward()
    assert x.grad.asscalar() == pytest.approx(1.1 ** 30, rel=1e-4)


def test_autograd_grad_function():
    x = mx.nd.array([3.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
    g = autograd.grad(y, x)
    assert g.asscalar() == pytest.approx(6.0)
    assert x.grad.asscalar() == 0.0          # .grad untouched


def test_custom_function():
    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = mx.nd.array([0.5, -1.0])
    x.attach_grad()
    f = Sigmoid()
    with autograd.record():
        y = f(x)
    y.backward()
    s = 1 / (1 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(x.grad.asnumpy(), s * (1 - s), rtol=1e-4)
    # outside record the forward runs alone
    assert f(x).shape == (2,)


def test_backward_through_multiple_heads():
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        a = x * 2
        b = x * 3
    autograd.backward([a, b])
    assert x.grad.asnumpy().tolist() == [5, 5]


def test_error_outside_record():
    x = mx.nd.ones((2,))
    y = x * 2
    with pytest.raises(MXNetError, match="not part of a recorded"):
        y.backward()
    x.attach_grad()
    z = x * 2                                # attached, but not recorded
    with pytest.raises(MXNetError, match="not part of a recorded"):
        z.backward()


def test_second_backward_needs_retain_graph():
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    assert x.grad.asnumpy().tolist() == [2, 4]
    with pytest.raises(MXNetError, match="retain_graph"):
        y.backward()


def test_mark_variables():
    x = mx.nd.array([1.0, 2.0])
    g = mx.nd.zeros((2,))
    autograd.mark_variables([x], [g], grad_reqs="add")
    for _ in range(2):
        with autograd.record():
            y = (x * x).sum()
        y.backward()
    assert x.grad is g
    assert g.asnumpy().tolist() == [4, 8]


# -- MXNet's gradient requests on gluon parameters ----------------------

def test_parameter_write_gradient_is_overwritten_by_each_backward():
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    x = mx.nd.array(np.ones((4, 3), np.float32))
    for _ in range(2):
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
    np.testing.assert_allclose(net.weight.grad()._data.numpy(),
                               np.full((2, 3), 4.0))
    net.weight.grad_req = "add"
    for _ in range(2):
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
    np.testing.assert_allclose(net.weight.grad()._data.numpy(),
                               np.full((2, 3), 8.0))


def test_block_called_with_ndarrays_returns_ndarrays():
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    x = np.ones((4, 3), np.float32)
    out = net(mx.nd.array(x))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (4, 2)
    assert not out._data.requires_grad       # not recorded outside record
    t = net(out._data.new_ones((4, 3)))
    assert not isinstance(t, mx.nd.NDArray)
    np.testing.assert_allclose(out.asnumpy(), t.detach().numpy())


# -- gradients against the JAX package ----------------------------------

@pytest.mark.parametrize("expr", [
    lambda nd, x, w: (nd.tanh(x * w) + nd.exp(x) / 3).sum(),
    lambda nd, x, w: nd.dot(x, w.T).sum() * 0.5,
    lambda nd, x, w: nd.log_softmax(x * w, axis=1).mean(),
    lambda nd, x, w: (nd.sqrt(x * x + 1) * nd.sigmoid(w)).max(axis=1).sum(),
    lambda nd, x, w: nd.pick(nd.softmax(x, axis=1),
                             nd.argmax(w, axis=1), axis=1).sum(),
    lambda nd, x, w: nd.concat(x, w, dim=0).reshape((-1,)).norm(),
])
def test_gradients_match_the_jax_package(expr):
    rng = np.random.RandomState(0)
    x0 = rng.randn(3, 4).astype(np.float32)
    w0 = rng.randn(3, 4).astype(np.float32)
    grads = []
    for pkg, ag in ((jmx, jautograd), (mx, autograd)):
        x, w = pkg.nd.array(x0), pkg.nd.array(w0)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            y = expr(pkg.nd, x, w)
        y.backward()
        grads.append((float(y.asscalar()), x.grad.asnumpy(),
                      w.grad.asnumpy()))
    (jy, jgx, jgw), (ty, tgx, tgw) = grads
    assert ty == pytest.approx(jy, rel=RTOL)
    np.testing.assert_allclose(tgx, jgx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgw, jgw, rtol=RTOL, atol=ATOL)
