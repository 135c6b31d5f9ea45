"""The LeNet/MNIST path (``examples/gluon_mnist.py``) on the port against
the JAX package on the CPU: the example's net at full width (Conv2D 32
and 64, 3x3, relu, MaxPool 2, Dense 128 relu, Dropout 0.5, Dense 10,
NCHW), Xavier weights carried across by ``params_from_numpy`` under
structural names (the children are made outside the net's name scope,
so their automatic names follow each package's counters), batch 8,
three SGD steps (lr 0.05, momentum 0.9) through ``autograd.record``,
``loss.backward()`` and ``Trainer.step``, imperative and hybridized,
under ``record(train_mode=False)`` so dropout is off in both.

Tolerance, that of ``test_torch_train_step.py``: losses within 1e-5
relative, every parameter within 1e-4 relative / 2e-6 absolute after
three steps (fp32 convolutions summed in another order by two
libraries)."""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy

EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples", "gluon_mnist.py")
SGD = {"learning_rate": 0.05, "momentum": 0.9}


def _example():
    spec = importlib.util.spec_from_file_location("gluon_mnist", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_net(layout="NCHW"):
    """The example's ``build_net`` on the port."""
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(32, kernel_size=3, activation="relu",
                            layout=layout),
            gluon.nn.Conv2D(64, kernel_size=3, activation="relu",
                            layout=layout),
            gluon.nn.MaxPool2D(2, layout=layout),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dropout(0.5),
            gluon.nn.Dense(10))
    return net


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, 256, (n, 1, 28, 28)) / 255.0).astype(np.float32)
    return x, rng.randint(0, 10, n).astype(np.int32)


def _train(pkg, ag, net, x, y, steps=3):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", SGD)
    data, label = pkg.nd.array(x), pkg.nd.array(y)
    losses = []
    for _ in range(steps):
        with ag.record(train_mode=False):
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(len(x))
        losses.append(float(loss.mean().asscalar()))
    return losses


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's example net: initial weights, and losses and
    weights after three steps, imperative and hybridized."""
    x, y = _batch()
    out = {}
    with jax.default_matmul_precision("highest"):
        for hybrid in (False, True):
            np.random.seed(0)
            net = _example().build_net()
            net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
            with jautograd.pause():
                net(jmx.nd.array(x))
            init = {n: p.data().asnumpy() for n, p in
                    net._collect_params_with_prefix().items()}
            if hybrid:
                net.hybridize()
            losses = _train(jmx, jautograd, net, x, y)
            final = {n: p.data().asnumpy()
                     for n, p in net._collect_params_with_prefix().items()}
            out[hybrid] = (init, losses, final)
    return out


@pytest.mark.parametrize("hybrid", [False, True])
def test_example_net_trains_like_the_jax_package(jax_reference, hybrid):
    init, jlosses, want = jax_reference[hybrid]
    x, y = _batch()
    with mx.cpu():
        net = build_net()
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x))                  # deferred shapes
        params_from_numpy(net, init)
        if hybrid:
            net.hybridize()
        losses = _train(mx, autograd, net, x, y)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = {n: p.data()._data.detach().numpy()
           for n, p in net._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(want) and len(got) == 8
    assert sum(v.size for v in got.values()) == 1199882
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def test_ndarray_loop_matches_the_tensor_loop():
    """The same three steps driven with tensors (the earlier slices'
    entry) and with NDArrays leave the same weights."""
    x, y = _batch(1)
    finals = []
    for wrap in (mx.nd.array, lambda a: mx.nd.array(a)._data):
        net = build_net()
        net.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                       generator=torch.Generator().manual_seed(3))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "sgd", SGD)
        with mx.cpu():
            data, label = wrap(x), wrap(y)
        for _ in range(3):
            with autograd.record(train_mode=False):
                loss = loss_fn(net(data), label)
            loss.backward() if isinstance(loss, mx.nd.NDArray) \
                else loss.sum().backward()
            trainer.step(len(x))
        finals.append([p.data()._data.detach().numpy().copy()
                       for p in net.collect_params().values()])
    for a, b in zip(*finals):
        np.testing.assert_array_equal(a, b)
