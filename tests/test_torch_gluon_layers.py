"""The ``gluon.nn`` layers of the layer slice against the JAX package's
on the CPU: activations, the 1-D/3-D and transposed convolutions, the
pools (each layout the JAX layer takes, ``ceil_mode``,
``count_include_pad``), ``ReflectionPad2D``, ``InstanceNorm``,
``GroupNorm``, ``SyncBatchNorm``, ``Lambda``/``HybridLambda`` and the
``nn`` re-exports.  Each layer is built in both packages, the JAX one's
weights set from seeded numpy and carried across by
``params_from_numpy``; forward under ``record`` and the gradients of the
input and of every parameter under a head gradient that is not ones.

Tolerance: 1e-5 relative / 1e-5 absolute (fp32 convolutions summed in
another order by two libraries)."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pair(make, x):
    """The JAX layer with seeded weights and the port's with the same."""
    jb = make(jnn)
    jb.initialize(ctx=jmx.cpu())
    with jautograd.pause():
        jb(jmx.nd.array(x, ctx=jmx.cpu()))
    for i, (name, p) in enumerate(sorted(jb.collect_params().items())):
        if p.grad_req == "null" and "running_var" in name:
            p.set_data(jmx.nd.array(np.random.default_rng(i).random(
                p.shape).astype(np.float32) + 0.5, ctx=jmx.cpu()))
        else:
            p.set_data(jmx.nd.array(_rand(*p.shape, seed=10 + i) * 0.5,
                                    ctx=jmx.cpu()))
    tb = make(tnn)
    tb.initialize(device="cpu")
    params_from_numpy(tb, {n: p.data().asnumpy() for n, p in
                           jb.collect_params().items()}, prefix=jb.prefix)
    return jb, tb


def _grads(block, prefix):
    return {n[len(prefix):]: p.grad().asnumpy()
            for n, p in block.collect_params().items()
            if p.grad_req != "null"}


def _same(make, x, tol=TOL, train=True):
    jb, tb = _pair(make, x)
    jx = jmx.nd.array(x, ctx=jmx.cpu())
    tx = tmx.nd.array(x)
    jx.attach_grad()
    tx.attach_grad()
    with jautograd.record(train_mode=train):
        jout = jb(jx)
    with autograd.record(train_mode=train):
        tout = tb(tx)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **tol)
    head = _rand(*jout.shape, seed=7) + 1.5
    jout.backward(jmx.nd.array(head, ctx=jmx.cpu()))
    tout.backward(tmx.nd.array(head))
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               err_msg="input grad", **tol)
    jg, tg = _grads(jb, jb.prefix), _grads(tb, tb.prefix)
    assert sorted(jg) == sorted(tg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], err_msg=name, **tol)
    return tb, tout


ACTIVATIONS = [
    ("leaky", lambda nn: nn.LeakyReLU(0.1)),
    ("prelu", lambda nn: nn.PReLU(in_channels=3)),
    ("elu", lambda nn: nn.ELU(0.6)),
    ("selu", lambda nn: nn.SELU()),
    ("gelu", lambda nn: nn.GELU()),
    ("swish", lambda nn: nn.Swish(1.5)),
]


@pytest.mark.parametrize("case,make", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_activation_layers(case, make):
    _same(make, _rand(2, 3, 4, 5))


def test_prelu_alpha_is_a_parameter_initialized_as_in_the_jax_package():
    jb, tb = jnn.PReLU(), tnn.PReLU(in_channels=4)
    jb.initialize(ctx=jmx.cpu())
    tb.initialize(device="cpu")
    assert jb.alpha.shape == (1,) and tb.alpha.shape == (4,)
    np.testing.assert_array_equal(tb.alpha.data().asnumpy(), 0)
    assert tb.alpha.name.endswith("alpha")


CONVS = [
    ("conv1d_ncw", lambda nn: nn.Conv1D(4, 3, strides=2, padding=1,
                                        dilation=1), (2, 3, 9)),
    ("conv1d_nwc", lambda nn: nn.Conv1D(4, 3, padding=2, dilation=2,
                                        layout="NWC", use_bias=False),
     (2, 9, 3)),
    ("conv3d_ncdhw", lambda nn: nn.Conv3D(4, (2, 3, 3), strides=(1, 2, 1),
                                          padding=(0, 1, 1)),
     (2, 3, 4, 6, 5)),
    ("conv3d_ndhwc", lambda nn: nn.Conv3D(4, 3, padding=1, groups=1,
                                          layout="NDHWC",
                                          activation="relu"),
     (2, 4, 5, 5, 3)),
    ("conv2dt_nchw", lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 3, 5, 6)),
    ("conv2dt_nhwc", lambda nn: nn.Conv2DTranspose(
        4, (3, 2), strides=(2, 1), padding=(1, 0), layout="NHWC"),
     (2, 5, 6, 3)),
    ("conv2dt_groups", lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, groups=2, in_channels=4, use_bias=False),
     (2, 4, 4, 4)),
    ("conv1dt_ncw", lambda nn: nn.Conv1DTranspose(
        5, 4, strides=3, padding=1, output_padding=2), (2, 3, 7)),
    ("conv1dt_nwc", lambda nn: nn.Conv1DTranspose(
        5, 3, strides=2, layout="NWC", activation="tanh"), (2, 7, 3)),
]


@pytest.mark.parametrize("case,make,shape", CONVS,
                         ids=[c[0] for c in CONVS])
def test_convolution_layers(case, make, shape):
    _same(make, _rand(*shape))


POOLS = [
    ("max1d_ncw", lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 9)),
    ("max1d_nwc_ceil", lambda nn: nn.MaxPool1D(2, layout="NWC",
                                               ceil_mode=True), (2, 9, 3)),
    ("max3d", lambda nn: nn.MaxPool3D(2, 2), (2, 3, 4, 6, 5)),
    ("max3d_ndhwc", lambda nn: nn.MaxPool3D((2, 3, 2), (1, 2, 2), 1,
                                            layout="NDHWC",
                                            ceil_mode=True),
     (2, 4, 7, 5, 3)),
    ("avg1d", lambda nn: nn.AvgPool1D(3, 2, 1, count_include_pad=False),
     (2, 3, 9)),
    ("avg1d_nwc", lambda nn: nn.AvgPool1D(2, layout="NWC"), (2, 8, 3)),
    ("avg2d", lambda nn: nn.AvgPool2D(3, 2, 1), (2, 3, 7, 8)),
    ("avg2d_nhwc_ceil_nopad", lambda nn: nn.AvgPool2D(
        3, 2, 1, layout="NHWC", ceil_mode=True, count_include_pad=False),
     (2, 8, 7, 3)),
    ("avg2d_densenet_transition", lambda nn: nn.AvgPool2D(
        2, 2, layout="NHWC"), (2, 8, 8, 5)),
    ("avg3d", lambda nn: nn.AvgPool3D(2, ceil_mode=True), (2, 3, 5, 5, 4)),
    ("avg3d_ndhwc", lambda nn: nn.AvgPool3D(2, 1, 1, layout="NDHWC",
                                            count_include_pad=False),
     (2, 4, 4, 4, 3)),
    ("gmax1d", lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9)),
    ("gmax2d_nhwc", lambda nn: nn.GlobalMaxPool2D(layout="NHWC"),
     (2, 5, 6, 3)),
    ("gmax3d", lambda nn: nn.GlobalMaxPool3D(), (2, 3, 4, 5, 2)),
    ("gavg1d_nwc", lambda nn: nn.GlobalAvgPool1D(layout="NWC"), (2, 9, 3)),
    ("gavg3d_ndhwc", lambda nn: nn.GlobalAvgPool3D(layout="NDHWC"),
     (2, 4, 5, 2, 3)),
    ("reflection_pad", lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
    ("reflection_pad_hw", lambda nn: nn.ReflectionPad2D((1, 3)),
     (1, 2, 5, 6)),
]


@pytest.mark.parametrize("case,make,shape", POOLS,
                         ids=[p[0] for p in POOLS])
def test_pooling_and_padding_layers(case, make, shape):
    _same(make, _rand(*shape))


NORMS = [
    ("instance", lambda nn: nn.InstanceNorm(), (2, 3, 5, 6)),
    ("instance_scaled", lambda nn: nn.InstanceNorm(scale=True,
                                                   epsilon=1e-3),
     (2, 3, 7)),
    ("group", lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 5, 6)),
    ("group_no_center", lambda nn: nn.GroupNorm(num_groups=4, center=False,
                                                in_channels=4),
     (2, 4, 3, 3)),
    ("syncbn_nchw", lambda nn: nn.SyncBatchNorm(num_devices=2), (4, 3, 5, 5)),
    ("syncbn_nhwc", lambda nn: nn.SyncBatchNorm(axis=3, momentum=0.8),
     (4, 5, 5, 3)),
]


@pytest.mark.parametrize("case,make,shape", NORMS,
                         ids=[n[0] for n in NORMS])
@pytest.mark.parametrize("train", [True, False])
def test_normalization_layers(case, make, shape, train):
    _same(make, _rand(*shape) * 2 + 1, train=train)


def test_lambda_layers():
    x = _rand(2, 3, 4)
    _same(lambda nn: nn.HybridLambda("tanh"), x)
    _same(lambda nn: nn.HybridLambda(lambda F, a: F.relu(a) * 2), x)
    _same(lambda nn: nn.HybridLambda(
        lambda F, a: F.LeakyReLU(a, act_type="elu", slope=0.3)), x)
    jb, tb = jnn.Lambda(lambda a: a * 3), tnn.Lambda(lambda a: a * 3)
    np.testing.assert_allclose(tb(tmx.nd.array(x)).asnumpy(),
                               jb(jmx.nd.array(x)).asnumpy())
    got = tnn.Lambda("sigmoid")(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, jmx.nd.sigmoid(jmx.nd.array(x))
                               .asnumpy(), rtol=1e-6)


def test_layers_compose_and_hybridize_in_a_sequential():
    """A small net of the new layers, hybridized in the port (the
    shape-keyed cache; eager on the CPU), against the JAX net."""
    def make(nn):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1), nn.InstanceNorm(),
                    nn.LeakyReLU(0.2), nn.Conv2DTranspose(3, 2, strides=2),
                    nn.GroupNorm(num_groups=3), nn.PReLU(), nn.AvgPool2D(2),
                    nn.GELU(), nn.GlobalMaxPool2D(), nn.Flatten())
        return net
    x = _rand(2, 3, 6, 6)
    jb, tb = _pair(make, x)
    tb.hybridize()
    out = tb(tmx.nd.array(x))
    np.testing.assert_allclose(out.asnumpy(),
                               jb(jmx.nd.array(x)).asnumpy(), **TOL)


def test_nn_reexports_match_the_jax_package():
    missing = sorted(n for n in dir(jnn) if not n.startswith("_")
                     and not hasattr(tnn, n))
    assert missing == []
    from mxnet_tpu_torch.gluon import block
    assert tnn.Block is block.Block and tnn.HybridBlock is block.HybridBlock
    assert tnn.SymbolBlock is block.SymbolBlock
