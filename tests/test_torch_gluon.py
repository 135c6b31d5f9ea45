"""The port's operators and gluon layer (``mxnet_tpu_torch.ops``,
``mxnet_tpu_torch.gluon``) against the JAX package's, on the CPU: the
same numpy inputs through both.

Tolerances: 1e-5 on convolution, pooling and BatchNorm outputs (fp32
sums in another order); 1e-6 on the running statistics and the SGD
update (a handful of fp32 operations); the three-step fusion-site
trajectory 5e-4 relative / 5e-5 absolute, the JAX package's own bound
for its fused-vs-unfused trajectory."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import optimizer_ops as jopt

import mxnet_tpu_torch.ops as F
from mxnet_tpu_torch import MXNetError, autograd, gluon, initializer
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.nn.basic_layers import _bn_relu_fusion_plan


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# -- operators ---------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,pad,groups", [(1, 1, 1), (2, 3, 1),
                                               (2, 0, 2)])
def test_convolution_matches_jax(layout, stride, pad, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 9).astype(np.float32)
    w = rng.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    kw = dict(kernel=(3, 3), stride=(stride, stride), pad=(pad, pad),
              num_filter=6, num_group=groups, layout=layout)
    want = jnn._convolution.fcompute(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), **kw)
    got = F.Convolution(_t(x), _t(w), _t(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,convention,count_include_pad", [
    ("max", "valid", True), ("max", "full", True), ("avg", "valid", True),
    ("avg", "full", True), ("avg", "valid", False), ("avg", "full", False)])
def test_pooling_matches_jax(layout, pool_type, convention,
                             count_include_pad):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 10, 10).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool_type,
              pooling_convention=convention,
              count_include_pad=count_include_pad, layout=layout)
    want = jnn._pooling.fcompute(jnp.asarray(x), **kw)
    got = F.Pooling(_t(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling_matches_jax(layout, pool_type):
    x = np.random.RandomState(2).randn(2, 5, 5, 7).astype(np.float32)
    kw = dict(global_pool=True, pool_type=pool_type, layout=layout)
    want = jnn._pooling.fcompute(jnp.asarray(x), **kw)
    got = F.Pooling(_t(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("axis,training,use_global,fix_gamma", [
    (1, True, False, False), (3, True, False, False), (3, True, False, True),
    (1, False, False, False), (3, True, True, False)])
def test_batch_norm_and_running_stats_match_jax(axis, training, use_global,
                                                fix_gamma):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 5, 6) * 3 + 2).astype(np.float32)
    c = x.shape[axis]
    gamma, beta = rng.rand(c) + 0.5, rng.randn(c)
    mm, mv = rng.randn(c) * 0.1, rng.rand(c) + 0.5
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
              use_global_stats=use_global, axis=axis, training=training)
    jargs = [jnp.asarray(a, jnp.float32) for a in (x, gamma, beta, mm, mv)]
    want = jnn._batch_norm.fcompute(*jargs, **kw)
    got = F.BatchNorm(*(_t(a) for a in (x, gamma, beta, mm, mv)), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_batch_norm_grads_match_jax():
    """The plain BatchNorm differentiates through its batch statistics,
    as the JAX op does."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3, 3, 5).astype(np.float32)
    gamma, beta = rng.rand(5) + 0.5, rng.randn(5)
    mm, mv = np.zeros(5), np.ones(5)

    def jloss(x, g, b):
        o, _, _ = jnn._batch_norm.fcompute(
            x, g, b, jnp.asarray(mm, jnp.float32),
            jnp.asarray(mv, jnp.float32), fix_gamma=False, axis=3,
            training=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (x, gamma, beta)))
    ts = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    o, _, _ = F.BatchNorm(*ts, _t(mm), _t(mv), fix_gamma=False, axis=3,
                          training=True)
    (o * torch.cos(o)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-5)


def test_softmax_cross_entropy_loss_matches_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(6, 10).astype(np.float32)
    label = rng.randint(0, 10, 6).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(mx.nd.array(pred),
                                                 mx.nd.array(label))
    got = gluon.loss.SoftmaxCrossEntropyLoss()(_t(pred), _t(label))
    assert tuple(got.shape) == (6,)
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    total = jnn._softmax_cross_entropy.fcompute(jnp.asarray(pred),
                                                jnp.asarray(label))
    np.testing.assert_allclose(
        F.softmax_cross_entropy(_t(pred), _t(label)).item(), float(total),
        rtol=1e-6)


def test_l2_loss_matches_jax():
    rng = np.random.RandomState(6)
    pred, label = rng.randn(2, 4, 3).astype(np.float32)
    want = jgluon.loss.L2Loss()(mx.nd.array(pred), mx.nd.array(label))
    got = gluon.loss.L2Loss()(_t(pred), _t(label))
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("wd,clip", [(0.0, -1.0), (1e-4, 0.5)])
def test_sgd_mom_update_matches_jax(wd, clip):
    rng = np.random.RandomState(7)
    w, g, m = rng.randn(3, 20).astype(np.float32)
    kw = dict(lr=0.05, momentum=0.9, wd=wd, rescale_grad=0.25,
              clip_gradient=clip)
    jw, jm = jopt._sgd_mom_update.fcompute(jnp.asarray(w), jnp.asarray(g),
                                           jnp.asarray(m), **kw)
    tw, tm = _t(w), _t(m)
    F.sgd_mom_update(tw, _t(g), tm, **kw)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)


# -- gluon -------------------------------------------------------------

def _fusion_net(pkg):
    net = pkg.nn.HybridSequential(prefix="fusion_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
                pkg.nn.BatchNorm(axis=3), pkg.nn.Activation("relu"),
                pkg.nn.Flatten(), pkg.nn.Dense(4))
    return net


def test_gluon_fusion_site_trajectory_matches_jax(monkeypatch):
    """The JAX package's fusion-site test, held against the port: a
    HybridSequential whose BatchNorm+relu pair runs fused, three steps
    of autograd.record / backward / Trainer.step; loss, parameters and
    running statistics stay with the JAX package's (kernel tier armed,
    Pallas in interpret mode)."""
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    x = np.random.RandomState(0).rand(2, 6, 6, 3).astype(np.float32)
    y = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    np.random.seed(0)
    jnet = _fusion_net(jgluon)
    jnet.initialize(ctx=mx.cpu())
    with jautograd.pause():
        jnet(mx.nd.array(x))
    arrays = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    tnet = _fusion_net(gluon)
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, arrays)
    assert _bn_relu_fusion_plan(tnet._children.values(), 4)[1][1]

    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore=None)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    jlf, tlf = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    for _ in range(3):
        with jautograd.record():
            jl = jlf(jnet(mx.nd.array(x)), mx.nd.array(y)).mean()
        jl.backward()
        jtr.step(2)
        with autograd.record():
            tl = tlf(tnet(_t(x)), _t(y)).mean()
        tl.backward()
        ttr.step(2)
        assert abs(float(jl.asscalar()) - tl.item()) < 1e-5
    for (jn, jp), (tn, tp) in zip(jnet.collect_params().items(),
                                  tnet.collect_params().items()):
        assert jn[len(jnet.prefix):] == tn[len(tnet.prefix):]
        np.testing.assert_allclose(tp.data()._data.detach().numpy(),
                                   jp.data().asnumpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=tn)


def test_fusion_plan_pairs_channels_last_batchnorm_with_relu():
    bn_last = gluon.nn.BatchNorm(axis=3)
    bn_first = gluon.nn.BatchNorm(axis=1)
    relu = gluon.nn.Activation("relu")
    tanh = gluon.nn.Activation("tanh")
    assert _bn_relu_fusion_plan([bn_last, relu], 4) == [(bn_last, True)]
    assert _bn_relu_fusion_plan([bn_first, relu], 4) == [(bn_first, False),
                                                         (relu, False)]
    assert _bn_relu_fusion_plan([bn_last, tanh], 4) == [(bn_last, False),
                                                        (tanh, False)]
    assert _bn_relu_fusion_plan([relu, bn_last], 4) == [(relu, False),
                                                        (bn_last, False)]


def test_unpaired_channels_first_batchnorm_runs_unfused():
    """A channels-first BatchNorm before a relu runs BatchNorm then
    Activation: the same numbers as the fused op on the same data moved
    to channels-last."""
    x = np.random.RandomState(8).randn(2, 3, 4, 4).astype(np.float32)
    nets = []
    for layout in ("NCHW", "NHWC"):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.BatchNorm(axis=layout.index("C")),
                gluon.nn.Activation("relu"))
        net.initialize(device="cpu")
        nets.append(net)
    with autograd.train_mode():
        a = nets[0](_t(x))
        b = nets[1](_t(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(a.detach().numpy().transpose(0, 2, 3, 1),
                               b.detach().numpy(), rtol=1e-5, atol=1e-6)
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        np.testing.assert_allclose(p.data()._data.detach().numpy(),
                                   q.data()._data.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_resnet50_v1_nhwc_wires_up():
    """The full-width graph on the CPU at 1x64x64: output shape,
    parameter count and names, no JAX involved."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1(layout="NHWC")
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        out = net(torch.zeros(1, 64, 64, 3))
    assert tuple(out.shape) == (1, 1000)
    params = net.collect_params()
    assert len(params) == 53 * 4 + 53 + 32 + 2     # BN, conv, conv bias, FC
    n_weights = sum(p.data()._data.numel() for p in params.values()
                    if p.grad_req != "null")
    assert n_weights == 25_575_912
    w = params[net.prefix + "conv2d0_weight"]
    assert tuple(w.shape) == (64, 7, 7, 3)          # OHWI


def test_resnet_names_match_the_jax_package():
    from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as j18
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1 as t18
    jnet, tnet = j18(layout="NHWC"), t18(layout="NHWC")
    jn = [n[len(jnet.prefix):] for n in jnet.collect_params().keys()]
    tn = [n[len(tnet.prefix):] for n in tnet.collect_params().keys()]
    assert jn == tn


def test_params_from_numpy_checks_names_and_shapes():
    net = gluon.nn.Dense(3, in_units=2)
    net.initialize(device="cpu")
    good = {"dense9_weight": np.ones((3, 2), np.float32),
            "dense9_bias": np.arange(3, dtype=np.float32)}
    params_from_numpy(net, good)
    np.testing.assert_array_equal(net.bias.data()._data.detach().numpy(),
                                  [0, 1, 2])
    with pytest.raises(MXNetError, match="missing"):
        params_from_numpy(net, {"dense9_weight": good["dense9_weight"]})
    with pytest.raises(MXNetError, match="extra"):
        params_from_numpy(net, dict(good, dense9_gamma=np.ones(3)))
    with pytest.raises(MXNetError, match=r"\(3, 2\)"):
        params_from_numpy(net, dict(good, dense9_weight=np.ones((2, 3))))


def test_deferred_init_finishes_at_the_first_forward():
    net = gluon.nn.Dense(4)
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    with pytest.raises(gluon.DeferredInitializationError):
        net.weight.data()
    out = net(torch.ones(2, 5, 3))
    assert tuple(out.shape) == (2, 4)
    assert tuple(net.weight.shape) == (4, 15)
    assert isinstance(net.weight.data()._data, torch.nn.Parameter)


def test_initializers_fill_by_name_and_draw_from_the_generator():
    init = initializer.Uniform(0.07)
    for name, value in (("x_bias", 0.0), ("x_gamma", 1.0), ("x_beta", 0.0),
                        ("x_running_mean", 0.0), ("x_running_var", 1.0)):
        t = torch.full((3,), 7.0)
        init(name, t)
        assert torch.all(t == value), name
    a, b = torch.empty(50), torch.empty(50)
    init("w_weight", a, torch.Generator().manual_seed(3))
    init("w_weight", b, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.abs().max() <= 0.07 and a.std() > 0
    x = torch.empty(64, 3, 3, 3)
    initializer.Xavier(magnitude=3)("c_weight", x,
                                    torch.Generator().manual_seed(0))
    assert x.abs().max() <= (3.0 / ((27 + 576) / 2)) ** 0.5
    assert isinstance(initializer.create("zeros"), initializer.Zero)
    with pytest.raises(MXNetError):
        initializer.create("nope")


def test_block_naming_follows_mxnet():
    class Outer(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.a = gluon.nn.Dense(2, in_units=2)
                self.b = gluon.nn.Dense(2, in_units=2)

        def hybrid_forward(self, F, x):
            return self.b(self.a(x))

    net = Outer(prefix="outer_")
    assert sorted(net.collect_params().keys()) == [
        "outer_dense0_bias", "outer_dense0_weight", "outer_dense1_bias",
        "outer_dense1_weight"]
    assert list(net.collect_params("outer_dense1_.*").keys()) == [
        "outer_dense1_weight", "outer_dense1_bias"]
    assert isinstance(net, torch.nn.Module)
    assert list(dict(net.named_children())) == ["a", "b"]


def test_autograd_scopes_set_flags_and_grad_mode():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert not autograd.is_training()


def test_trainer_keeps_write_semantics():
    """``grad_req="write"``: each backward's gradient replaces the last
    one, as in MXNet, though PyTorch accumulates."""
    net = gluon.nn.Dense(1, in_units=1, use_bias=False)
    net.initialize(init="one", device="cpu")
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    for _ in range(2):
        with autograd.record():
            out = net(torch.ones(1, 1))
        out.sum().backward()
        tr.step(1)
    assert net.weight.data()._data.item() == pytest.approx(-1.0)
    # the default single-process kvstore is accepted; a multi-process one
    # is not ported yet
    assert tr._kvstore.type == "device"
    with pytest.raises(MXNetError, match="item 9"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")


def test_initialize_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = gluon.nn.Dense(2, in_units=2)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        net.initialize()
    net.initialize(device="cpu")
    assert net.weight.data()._data.device.type == "cpu"
