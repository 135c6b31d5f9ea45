"""The port's AMP (``mxnet_tpu_torch.amp``: the casts at the op
namespace, ``LossScaler``, the fp16 ``Trainer`` and ``TrainStep``
integration) against the JAX package's ``mxnet_tpu.amp``, on the CPU:
the counterparts of ``tests/test_amp.py``, and one parity test of a
narrow NHWC ResNet forward under ``amp.scope("bfloat16")`` in both
packages (the JAX one with its kernel tier armed, as the training
slice runs it).

Tolerances: the dtype of every layer's output must be equal; the bf16
logits of the two packages lie within three times the distance of the
JAX package's bf16 forward from its own fp32 forward (measured 1.9e-6
against that floor of 1.6e-6, at logits of magnitude 3.5e-4: bf16
keeps 8 bits, and the two packages round the convolutions' and the
BatchNorms' bf16 outputs in other places); weights after a scaled and
an unscaled step 1e-5 relative (fp32 with a power-of-two scale)."""
import numpy as np
import pytest

import jax
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.kernels import fused_bn_relu as jfused
from mxnet_tpu.ops import nn as jops_nn

from mxnet_tpu_torch import MXNetError, amp, autograd, gluon, ops
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import TrainStep

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)


def _mlp(seed=0):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu", in_units=8),
            gluon.nn.Dense(4, in_units=32))
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    return net


def _xy(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((n, 8)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((n, 4)), dtype=torch.float32))


def test_products_run_in_bf16_and_softmax_in_fp32_only_in_scope():
    x = torch.ones(4, 8)
    w = torch.ones(3, 8)
    img = torch.ones(2, 6, 6, 3)
    k = torch.ones(5, 3, 3, 3)
    with amp.scope("bfloat16"):
        assert amp.is_active() and amp.target_dtype() == torch.bfloat16
        assert amp.policy_token() == "bfloat16"
        fc = ops.FullyConnected(x, w, None, num_hidden=3, no_bias=True)
        conv = ops.Convolution(img, k, kernel=(3, 3), num_filter=5,
                               no_bias=True, layout="NHWC")
        assert fc.dtype == conv.dtype == torch.bfloat16
        assert ops.log_softmax(fc).dtype == torch.float32
        # an op on no list passes its dtype through
        assert ops.Activation(fc).dtype == torch.bfloat16
    assert not amp.is_active() and amp.policy_token() is None
    assert ops.FullyConnected(x, w, None, num_hidden=3,
                              no_bias=True).dtype == torch.float32
    assert ops.Convolution(img, k, kernel=(3, 3), num_filter=5,
                           no_bias=True, layout="NHWC").dtype \
        == torch.float32


def test_casts_follow_the_jax_lists():
    bf = torch.ones(3, dtype=torch.bfloat16)
    f32 = torch.ones(3)
    labels = torch.ones(3, dtype=torch.int64)
    assert amp.apply_op_casts("Convolution", [f32, labels, 7]) \
        == [f32, labels, 7]              # inactive: unchanged
    with amp.scope("float16"):
        assert [t.dtype for t in amp.apply_op_casts("dot", [f32, bf])] \
            == [torch.float16] * 2
        out = amp.apply_op_casts("Convolution", [f32, labels, "NHWC"])
        assert out[1] is labels and out[2] == "NHWC"
        assert [t.dtype for t in amp.apply_op_casts("softmax", [bf])] \
            == [torch.float32]
        # widest: fp32 meeting a narrower float lifts both; bf16 alone
        # stays
        assert [t.dtype for t in amp.apply_op_casts("broadcast_add",
                                                    [bf, f32])] \
            == [torch.float32] * 2
        assert amp.apply_op_casts("broadcast_add", [bf, bf])[0].dtype \
            == torch.bfloat16
    assert sorted(amp.lists.TARGET_DTYPE_OPS) \
        == sorted(jamp.lists.TARGET_DTYPE_OPS)
    assert sorted(amp.lists.FP32_OPS) == sorted(jamp.lists.FP32_OPS)
    assert sorted(amp.lists.WIDEST_TYPE_CASTS) \
        == sorted(jamp.lists.WIDEST_TYPE_CASTS)


def test_fp32_params_keep_fp32_gradients():
    net = _mlp()
    x, y = _xy()
    with amp.scope("bfloat16"):
        with autograd.record():
            out = net(x)
            loss = gluon.loss.L2Loss()(out, y)
        assert out.dtype == torch.bfloat16
        loss.sum().backward()
    for p in net.collect_params().values():
        assert p.data()._data.dtype == torch.float32
        assert p.grad()._data.dtype == torch.float32
        assert float(p.grad()._data.abs().sum()) > 0


def test_init_rejects_a_bad_dtype_and_scope_restores():
    with pytest.raises(MXNetError, match="bfloat16 or float16"):
        amp.init("float64")
    with pytest.raises(JMXNetError, match="bfloat16 or float16"):
        jamp.init("float64")
    amp.init("float16")
    try:
        with amp.scope("bfloat16"):
            assert amp.target_dtype() == torch.bfloat16
        assert amp.target_dtype() == torch.float16
    finally:
        amp.shutdown()
    net = _mlp()
    assert amp.convert_hybrid_block(net) is net and amp.is_active()
    amp.shutdown()
    assert not amp.is_active()


def test_loss_scaler_dynamics_match_jax():
    """The same overflow sequence through both scalers: halving on
    overflow, doubling after a clean window, the minimum floor, and the
    overflow check itself."""
    kw = dict(init_scale=8.0, scale_window=2, min_scale=2.0)
    t, j = amp.LossScaler(**kw), jamp.LossScaler(**kw)
    ok = [np.ones(3, np.float32), np.arange(4, dtype=np.float32)]
    bad = ok + [np.array([1.0, np.inf], np.float32)]
    nan = [np.array([np.nan], np.float32)]
    for grads in (ok, bad, nan):
        assert t.has_overflow([torch.tensor(g) for g in grads] + [None]) \
            == j.has_overflow([mx.nd.array(g) for g in grads])
    assert not t.has_overflow([])
    for overflow in (False, True, False, False, False, True, True, True,
                     False, False):
        t.update_scale(overflow)
        j.update_scale(overflow)
        assert t.loss_scale == j.loss_scale


def _trainer(net, lr=0.1, **kw):
    return gluon.Trainer(net.collect_params(), "sgd",
                         dict({"learning_rate": lr}, **kw))


def test_fp16_trainer_skips_on_overflow_and_halves_the_scale():
    net = _mlp(seed=7)
    tr = amp.init_trainer(_trainer(net), amp.LossScaler(init_scale=4.0))
    x, _y = _xy()
    with autograd.record():
        loss = gluon.loss.L2Loss()(net(x), torch.zeros(8, 4))
    loss.sum().backward()
    p0 = list(net.collect_params().values())[0]
    before = {p.name: p.data()._data.detach().clone()
              for p in net.collect_params().values()}
    p0.data()._data.grad.mul_(float("inf"))
    tr.step(8)
    for p in net.collect_params().values():
        assert torch.equal(before[p.name], p.data()._data.detach())
        assert p.data()._data.grad is None      # "write" gradients cleared
    assert tr._amp_loss_scaler.loss_scale == 2.0


def test_scale_loss_scales_the_gradients():
    net = _mlp(seed=9)
    tr = amp.init_trainer(_trainer(net, 0.01),
                          amp.LossScaler(init_scale=8.0))
    x, _y = _xy(n=4)
    loss_fn = gluon.loss.L2Loss()
    w = list(net.collect_params().values())[0].data()._data
    with autograd.record():
        loss = loss_fn(net(x), torch.zeros(4, 4))
        with amp.scale_loss(loss, tr) as scaled:
            scaled.sum().backward()
    g = w.grad.clone()
    w.grad = None
    with autograd.record():
        loss_fn(net(x), torch.zeros(4, 4)).sum().backward()
    np.testing.assert_allclose(g.numpy(), 8.0 * w.grad.numpy(), rtol=1e-5)
    with amp.scale_loss([loss, loss], tr) as pair:
        assert isinstance(pair, list) and len(pair) == 2


@pytest.mark.parametrize("use_unscale", [False, True])
def test_scaled_step_matches_the_unscaled_step(use_unscale):
    """The scale cancels: a scaled backward then ``step`` (with or
    without ``amp.unscale`` first) moves the weights as the plain
    backward does, dividing by the scale exactly once."""
    def run(scaled):
        net = _mlp(seed=31)
        tr = _trainer(net)
        x, y = _xy(1)
        with autograd.record():
            loss = gluon.loss.L2Loss()(net(x), y)
        if scaled:
            amp.init_trainer(tr, amp.LossScaler(init_scale=1024.0,
                                                scale_window=10 ** 9))
            with amp.scale_loss(loss, tr) as sl:
                sl.sum().backward()
            if use_unscale:
                amp.unscale(tr)
        else:
            loss.sum().backward()
        tr.step(8)
        return [p.data()._data.detach()
                for p in net.collect_params().values()]

    for a, b in zip(run(False), run(True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_train_step_with_a_scaler_skips_and_backs_off():
    net = _mlp(seed=33)
    tr = amp.init_trainer(_trainer(net, momentum=0.9),
                          amp.LossScaler(init_scale=8.0,
                                         scale_window=10 ** 9))
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    x, y = _xy(2)
    step(x, y)
    assert tr._amp_loss_scaler.loss_scale == 8.0
    before = [p.data()._data.detach().clone()
              for p in net.collect_params().values()]
    bad = x.clone()
    bad[0, 0] = float("inf")
    step(bad, y)
    assert step.last_step_finite is False
    assert tr._amp_loss_scaler.loss_scale == 4.0
    for a, p in zip(before, net.collect_params().values()):
        assert torch.equal(a, p.data()._data.detach())


def test_train_step_with_a_scaler_matches_the_unscaled_updates():
    def run(with_scaler):
        net = _mlp(seed=35)
        tr = _trainer(net)
        if with_scaler:
            amp.init_trainer(tr, amp.LossScaler(init_scale=256.0,
                                                scale_window=10 ** 9))
        step = TrainStep(net, gluon.loss.L2Loss(), tr)
        x, y = _xy(3, n=16)
        losses = [float(step(x, y)) for _ in range(3)]
        return losses, [p.data()._data.detach()
                        for p in net.collect_params().values()]

    (la, a), (lb, b) = run(False), run(True)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_run_steps_refuses_a_loss_scaler():
    net = _mlp()
    tr = amp.init_trainer(_trainer(net))
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    x, y = _xy()
    with pytest.raises(MXNetError, match="does not support fp16 dynamic "
                                         "loss scaling"):
        step.run_steps(x[None], y[None])


def _bf16_rows(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 6, 3)) * 3 + 1).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    gamma = (rng.random(3) + 0.5).astype(np.float32)
    beta = rng.standard_normal(3).astype(np.float32)
    mm = rng.standard_normal(3).astype(np.float32)
    mv = (rng.random(3) + 1).astype(np.float32)
    return x, gamma, beta, mm, mv


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_batch_norm_keeps_fp32_statistics_on_bf16_rows(fused, training):
    """A bf16 channels-last activation through ``BatchNorm`` and the
    fused BatchNorm+ReLU op in both packages: the output stays bf16, the
    fp32 running statistics stay fp32 and agree (1e-5: the same fp32
    moments of the same bf16 values), and the outputs agree within one
    bf16 rounding step of the largest."""
    x, gamma, beta, mm, mv = _bf16_rows()
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False, axis=3,
              training=training)
    jfn = jfused.fused_bn_relu if fused else jops_nn._batch_norm.fcompute
    tfn = ops.fused_batch_norm_relu if fused else ops.BatchNorm
    jout = jfn(jnp.asarray(x).astype(jnp.bfloat16),
               *(jnp.asarray(a) for a in (gamma, beta, mm, mv)), **kw)
    tout = tfn(torch.tensor(x).bfloat16(),
               *(torch.tensor(a) for a in (gamma, beta, mm, mv)), **kw)
    assert tout[0].dtype == torch.bfloat16 and jout[0].dtype == jnp.bfloat16
    for t, j in zip(tout[1:], jout[1:]):
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    want = np.asarray(jout[0].astype(jnp.float32))
    np.testing.assert_allclose(tout[0].float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    if fused:
        assert (tout[0].float().numpy() >= 0).all()


@pytest.mark.parametrize("kw", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"},
    {"global_pool": True, "pool_type": "avg"}])
def test_pooling_and_activation_pass_bf16_through(kw):
    """bf16 in, bf16 out in both packages.  The port's pooling lies
    within one bf16 rounding step of the fp32 pooling of the same values
    (it accumulates in fp32 and rounds once); the JAX package's, which
    averages in bf16, lies within its own distance from the fp32 pooling
    plus one step of the port's."""
    x = _bf16_rows(1)[0]
    exact = ops.Pooling(torch.tensor(x), layout="NHWC", **kw).numpy()
    with amp.scope("bfloat16"):
        tp = ops.Pooling(torch.tensor(x).bfloat16(), layout="NHWC", **kw)
        ta = ops.Activation(tp, act_type="relu")
    with jamp.scope("bfloat16"):
        jp = mx.nd.Pooling(mx.nd.array(x).astype("bfloat16"),
                           layout="NHWC", **kw)
        ja = mx.nd.Activation(jp, act_type="relu")
    assert tp.dtype == ta.dtype == torch.bfloat16
    assert str(jp.dtype) == str(ja.dtype) == "bfloat16"
    step = 2.0 ** -8 * np.abs(exact).max()
    got, want = tp.float().numpy(), jp.astype("float32").asnumpy()
    assert np.abs(got - exact).max() <= step
    assert np.abs(got - want).max() <= np.abs(want - exact).max() + step
    np.testing.assert_array_equal(ta.float().numpy(), np.maximum(got, 0))
    np.testing.assert_array_equal(ja.astype("float32").asnumpy(),
                                  np.maximum(want, 0))


def _layer_dtypes_port(net, x):
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, _a, out: seen.append(
            (type(m).__name__, m.prefix,
             str(out.dtype).replace("torch.", ""))))
        for m in net.modules()]
    try:
        with amp.scope("bfloat16"), autograd.pause():
            out = net(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return seen, out.float().numpy()


def _layer_dtypes_jax(net, x):
    seen = []

    def hook(b, _args, out):
        seen.append((type(b).__name__, b.prefix, str(out.dtype)))

    def walk(b):
        yield b
        for c in b._children.values():
            yield from walk(c)

    blocks = list(walk(net))
    for b in blocks:
        b.register_forward_hook(hook)
    try:
        with jamp.scope("bfloat16"), jautograd.pause():
            out = net(mx.nd.array(x))
    finally:
        for b in blocks:
            b._forward_hooks.remove(hook)
    return seen, out.astype("float32").asnumpy()


def test_resnet_layer_dtypes_and_logits_match_jax_under_bf16(monkeypatch):
    """Under ``amp.scope("bfloat16")`` every layer of a narrow NHWC
    ResNet returns the dtype the JAX package's returns (bf16 from the
    convolutions, the BatchNorm+ReLU sites, the residual adds, the
    pooling and the dense head), and the logits agree."""
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        np.random.seed(0)
        jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
        jnet.initialize(ctx=mx.cpu())
        with jautograd.pause():
            fp32_logits = jnet(mx.nd.array(x)).asnumpy()
        arrays = {n: p.data().asnumpy()
                  for n, p in jnet.collect_params().items()}
        want, jlogits = _layer_dtypes_jax(jnet, x)
    tnet = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, arrays)
    got, tlogits = _layer_dtypes_port(tnet, x)
    assert len(got) == len(want) > 20
    assert [(t, d) for t, _p, d in got] == [(t, d) for t, _p, d in want]
    assert got[-1][2] == "bfloat16"
    assert {d for _t, _p, d in got} == {"bfloat16"}
    floor = np.abs(jlogits - fp32_logits).max()
    assert 0 < floor < 0.02 * np.abs(fp32_logits).max()
    np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=3 * floor)
