"""The ``mx.nd`` layer ops of the layer slice against the JAX package's
``mx.nd`` on the CPU: every new name and alias, forward and the
gradients of its inputs under a head gradient that is not ones (the
custom-gradient ops -- ``SoftmaxOutput``, the regression outputs,
``MakeLoss`` -- must ignore it as the JAX ``custom_vjp``s do), the
``mx.nd.contrib`` namespace, ``flash_attention(_masked)`` and
``fused_batch_norm_relu`` through the table, and the two repairs of the
slice: ``fused_batch_norm_relu`` off the last axis runs ``relu(BatchNorm)``
with no kernel, and the fusion plan pairs ``SyncBatchNorm``.

Tolerance: 1e-5 relative / 1e-6 absolute (fp32 ops over the same
inputs in another order); ``Deconvolution`` and ``CTCLoss`` 1e-5
absolute (sums of tens of products of magnitude ~10); flash attention
2e-5; ``BilinearResize2D``
and ``UpSampling(bilinear)`` 1e-5 (the same triangle weights, fp32)."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon, ops
from mxnet_tpu_torch.gluon.nn.basic_layers import _bn_relu_fusion_plan

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax(name, arrays, kw, heads=None, grads=True):
    """Outputs (and input gradients under ``heads``) of the JAX op."""
    xs = [jmx.nd.array(a, ctx=jmx.cpu()) if a is not None else None
          for a in arrays]
    live = [x for x in xs if x is not None]
    if grads:
        for x in live:
            x.attach_grad()
    fn = getattr(jmx.nd, name) if isinstance(name, str) else name(jmx.nd)
    with jautograd.record():
        outs = _as_list(fn(*xs, **kw))
    if grads:
        h = heads if heads is not None else [
            _rand(*o.shape, seed=9) + 2.0 for o in outs[:1]]
        outs[0].backward(jmx.nd.array(h[0], ctx=jmx.cpu()))
    return ([o.asnumpy() for o in outs],
            [x.grad.asnumpy() for x in live] if grads else [])


def _port(name, arrays, kw, heads=None, grads=True):
    xs = [tmx.nd.array(a) if a is not None else None for a in arrays]
    live = [x for x in xs if x is not None]
    if grads:
        for x in live:
            x.attach_grad()
    fn = getattr(tmx.nd, name) if isinstance(name, str) else name(tmx.nd)
    with autograd.record():
        outs = _as_list(fn(*xs, **kw))
    if grads:
        h = heads if heads is not None else [
            _rand(*o.shape, seed=9) + 2.0 for o in outs[:1]]
        outs[0].backward(tmx.nd.array(h[0]))
    return ([o.asnumpy() for o in outs],
            [x.grad.asnumpy() for x in live] if grads else [])


def _same(name, arrays, kw=None, grads=True, tol=TOL, skip_grad=()):
    kw = kw or {}
    jo, jg = _jax(name, arrays, kw, grads=grads)
    to, tg = _port(name, arrays, kw, grads=grads)
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, **tol)
    for i, (j, t) in enumerate(zip(jg, tg)):
        if i not in skip_grad:
            np.testing.assert_allclose(t, j, err_msg="grad %d" % i, **tol)
    return to, tg


BN_CASES = [
    ("nchw", (4, 3, 5, 5), 1),
    ("nhwc", (4, 5, 5, 3), 3),
    ("nc", (6, 3), 1),
]


def _bn_arrays(shape, axis, seed=0):
    c = shape[axis]
    return [_rand(*shape, seed=seed) * 2 + 0.5,
            np.random.default_rng(seed + 1).random(c).astype(np.float32)
            + 0.5, _rand(c, seed=seed + 2), _rand(c, seed=seed + 3) * 0.1,
            np.random.default_rng(seed + 4).random(c).astype(np.float32)
            + 0.5]


@pytest.mark.parametrize("case,shape,axis", BN_CASES,
                         ids=[c[0] for c in BN_CASES])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_returns_the_list_of_three(case, shape, axis, fix_gamma):
    """``mx.nd.BatchNorm`` in training (under ``record``): the output
    and both new running statistics, and the gradients of data, gamma
    and beta (the statistics take none)."""
    kw = dict(axis=axis, fix_gamma=fix_gamma, eps=1e-3, momentum=0.8)
    out, grads = _same("BatchNorm", _bn_arrays(shape, axis), kw,
                       skip_grad=(1,) if fix_gamma else ())
    assert len(out) == 3


def test_batch_norm_eval_uses_the_running_statistics():
    arrays = _bn_arrays((4, 3, 5, 5), 1)
    jo, _ = _jax("BatchNorm", arrays, dict(fix_gamma=False,
                                           use_global_stats=True))
    to, _ = _port("BatchNorm", arrays, dict(fix_gamma=False,
                                            use_global_stats=True))
    for j, t in zip(jo, to):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(to[1], arrays[3])
    # output_mean_var is the JAX op's and accepted
    out = tmx.nd.BatchNorm(*[tmx.nd.array(a) for a in arrays],
                           output_mean_var=True)
    assert len(out) == 3


def _dispatched(monkeypatch):
    """Names the fused ops hand to the kernel registry."""
    from mxnet_tpu_torch.ops import fused_bn_relu as fbr
    seen = []
    real = fbr.dispatch

    def spy(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(fbr, "dispatch", spy)
    return seen


@pytest.mark.parametrize("case,shape,axis", BN_CASES[:2],
                         ids=[c[0] for c in BN_CASES[:2]])
def test_fused_batch_norm_relu_follows_the_jax_op_on_any_axis(
        monkeypatch, case, shape, axis):
    """Repair: ``mx.nd.fused_batch_norm_relu`` takes every axis, as the
    JAX op does (its default is ``axis=1``).  Off the last axis it is
    ``relu(BatchNorm)`` and hands nothing to the kernel registry; on
    the last axis it runs the fused apply and its backward (their plain
    versions here)."""
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    seen = _dispatched(monkeypatch)
    kw = dict(axis=axis, fix_gamma=False)
    out, _ = _same("fused_batch_norm_relu", _bn_arrays(shape, axis), kw,
                   skip_grad=(3, 4))
    assert (out[0] >= 0).all()
    want = [] if axis != len(shape) - 1 else ["bn_relu_apply",
                                              "bn_relu_bwd"]
    assert seen == want


def test_fused_batch_norm_relu_defaults_to_axis_1(monkeypatch):
    seen = _dispatched(monkeypatch)
    arrays = _bn_arrays((2, 3, 4, 4), 1)
    out = tmx.nd.fused_batch_norm_relu(*[tmx.nd.array(a) for a in arrays],
                                       fix_gamma=False)
    bn = tmx.nd.BatchNorm(*[tmx.nd.array(a) for a in arrays],
                          fix_gamma=False)
    np.testing.assert_array_equal(out[0].asnumpy(),
                                  np.maximum(bn[0].asnumpy(), 0))
    assert seen == []


def test_fusion_plan_pairs_sync_batch_norm_as_the_jax_plan_does(
        monkeypatch):
    """Repair: the plan pairs ``SyncBatchNorm`` + relu as it pairs
    ``BatchNorm`` (the JAX plan's ``type(b) in (BatchNorm,
    SyncBatchNorm)``), so a net of them launches the fused kernel at the
    same sites, and its forward matches the JAX net's."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.gluon.nn.basic_layers import \
        _bn_relu_fusion_plan as jplan
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    sbn = gluon.nn.SyncBatchNorm(axis=3, num_devices=1)
    relu = gluon.nn.Activation("relu")
    assert _bn_relu_fusion_plan([sbn, relu], 4) == [(sbn, True)]
    jsbn, jrelu = jnn.SyncBatchNorm(axis=3), jnn.Activation("relu")
    assert jplan([jsbn, jrelu]) == [(jsbn, True)]

    def net(nn):
        n = nn.HybridSequential()
        with n.name_scope():
            n.add(nn.Conv2D(4, 3, padding=1, layout="NHWC"),
                  nn.SyncBatchNorm(axis=3), nn.Activation("relu"))
        return n
    np.random.seed(0)
    jnet = net(jnn)
    jnet.initialize(ctx=jmx.cpu())
    x = _rand(2, 5, 5, 3)
    with jautograd.record():
        jout = jnet(jmx.nd.array(x, ctx=jmx.cpu()))
    tnet = net(gluon.nn)
    tnet.initialize(device="cpu")
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in
                             jnet.collect_params().items()},
                      prefix=jnet.prefix)
    seen = _dispatched(monkeypatch)
    with autograd.record():
        tout = tnet(tmx.nd.array(x))
    assert seen == ["bn_relu_apply"]
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)


@pytest.mark.parametrize("act_type,slope", [("leaky", 0.1), ("elu", 0.7),
                                            ("selu", 0.25),
                                            ("gelu", 0.25)])
def test_leaky_relu_act_types(act_type, slope):
    _same("LeakyReLU", [_rand(3, 4, 5)],
          dict(act_type=act_type, slope=slope))


def test_prelu():
    x, g = _rand(3, 4, 5), _rand(4, seed=1)
    _same("_prelu", [x, g])
    got = tmx.nd.LeakyReLU(tmx.nd.array(x), tmx.nd.array(g),
                           act_type="prelu").asnumpy()
    want, _ = _jax("_prelu", [x, g], {}, grads=False)
    np.testing.assert_allclose(got, want[0], **TOL)


def test_rrelu_draws_slopes_in_training_and_takes_their_mean_otherwise():
    x = -np.abs(_rand(64, 64)) - 0.1
    lo, hi = 0.125, 0.334
    ev = tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="rrelu").asnumpy()
    np.testing.assert_allclose(ev, x * (lo + hi) / 2, rtol=1e-6)
    tmx.random.seed(3)
    with autograd.record():
        tr = tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="rrelu").asnumpy()
    s = tr / x
    assert s.min() >= lo - 1e-6 and s.max() <= hi + 1e-6
    assert s.std() > 0.05
    tmx.random.seed(3)
    with autograd.record():
        again = tmx.nd.LeakyReLU(tmx.nd.array(x),
                                 act_type="rrelu").asnumpy()
    np.testing.assert_array_equal(tr, again)
    with pytest.raises(MXNetError, match="act_type"):
        tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="nope")


def test_instance_norm_and_group_norm():
    x = _rand(2, 4, 5, 6) * 3 + 1
    g, b = _rand(4, seed=1), _rand(4, seed=2)
    _same("InstanceNorm", [x, g, b])
    _same("InstanceNorm", [x, g, b], dict(eps=0.1))
    _same("GroupNorm", [x, g, b], dict(num_groups=2))
    _same("GroupNorm", [_rand(3, 4, 7), g, b], dict(num_groups=4, eps=1e-3))


DECONV_CASES = [
    # id, data shape, weight shape, kwargs
    ("plain", (2, 4, 5, 5), (4, 3, 3, 3), dict(kernel=(3, 3),
                                                num_filter=3)),
    ("stride_pad_adj", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=3, no_bias=False)),
    ("groups_dilate", (2, 4, 5, 5), (4, 2, 3, 3),
     dict(kernel=(3, 3), stride=(2, 1), dilate=(2, 2), pad=(2, 1),
          num_group=2, num_filter=4, no_bias=False)),
    ("adj_past_stride", (1, 2, 4, 4), (2, 2, 2, 2),
     dict(kernel=(2, 2), stride=(1, 1), adj=(2, 1), num_filter=2)),
    ("big_pad", (1, 2, 6, 6), (2, 2, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(3, 2), num_filter=2)),
    ("nhwc", (2, 5, 6, 4), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0),
          num_filter=3, no_bias=False, layout="NHWC")),
    ("1d", (2, 4, 7), (4, 3, 3),
     dict(kernel=(3,), stride=(3,), pad=(1,), adj=(2,), num_filter=3,
          no_bias=False)),
]


@pytest.mark.parametrize("case,dshape,wshape,kw", DECONV_CASES,
                         ids=[c[0] for c in DECONV_CASES])
def test_deconvolution(case, dshape, wshape, kw):
    bias = _rand(kw["num_filter"], seed=2)
    arrays = [_rand(*dshape), _rand(*wshape, seed=1), bias]
    _same("Deconvolution", arrays, kw, tol=dict(rtol=1e-5, atol=1e-5))


def test_upsampling_and_bilinear_resize():
    x = _rand(2, 3, 4, 5)
    _same("UpSampling", [x], dict(scale=2, sample_type="nearest"))
    _same("UpSampling", [x], dict(scale=3, sample_type="bilinear",
                                  num_args=1))
    for kw in (dict(height=9, width=11), dict(height=3, width=2),
               dict(height=7, width=3),
               dict(scale_height=2.0, scale_width=0.5)):
        _same("BilinearResize2D", [_rand(2, 3, 6, 8, seed=4)], kw)


def test_softmin_smooth_l1_and_moments():
    x = _rand(3, 4, 5)
    _same("softmin", [x])
    _same("softmin", [x], dict(axis=1))
    _same("smooth_l1", [x])
    _same("smooth_l1", [x], dict(scalar=2.0))
    _same("moments", [x], grads=False)
    _same("moments", [x], dict(axes=(0, 2), keepdims=True), grads=False)
    _same(lambda nd: (lambda d: nd.moments(d, axes=(1,))[1]), [x])


SOFTMAX_OUT_CASES = [
    ("plain", dict()),
    ("grad_scale_batch", dict(grad_scale=0.5, normalization="batch")),
    ("ignore_valid", dict(use_ignore=True, ignore_label=2.0,
                          normalization="valid")),
    ("ignore_null", dict(use_ignore=True, ignore_label=1.0)),
    ("multi_output", dict(multi_output=True, normalization="valid")),
]


@pytest.mark.parametrize("case,kw", SOFTMAX_OUT_CASES,
                         ids=[c[0] for c in SOFTMAX_OUT_CASES])
def test_softmax_output_writes_its_own_gradient(case, kw):
    """The gradient of ``data`` is ``(p - one_hot) * grad_scale``,
    masked and normalized, whatever the head gradient (non-unit here);
    ``label`` takes a zero gradient."""
    rng = np.random.default_rng(5)
    if kw.get("multi_output"):
        x, lab = _rand(3, 4, 5), rng.integers(0, 4, (3, 5))
    else:
        x, lab = _rand(6, 5), rng.integers(0, 5, 6)
    lab = lab.astype(np.float32)
    out, grads = _same("SoftmaxOutput", [x, lab], kw)
    _, ones = _port("SoftmaxOutput", [x, lab], kw,
                    heads=[np.ones_like(out[0])])
    np.testing.assert_array_equal(ones[0], grads[0])
    np.testing.assert_array_equal(grads[1], 0)


def test_deconvolution_takes_the_jax_ops_arguments_only():
    """Neither package's op takes ``target_shape``."""
    x, w = _rand(1, 2, 3, 3), _rand(2, 2, 3, 3, seed=1)
    for mx_ in (jmx, tmx):
        with pytest.raises(Exception, match="target_shape"):
            mx_.nd.Deconvolution(mx_.nd.array(x), mx_.nd.array(w),
                                 kernel=(3, 3), num_filter=2,
                                 target_shape=(5, 5))


_REGRESSION_KINDS = {"LinearRegressionOutput": 0, "MAERegressionOutput": 1,
                     "LogisticRegressionOutput": 2}


@pytest.mark.parametrize("name", sorted(_REGRESSION_KINDS))
@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
def test_regression_outputs_write_their_own_gradient(name, grad_scale):
    """The JAX ops fail in their own forward (``kind == 2`` of a traced
    value), so the port is held to their plain functions: the forward
    (identity, or ``sigmoid``) and ``_regression_core_bwd``, which
    ignores the head gradient."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn_ops
    x = _rand(4, 3)
    lab = np.random.default_rng(6).random(12).astype(np.float32)
    kind = _REGRESSION_KINDS[name]
    head = _rand(4, 3, seed=9) + 2.0
    out, grads = _port(name, [x, lab], dict(grad_scale=grad_scale),
                       heads=[head])
    want = np.asarray(jax.nn.sigmoid(x)) if kind == 2 else x
    np.testing.assert_allclose(out[0], want, **TOL)
    jg = jnn_ops._regression_core_bwd(
        (jnp.asarray(want), jnp.asarray(lab), grad_scale, kind),
        jnp.asarray(head))
    np.testing.assert_allclose(grads[0], np.asarray(jg[0]), **TOL)
    np.testing.assert_array_equal(grads[1], 0)
    _, ones = _port(name, [x, lab], dict(grad_scale=grad_scale),
                    heads=[np.ones((4, 3), np.float32)])
    np.testing.assert_array_equal(ones[0], grads[0])


@pytest.mark.parametrize("name", ["MakeLoss", "make_loss"])
def test_make_loss_gradient_is_its_scale(name):
    """Forward against the JAX op; the gradient against its
    ``_make_loss_core_bwd`` (the JAX op's own backward cannot run: its
    residuals hold a dtype), ``grad_scale`` whatever the head."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn_ops
    x = _rand(3, 4)
    _same(name, [x], dict(grad_scale=0.3), grads=False)
    _same(name, [x], dict(normalization="batch"), grads=False)
    head = _rand(3, 4, seed=9)
    _, grads = _port(name, [x], dict(grad_scale=0.3), heads=[head])
    want = jnn_ops._make_loss_core_bwd((x.shape, jnp.float32, 0.3),
                                       jnp.asarray(head))[0]
    np.testing.assert_allclose(grads[0], np.asarray(want), **TOL)


def test_im2col_and_col2im():
    x = _rand(2, 3, 7, 6)
    kw = dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
    cols, _ = _same("im2col", [x], kw)
    _same("col2im", [cols[0]], dict(output_size=(7, 6), **kw))
    _same("im2col", [x])
    _same(lambda nd: nd.contrib.im2col, [x], kw)
    _same(lambda nd: nd.contrib.col2im, [cols[0]],
          dict(output_size=(7, 6), **kw))


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("name", ["CTCLoss", "ctc_loss"])
def test_ctc_loss_op(name, blank):
    """The op's recursion over (T, N, C) with -1 padding, an empty
    label row and a repeated label, both blank conventions."""
    data = _rand(9, 4, 6)
    label = np.array([[1, 2, 2, -1], [3, -1, -1, -1], [-1, -1, -1, -1],
                      [4, 1, 3, 2]], np.float32)
    if blank == "last":
        label = np.where(label >= 0, label - 1, label)
    kw = dict(blank_label=blank)
    out, _ = _same(name, [data, label], kw, tol=dict(rtol=1e-5, atol=1e-5))
    assert out[0].shape == (4,) and np.isfinite(out[0]).all()
    _same(lambda nd: getattr(nd.contrib, name), [data, label], kw,
          tol=dict(rtol=1e-5, atol=1e-5))


def test_contrib_namespace_holds_the_ported_names():
    for name in ("CTCLoss", "ctc_loss", "im2col", "col2im",
                 "flash_attention"):
        assert hasattr(jmx.nd.contrib, name)
        assert callable(getattr(tmx.nd.contrib, name))


def _qkv(bh=4, seq=16, d=8, seed=0):
    return [_rand(bh, seq, d, seed=seed + i) for i in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_through_the_table(causal):
    """``mx.nd.flash_attention`` with the JAX op's arguments (its
    ``use_pallas``/``block_q``/``block_k`` accepted), forward and the
    gradients of q, k and v."""
    tol = dict(rtol=2e-5, atol=2e-5)
    _same("flash_attention", _qkv(), dict(causal=causal), tol=tol)
    _same("flash_attention", _qkv(seed=3),
          dict(causal=causal, scale=0.2, use_pallas=None, block_q=8,
               block_k=8), tol=tol)
    _same(lambda nd: nd.contrib.flash_attention, _qkv(), {}, tol=tol)


def test_flash_attention_masked_through_the_table():
    mask = (np.random.default_rng(2).random((2, 16, 16)) > 0.3) \
        .astype(np.float32)
    mask[:, :, 0] = 1.0
    tol = dict(rtol=2e-5, atol=2e-5)
    q, k, v = _qkv()
    _same("flash_attention_masked", [q, k, v, mask], dict(heads=2),
          tol=tol, skip_grad=(3,))
    _same("flash_attention_masked", [q, k, v, mask],
          dict(scale=0.3, heads=2, use_pallas=None, block_q=16,
               block_k=16), tol=tol, skip_grad=(3,))


def test_layer_ops_cast_as_the_jax_package_casts():
    """Under bf16 AMP the target-dtype op runs in bf16 and the fp32 ops
    return fp32, in both packages."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp
    x = _rand(2, 4, 5, 5)
    w = _rand(4, 3, 3, 3, seed=1)
    lab = np.zeros(2, np.float32)
    with amp.scope("bfloat16"):
        d = tmx.nd.Deconvolution(tmx.nd.array(x), tmx.nd.array(w),
                                 kernel=(3, 3), num_filter=3)
        s = tmx.nd.SoftmaxOutput(tmx.nd.array(x[:, :, 0, 0]).astype(
            "bfloat16"), tmx.nd.array(lab))
    with jamp.scope("bfloat16"):
        jd = jmx.nd.Deconvolution(jmx.nd.array(x), jmx.nd.array(w),
                                  kernel=(3, 3), num_filter=3)
        js = jmx.nd.SoftmaxOutput(jmx.nd.array(x[:, :, 0, 0]).astype(
            "bfloat16"), jmx.nd.array(lab))
    def name(dt):
        return str(dt).replace("torch.", "")
    assert name(d.dtype) == name(jd.dtype) == "bfloat16"
    assert name(s.dtype) == name(js.dtype) == "float32"


def test_every_layer_op_name_exists_in_both_packages():
    names = ["BatchNorm", "BilinearResize2D", "CTCLoss", "Deconvolution",
             "GroupNorm", "InstanceNorm", "LeakyReLU",
             "LinearRegressionOutput", "LogisticRegressionOutput",
             "MAERegressionOutput", "MakeLoss", "SoftmaxOutput",
             "UpSampling", "_prelu", "col2im", "ctc_loss",
             "flash_attention", "flash_attention_masked",
             "fused_batch_norm_relu", "im2col", "make_loss", "moments",
             "smooth_l1", "softmin", "contrib"]
    for name in names:
        assert hasattr(jmx.nd, name), name
        assert hasattr(tmx.nd, name), name
    # the op namespace a hybrid_forward sees holds the table's ops too
    assert ops.Concat is tmx.ops.table.lookup("concat").fn
    with pytest.raises(AttributeError):
        ops.no_such_op
