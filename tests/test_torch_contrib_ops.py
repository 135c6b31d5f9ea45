"""The port's contrib op families against the JAX package's on the CPU:
``tests/test_op_families.py``'s quantization, box and ROI cases through
both packages; the int8 ops bitwise (int8 and int32 values, and the
float32 ranges) over calibrated and runtime ranges, biased and not, at
a width whose int8 sums pass 2^24; ``box_iou``; ``box_nms`` with tied
scores; ``ROIPooling`` and ``ROIAlign`` with ``ROIAlign``'s gradient;
the four interleaved matmuls forward and backward; and ``mx.nd.contrib``
holding the JAX package's names.

Tolerance: the int8 ops, ``box_nms``'s selection and ``ROIPooling``
(a maximum) bitwise; ``ROIAlign``'s gradient, a scatter-add each
library sums in its own order, 1e-4 relative and 1e-5 absolute;
everything else 1e-5 relative and 1e-6 absolute, the JAX tests' own.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd

TOL = dict(rtol=1e-5, atol=1e-6)
_R = np.random.RandomState(0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(fn):
    out = []
    for pkg in (tmx, jmx):
        res = fn(pkg)
        res = res if isinstance(res, (list, tuple)) else [res]
        out.append([r.asnumpy() for r in res])
    return out


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def _close(got, want, **tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, **(tol or TOL))


# -- tests/test_op_families.py -------------------------------------------

def test_quantize_roundtrip():
    x = np.array([0.5, -1.0, 1.0, 0.0], np.float32)

    def run(mx):
        q, mn, mxr = mx.nd.quantize_v2(mx.nd.array(x))
        return [q, mn, mxr, mx.nd.dequantize(q, mn, mxr)]
    got, want = _both(run)
    _equal(got, want)
    assert got[0].dtype == np.int8
    np.testing.assert_allclose(got[3], x, atol=0.02)


def test_quantized_fully_connected_close_to_fp32():
    x = _R.randn(4, 8).astype(np.float32)
    w = _R.randn(16, 8).astype(np.float32)

    def run(mx):
        qx, xn, xx = mx.nd.quantize_v2(mx.nd.array(x))
        qw, wn, wx = mx.nd.quantize_v2(mx.nd.array(w))
        acc, on, ox = mx.nd.quantized_fully_connected(
            qx, qw, None, xn, xx, wn, wx, None, None, num_hidden=16,
            no_bias=True)
        return [acc, on, ox, mx.nd.dequantize(acc, on, ox)]
    got, want = _both(run)
    _equal(got, want)
    np.testing.assert_allclose(got[3], x @ w.T, rtol=0.1, atol=0.15)


def test_box_iou_nms():
    boxes = np.array([[0, 0.9, 0, 0, 2, 2], [1, 0.8, 0.1, 0.1, 2.1, 2.1],
                      [2, 0.7, 5, 5, 7, 7]], np.float32)
    got, want = _both(lambda mx: [
        mx.nd.box_nms(mx.nd.array(boxes), overlap_thresh=0.5,
                      coord_start=2, score_index=1),
        mx.nd.contrib.box_iou(
            mx.nd.array(np.array([[0, 0, 2, 2]], np.float32)),
            mx.nd.array(np.array([[1, 1, 3, 3]], np.float32)))])
    _equal(got, want)
    assert (got[0][:, 1] == np.array([0.9, -1.0, 0.7], np.float32)).all()
    np.testing.assert_allclose(got[1], [[1.0 / 7]], rtol=1e-5)


def test_roi_pooling_shapes():
    data = _R.randn(1, 4, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7], [0, 2, 2, 6, 6]], np.float32)
    got, want = _both(lambda mx: [
        mx.nd.ROIPooling(mx.nd.array(data), mx.nd.array(rois),
                         pooled_size=(2, 2)),
        mx.nd.ROIAlign(mx.nd.array(data), mx.nd.array(rois),
                       pooled_size=(2, 2))])
    _equal(got[:1], want[:1])
    _close(got[1:], want[1:])
    assert got[0].shape == got[1].shape == (2, 4, 2, 2)
    np.testing.assert_allclose(got[0][0, :, 0, 0],
                               data[0, :, :4, :4].max(axis=(1, 2)),
                               rtol=1e-5)


# -- the int8 ops, bitwise ------------------------------------------------

def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


RANGES = [np.float32(v) for v in (-2.0, 1.5, -0.5, 0.75, -1.0, 1.25)]


@pytest.mark.parametrize("calib", [None, (-0.7, 1.3), (-3.0, 0.2)])
def test_quantize_family_is_bitwise(calib):
    x = _R.randn(5, 7).astype(np.float32) * 1.7
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}

    def run(mx):
        q, lo, hi = mx.nd.quantize_v2(mx.nd.array(x), **kw)
        q2, lo2, hi2 = mx.nd.quantize(mx.nd.array(x), lo, hi)
        acc = mx.nd.array(_i8(5, 7).astype(np.int32) * 113)
        rq = mx.nd.requantize(acc, lo, hi, **kw)
        return [q, lo, hi, q2, lo2, hi2, mx.nd.dequantize(q, lo, hi),
                mx.nd.dequantize(acc, lo, hi)] + list(rq)
    got, want = _both(run)
    _equal(got, want)


@pytest.mark.parametrize("no_bias", [True, False])
@pytest.mark.parametrize("flatten", [True, False])
def test_quantized_fully_connected_is_bitwise(no_bias, flatten):
    x = _i8(3, 4, 6)
    w = _i8(5, 24 if flatten else 4, seed=1)
    b = _i8(5, seed=2)

    def run(mx):
        args = [mx.nd.array(x), mx.nd.array(w), mx.nd.array(b)] \
            + [mx.nd.array(r) for r in RANGES]
        return mx.nd.quantized_fully_connected(
            *args, num_hidden=5, no_bias=no_bias, flatten=flatten)
    got, want = _both(run)
    _equal(got, want)
    assert got[0].dtype == np.int32


@pytest.mark.parametrize("layout,kw", [
    ("NCHW", {"kernel": (3, 3), "pad": (1, 1), "num_filter": 8}),
    ("NCHW", {"kernel": (3, 3), "stride": (2, 2), "dilate": (2, 2),
              "pad": (2, 1), "num_filter": 4, "num_group": 2}),
    ("NHWC", {"kernel": (1, 1), "num_filter": 8}),
    ("NCW", {"kernel": (3,), "num_filter": 4})])
@pytest.mark.parametrize("no_bias", [True, False])
def test_quantized_conv_is_bitwise(layout, kw, no_bias):
    nsp = len(layout) - 2
    groups = kw.get("num_group", 1)
    sp = (9,) * nsp
    data = _i8(2, 6, *sp) if layout.index("C") == 1 else _i8(2, *sp, 6)
    ks = kw["kernel"]
    wshape = (kw["num_filter"], 6 // groups) + ks if layout[1] == "C" \
        else (kw["num_filter"],) + ks + (6 // groups,)
    w = _i8(*wshape, seed=1)
    b = _i8(kw["num_filter"], seed=2)

    def run(mx):
        args = [mx.nd.array(data), mx.nd.array(w), mx.nd.array(b)] \
            + [mx.nd.array(r) for r in RANGES]
        return mx.nd.quantized_conv(*args, layout=layout, no_bias=no_bias,
                                    **kw)
    got, want = _both(run)
    _equal(got, want)


def test_quantized_conv_sums_exactly_past_two_to_the_24():
    """ResNet-50's widest 3x3 convolution: 512 channels, every product
    127^2 of one sign, 7.4e7 a sum -- past float32's exact integers."""
    x = np.full((1, 512, 3, 3), 127, np.int8)
    w = np.full((8, 512, 3, 3), -127, np.int8)

    def run(mx):
        args = [mx.nd.array(x), mx.nd.array(w), mx.nd.array(_i8(8))] \
            + [mx.nd.array(r) for r in RANGES]
        return mx.nd.quantized_conv(*args, kernel=(3, 3), num_filter=8)
    got, want = _both(run)
    _equal(got, want)
    assert got[0][0, 0, 0, 0] == -127 * 127 * 512 * 9


@pytest.mark.parametrize("pool_type,kw", [
    ("max", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ("avg", {"kernel": (2, 2), "stride": (2, 2)}),
    ("avg", {"global_pool": True})])
def test_quantized_pooling_is_bitwise(pool_type, kw):
    x = _i8(2, 3, 7, 7)
    got, want = _both(lambda mx: mx.nd.quantized_pooling(
        mx.nd.array(x), mx.nd.array(RANGES[0]), mx.nd.array(RANGES[1]),
        pool_type=pool_type, **kw))
    _equal(got, want)


# -- boxes and ROIs --------------------------------------------------------

def _boxes(*shape, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 20, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(1, 10, shape + (2,))],
                          axis=-1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    got, want = _both(lambda mx: mx.nd.box_iou(
        mx.nd.array(_boxes(2, 7)), mx.nd.array(_boxes(2, 5, seed=1)),
        format=fmt))
    _close(got, want)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_box_nms_with_tied_scores(batch):
    rng = np.random.RandomState(4)
    n = 40
    scores = rng.choice([0.2, 0.5, 0.9], batch + (n, 1)).astype(np.float32)
    data = np.concatenate([rng.randint(0, 3, batch + (n, 1)).astype(
        np.float32), scores, _boxes(*batch, n, seed=5)], axis=-1)
    got, want = _both(lambda mx: mx.nd.box_nms(
        mx.nd.array(data), overlap_thresh=0.3, valid_thresh=0.3))
    _equal(got, want)
    assert (got[0][..., 1] == -1).any() and (got[0][..., 1] > 0).any()


def _rois(n, seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 24, (n, 2))
    return np.concatenate([rng.randint(0, 2, (n, 1)), lo,
                           lo + rng.uniform(0, 14, (n, 2))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("pooled,scale,ratio", [((2, 2), 1.0, 2),
                                                ((2, 3), 0.5, 1)])
def test_roi_pooling_and_align_with_gradient(pooled, scale, ratio):
    feat = _R.randn(2, 3, 16, 16).astype(np.float32)
    rois = _rois(6)
    cot = np.random.RandomState(7).randn(6, 3, *pooled).astype(np.float32)

    def run(mx, ag):
        x = mx.nd.array(feat)
        x.attach_grad()
        with ag.record():
            y = mx.nd.ROIAlign(x, mx.nd.array(rois), pooled_size=pooled,
                               spatial_scale=scale, sample_ratio=ratio)
            (y * mx.nd.array(cot)).sum().backward()
        pool = mx.nd.ROIPooling(x, mx.nd.array(rois), pooled_size=pooled,
                                spatial_scale=scale)
        return [y.asnumpy(), x.grad.asnumpy(), pool.asnumpy()]
    got, want = run(tmx, autograd), run(jmx, jautograd)
    _close(got[:1], want[:1])
    # the gradient's scatter sums the samples of a pixel in each
    # library's own order
    _close(got[1:2], want[1:2], rtol=1e-4, atol=1e-5)
    _equal(got[2:], want[2:])


# -- interleaved matmuls ----------------------------------------------------

def _grad_case(name, inputs, params):
    def run(mx, ag):
        xs = [mx.nd.array(x) for x in inputs]
        for x in xs:
            x.attach_grad()
        with ag.record():
            y = getattr(mx.nd, name)(*xs, **params)
            (y * y).sum().backward()
        return [y.asnumpy()] + [x.grad.asnumpy() for x in xs]
    return run(tmx, autograd), run(jmx, jautograd)


@pytest.mark.parametrize("name,shapes", [
    ("interleaved_matmul_selfatt_qk", [(6, 2, 3 * 3 * 4)]),
    ("interleaved_matmul_selfatt_valatt", [(6, 2, 3 * 3 * 4), (6, 6, 6)]),
    ("interleaved_matmul_encdec_qk", [(4, 2, 12), (6, 2, 24)]),
    ("interleaved_matmul_encdec_valatt", [(6, 2, 24), (6, 4, 6)])])
def test_interleaved_matmuls_with_gradients(name, shapes):
    inputs = [_R.randn(*s).astype(np.float32) for s in shapes]
    got, want = _grad_case(name, inputs, {"heads": 3})
    _close(got, want)


def test_interleaved_attention_equals_plain_attention():
    """``selfatt_qk`` -> softmax -> ``selfatt_valatt`` is attention over
    the interleaved projection's q, k and v."""
    seq, batch, heads, hd = 5, 2, 2, 4
    qkv = _R.randn(seq, batch, heads * 3 * hd).astype(np.float32)
    with tmx.cpu():
        att = tmx.nd.softmax(tmx.nd.interleaved_matmul_selfatt_qk(
            tmx.nd.array(qkv), heads=heads), axis=-1)
        out = tmx.nd.interleaved_matmul_selfatt_valatt(
            tmx.nd.array(qkv), att, heads=heads).asnumpy()
    x = qkv.reshape(seq, batch, heads, 3, hd)
    q, k, v = (x[:, :, :, i].transpose(1, 2, 0, 3) for i in range(3))
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(hd)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = (p @ v).transpose(2, 0, 1, 3).reshape(seq, batch, heads * hd)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_contrib_namespace_holds_the_jax_names():
    from mxnet_tpu.ndarray import contrib as jcontrib
    from mxnet_tpu_torch.ndarray import contrib as tcontrib
    jnames = {n for n in dir(jcontrib) if not n.startswith("_")
              and callable(getattr(jcontrib, n))
              and getattr(jcontrib, n).__module__ != "builtins"}
    tnames = {n for n in dir(tcontrib) if not n.startswith("_")
              and callable(getattr(tcontrib, n))}
    wanted = set(tcontrib._NAMES) | {"foreach", "while_loop", "cond"}
    assert wanted <= jnames and wanted <= tnames
    for name in tcontrib._NAMES:
        assert getattr(tcontrib, name).__name__ == name
    assert tmx.nd.contrib.box_nms is not tmx.nd.box_nms
    assert tmx.nd.contrib.box_nms.__doc__ == tmx.nd.box_nms.__doc__
