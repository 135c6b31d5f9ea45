"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib_ops.py``):
patches of an NCHW image and their adjoint, the CTC loss as an operator,
the int8 quantization family, and the box and ROI ops.

- ``im2col``/``col2im``: ``F.unfold``/``F.fold``.
- ``CTCLoss``: the log-space alpha recursion over ``(T, N, C)``.
- Quantization: int8 with float32 ranges, the JAX ops' arithmetic step
  for step, so the int8 and int32 values are bitwise the JAX package's
  (a division by a constant is a product with its reciprocal, as XLA
  compiles it).
  An int8 product is summed exactly: on the card by ``torch._int_mm``
  (cuBLASLt int8 -> int32) over im2col patches where its shapes allow
  it (more than 16 rows, both other sizes multiples of 8), else as
  float64, whose sums of int8 products are exact far past any layer's
  width (below 2^53); float32 would not be (ResNet-50's 3x3x512
  convolution sums products up to 7.4e7, above 2^24).
- Boxes and ROIs keep static shapes: ``box_nms`` writes -1 over a
  suppressed score and reads nothing back to the host (a greedy pass
  over the score order, ties broken as a stable descending sort);
  ``ROIPooling`` takes a masked maximum a pooled row at a time over a
  chunk of ROIs, so it never holds a (ROIs, cells, C, H, W) tensor;
  ``ROIAlign`` samples bilinearly and is differentiable in ``data``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .table import register

__all__ = ["CTCLoss", "ROIAlign", "ROIPooling", "box_iou", "box_nms",
           "col2im", "dequantize", "im2col", "quantize", "quantize_v2",
           "quantized_conv", "quantized_fully_connected",
           "quantized_pooling", "requantize"]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, float)) \
        else tuple(int(x) for x in v)


@register("im2col")
def im2col(data, kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """``(N, C, H, W)`` -> ``(N, C * kh * kw, L)`` patches, channel
    major."""
    return F.unfold(data, _pair(kernel), _pair(dilate), _pair(pad),
                    _pair(stride))


@register("col2im")
def col2im(data, output_size=(0, 0), kernel=(3, 3), stride=(1, 1),
           dilate=(1, 1), pad=(0, 0)):
    """The adjoint of :func:`im2col`: patches summed back into ``(N, C,
    *output_size)``."""
    return F.fold(data, _pair(output_size), _pair(kernel), _pair(dilate),
                  _pair(pad), _pair(stride))


_NEG_INF = -1e30


@register("CTCLoss", args=("data", "label"), aliases=("ctc_loss",))
def CTCLoss(data, label, use_data_lengths=False, use_label_lengths=False,
            blank_label="first"):
    """Negative log-likelihood of each ``(N, L)`` label row under the
    ``(T, N, C)`` activations: the JAX op's recursion.  The blank is
    class 0 (``"first"``) or ``C - 1`` (``"last"``); a negative label is
    padding.  Every sample runs all ``T`` steps: the length flags are
    accepted and unused, as in the JAX op."""
    t_len, n, c = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == "first" else c - 1
    lab = label.long()
    s_len = 2 * lab.shape[1] + 1
    dev = data.device
    ext = torch.full((n, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    valid = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=dev),
                       (lab >= 0).repeat_interleave(2, dim=1)], dim=1)
    ext = torch.where(valid[:, :s_len], ext, blank)
    label_len = (lab >= 0).sum(dim=1)
    rows = torch.arange(n, device=dev)
    neg = torch.full((n, 1), _NEG_INF, device=dev)
    alpha = torch.full((n, s_len), _NEG_INF, device=dev)
    alpha[:, 0] = logp[0][rows, ext[:, 0]]
    alpha[:, 1] = torch.where(label_len > 0, logp[0][rows, ext[:, 1]],
                              torch.full_like(alpha[:, 1], _NEG_INF))
    alpha = alpha.clone()
    same = torch.cat([torch.zeros(n, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, t_len):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a2 = torch.where(same, _NEG_INF, a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        m_safe = torch.clamp_min(m, _NEG_INF)
        summed = torch.exp(alpha - m_safe) + torch.exp(a1 - m_safe) \
            + torch.exp(a2 - m_safe)
        alpha = m_safe + torch.log(summed) + torch.gather(logp[t], 1, ext)
    last_blank = alpha[rows, 2 * label_len]
    last_label = alpha[rows, torch.clamp_min(2 * label_len - 1, 0)]
    # an empty label row has only the all-blank path
    last_label = torch.where(label_len == 0, _NEG_INF, last_label)
    m = torch.maximum(last_blank, last_label)
    ll = m + torch.log(torch.exp(last_blank - m) + torch.exp(last_label - m))
    return (-ll).to(data.dtype)


# ----------------------------------------------------------------------
# Quantization
# ----------------------------------------------------------------------

def _f32(v, device):
    # a fill, not a host copy: a captured graph may hold it
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _bound(lo, hi):
    return torch.maximum(torch.abs(lo), torch.abs(hi))


def _to_int8(x, scale):
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


@register("quantize_v2", args=("data",), aliases=("_contrib_quantize_v2",))
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """float32 -> int8 with the range ``(-bound, bound)``: the calibrated
    one, or the data's own extremes."""
    if min_calib_range is None or max_calib_range is None:
        amin, amax = torch.min(data), torch.max(data)
    else:
        amin = _f32(min_calib_range, data.device)
        amax = _f32(max_calib_range, data.device)
    bound = _bound(amin, amax)
    scale = 127.0 / torch.clamp_min(bound, 1e-20)
    return _to_int8(data, scale), -bound, bound


@register("quantize", args=("data", "min_range", "max_range"))
def quantize(data, min_range, max_range, out_type="int8"):
    bound = _bound(min_range, max_range)
    scale = 127.0 / torch.clamp_min(bound, 1e-20)
    return _to_int8(data, scale), -bound, bound


@register("dequantize", args=("data", "min_range", "max_range"))
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 spans +-127 of its range, an int32 accumulator +-127^2."""
    q_max = 127.0 if data.dtype == torch.int8 else 127.0 * 127.0
    return data.to(torch.float32) * (_bound(min_range, max_range)
                                     * (1.0 / q_max))


@register("requantize", args=("data", "min_range", "max_range"),
          aliases=("_contrib_requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """An int32 accumulator -> int8 in a new range (the calibrated one,
    or the values' own extreme)."""
    real = data.to(torch.float32) * (_bound(min_range, max_range)
                                     * (1.0 / (127.0 * 127.0)))
    if min_calib_range is not None:
        bound = _f32(max(abs(float(min_calib_range)),
                         abs(float(max_calib_range))), data.device)
    else:
        bound = torch.clamp_min(torch.abs(real).max(), 1e-20)
    return _to_int8(real, 127.0 / bound), -bound, bound


def _int8_mm(a, w):
    """``a (M, K) . w (N, K)^T`` of int8 matrices as exact int32."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(a.contiguous(), w.contiguous().t())
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def _quantized_bias(acc, bias, min_bias, max_bias, sd, sw, shape):
    """The int8 bias rescaled from its range to the accumulator's."""
    sb = _bound(min_bias, max_bias) * (1.0 / 127.0)
    ratio = sb / torch.clamp_min(sd * sw, 1e-20)
    return acc + torch.round(bias.to(torch.float32).reshape(shape)
                             * ratio).to(torch.int32)


def _out_bound(min_data, max_data, min_weight, max_weight):
    """The accumulator's range ``127^2 * (|data| / 127) * (|weight| /
    127)``: ``|data| * |weight|``, the product XLA folds it to."""
    return _bound(min_data, max_data) * _bound(min_weight, max_weight)


_QUANT_ARGS = ("data", "weight", "bias", "min_data", "max_data",
               "min_weight", "max_weight", "min_bias", "max_bias")


@register("quantized_fully_connected", args=_QUANT_ARGS)
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias, max_bias,
                              num_hidden=0, no_bias=False, flatten=True):
    """int8 x int8 -> int32 dense layer with the accumulator's range."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if x.dim() == 2:
        acc = _int8_mm(x, weight)
    else:
        acc = torch.tensordot(x.double(), weight.double(),
                              dims=([1], [1])).to(torch.int32)
    sd = _bound(min_data, max_data) * (1.0 / 127.0)
    sw = _bound(min_weight, max_weight) * (1.0 / 127.0)
    if bias is not None and not no_bias:
        acc = _quantized_bias(acc, bias, min_bias, max_bias, sd, sw,
                              bias.shape)
    out_bound = _out_bound(min_data, max_data, min_weight, max_weight)
    return acc, -out_bound, out_bound


def _conv_int32(x, w, stride, pad, dilate, groups):
    """An exact int8 convolution of channels-first ``x`` and ``w`` as
    int32: im2col patches through :func:`_int8_mm` for a 2-D ungrouped
    convolution on the card, else float64."""
    if x.is_cuda and x.dim() == 4 and groups == 1:
        n, c, h, wd = x.shape
        f, _, kh, kw = w.shape
        (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
        xp = F.pad(x, (pw, pw, ph, ph))
        p = xp.unfold(2, (kh - 1) * dh + 1, sh) \
            .unfold(3, (kw - 1) * dw + 1, sw)[..., ::dh, ::dw]
        oh, ow = p.shape[2], p.shape[3]
        cols = p.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw)
        if cols.shape[0] > 16 and cols.shape[1] % 8 == 0 and f % 8 == 0:
            out = _int8_mm(cols, w.reshape(f, -1))
            return out.reshape(n, oh, ow, f).permute(0, 3, 1, 2)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[x.dim() - 2]
    return conv(x.double(), w.double(), None, stride, pad, dilate,
                groups).to(torch.int32)


@register("quantized_conv", args=_QUANT_ARGS,
          aliases=("_contrib_quantized_conv",))
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias, max_bias, kernel=(), stride=(),
                   dilate=(), pad=(), num_filter=0, num_group=1,
                   no_bias=True, layout="NCHW"):
    """int8 x int8 -> int32 convolution with the accumulator's range;
    the weight's layout follows the data's (OIHW for NCHW, OHWI for
    NHWC)."""
    from .nn import (_channels_last, _layout, _to_channels_first,
                     _to_channels_last, _tuple)
    nsp = data.dim() - 2
    layout = _layout(data, layout)
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    dilate = _tuple(dilate, nsp) if dilate else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    cl = _channels_last(layout)
    x = _to_channels_first(data) if cl else data
    w = _to_channels_first(weight) if cl else weight
    acc = _conv_int32(x, w, stride, pad, dilate, int(num_group))
    sd = _bound(min_data, max_data) * (1.0 / 127.0)
    sw = _bound(min_weight, max_weight) * (1.0 / 127.0)
    if bias is not None and not no_bias:
        acc = _quantized_bias(acc, bias, min_bias, max_bias, sd, sw,
                              (1, -1) + (1,) * nsp)
    if cl:
        acc = _to_channels_last(acc)
    out_bound = _out_bound(min_data, max_data, min_weight, max_weight)
    return acc, -out_bound, out_bound


@register("quantized_pooling", args=("data", "min_data", "max_data"),
          aliases=("_contrib_quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      stride=(), pad=(), global_pool=False,
                      count_include_pad=True, pooling_convention="valid",
                      layout="NCHW"):
    """Pooling in the integer domain (float32, rounded back), range
    unchanged."""
    from .nn import Pooling
    out = Pooling(data.to(torch.float32), kernel=kernel, pool_type=pool_type,
                  stride=stride, pad=pad, global_pool=global_pool,
                  count_include_pad=count_include_pad,
                  pooling_convention=pooling_convention, layout=layout)
    return torch.round(out).to(data.dtype), min_data, max_data


# ----------------------------------------------------------------------
# Boxes and ROIs
# ----------------------------------------------------------------------

def _iou_matrix(a, b, fmt="corner"):
    if fmt == "center":
        def to_corner(x):
            cx, cy, w, h = x.unbind(-1)
            return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2], dim=-1)
        a, b = to_corner(a), to_corner(b)
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0) \
        * torch.clamp_min(a[..., 3] - a[..., 1], 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0) \
        * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


@register("box_iou", args=("lhs", "rhs"), aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU of ``(..., n, 4)`` and ``(..., m, 4)`` boxes."""
    return _iou_matrix(lhs, rhs, format)


@register("box_nms", args=("data",), aliases=("_contrib_box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=True,
            in_format="corner", out_format="corner"):
    """Greedy non-maximum suppression of ``(n, k)`` or ``(batch, n, k)``
    records, sorted by descending score (ties in input order); a
    suppressed or invalid record's score becomes -1, the shape stays.
    ``topk``, ``id_index``, ``force_suppress`` and ``out_format`` are
    accepted and unused, as in the JAX op."""
    d = data[None] if data.dim() == 2 else data
    n = d.shape[1]
    order = torch.argsort(-d[..., score_index], dim=-1, stable=True)
    srt = torch.gather(d, 1, order[..., None].expand_as(d))
    scores = srt[..., score_index]
    boxes = srt[..., coord_start:coord_start + 4]
    later = torch.ones(n, n, dtype=torch.bool, device=d.device).triu_(1)
    over = (_iou_matrix(boxes, boxes, in_format) > overlap_thresh) & later
    keep = scores > valid_thresh
    for i in range(n):
        keep &= ~(over[:, i] & keep[:, i:i + 1])
    out = torch.cat([srt[..., :score_index],
                     torch.where(keep, scores, -1.0)[..., None].to(d.dtype),
                     srt[..., score_index + 1:]], dim=-1)
    return out[0] if data.dim() == 2 else out


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, float)) \
        else tuple(int(x) for x in v)


def _roi_chunks(rois, per_roi):
    """ROI slices whose working set stays near 2^26 elements."""
    step = max(1, (1 << 26) // max(per_roi, 1))
    return [slice(i, i + step) for i in range(0, rois.shape[0], step)]


@register("ROIPooling", args=("data", "rois"))
def ROIPooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each ROI ``[batch, x1, y1, x2, y2]`` to ``(C, ph, pw)``;
    an empty cell is 0."""
    ph, pw = _pair(pooled_size)
    n, c, h, w = data.shape
    ys = torch.arange(h, dtype=torch.float32, device=data.device)
    xs = torch.arange(w, dtype=torch.float32, device=data.device)
    neg = torch.full((), float("-inf"), dtype=data.dtype,
                     device=data.device)
    outs = []
    for sl in _roi_chunks(rois, c * h * w):
        r = rois[sl]
        fmap = data[r[:, 0].long()]                       # (R, C, H, W)
        x1, y1, x2, y2 = torch.round(r[:, 1:5] * spatial_scale).unbind(1)
        bh = torch.clamp_min(y2 - y1 + 1, 1.0) * (1.0 / ph)
        bw = torch.clamp_min(x2 - x1 + 1, 1.0) * (1.0 / pw)
        rows = []
        for py in range(ph):
            my = (ys >= torch.floor(y1 + py * bh)[:, None]) \
                & (ys < torch.ceil(y1 + (py + 1) * bh)[:, None])
            band = torch.where(my[:, None, :, None], fmap, neg).amax(dim=2)
            cells = []
            for px in range(pw):
                mx = (xs >= torch.floor(x1 + px * bw)[:, None]) \
                    & (xs < torch.ceil(x1 + (px + 1) * bw)[:, None])
                cells.append(torch.where(mx[:, None, :], band, neg)
                             .amax(dim=-1))
            rows.append(torch.stack(cells, dim=-1))
        out = torch.stack(rows, dim=-2)                    # (R, C, ph, pw)
        outs.append(torch.where(torch.isfinite(out), out, 0.0))
    return torch.cat(outs) if outs else data.new_zeros((0, c, ph, pw))


@register("ROIAlign", args=("data", "rois"), aliases=("_contrib_ROIAlign",))
def ROIAlign(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
             sample_ratio=2):
    """Bilinear ROI align: each cell the mean of ``sample_ratio^2``
    samples."""
    ph, pw = _pair(pooled_size)
    n, c, h, w = data.shape
    sr = max(int(sample_ratio), 1)
    nhwc = data.permute(0, 2, 3, 1)
    dev = data.device
    outs = []
    for sl in _roi_chunks(rois, 4 * c * ph * pw):
        r = rois[sl]
        b = r[:, 0].long()[:, None, None]
        x1, y1, x2, y2 = (r[:, 1:5] * spatial_scale).unbind(1)
        bh = torch.clamp_min(y2 - y1, 1.0) * (1.0 / ph)
        bw = torch.clamp_min(x2 - x1, 1.0) * (1.0 / pw)
        acc = 0.0
        for iy in range(sr):
            y = y1[:, None] + _offsets(ph, iy, sr, dev) * bh[:, None]
            for ix in range(sr):
                x = x1[:, None] + _offsets(pw, ix, sr, dev) * bw[:, None]
                acc = acc + _bilinear(nhwc, b, y, x, h, w)
        outs.append((acc * (1.0 / (sr * sr))).permute(0, 3, 1, 2))
    return torch.cat(outs) if outs else data.new_zeros((0, c, ph, pw))


def _offsets(n, i, sr, device):
    """``p + (i + 0.5) / sr`` for each cell ``p``, rounded once to
    float32 as the JAX op's Python constant is (made on the device, so a
    captured graph may hold it)."""
    return (torch.arange(n, dtype=torch.float64, device=device)
            + (i + 0.5) / sr).to(torch.float32)


def _bilinear(nhwc, b, y, x, h, w):
    """``(R, ph, pw, C)`` samples of the ROIs' maps at rows ``y (R, ph)``
    and columns ``x (R, pw)``."""
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (y - y0)[:, :, None, None]
    wx = (x - x0)[:, None, :, None]
    y0i, y1i = y0.long()[:, :, None], y1.long()[:, :, None]
    x0i, x1i = x0.long()[:, None, :], x1.long()[:, None, :]
    return (nhwc[b, y0i, x0i] * (1 - wy) * (1 - wx)
            + nhwc[b, y1i, x0i] * wy * (1 - wx)
            + nhwc[b, y0i, x1i] * (1 - wy) * wx
            + nhwc[b, y1i, x1i] * wy * wx)
