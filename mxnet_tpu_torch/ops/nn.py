"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py`` and
of ``moments`` in ``mxnet_tpu/ops/linalg.py``).

Plain functions on tensors, layout-aware like the JAX ops: ``layout``
names the data layout (``NCHW`` or ``NHWC``) and the weight layout
follows it (``OIHW`` or ``OHWI``).  Convolutions and dense products go
to PyTorch (cuDNN and cuBLAS on the card), as the JAX package leaves
them to XLA outside any Pallas kernel.  ``BatchNorm`` keeps MXNet's
statistics (biased variance, ``new = momentum * old + (1 - momentum) *
batch``), which are not ``torch.nn.functional.batch_norm``'s.
``LayerNorm`` over the last axis runs the ``layernorm_fwd`` kernel.
``SoftmaxOutput``, the three regression outputs and ``MakeLoss`` write
their own gradient and ignore the head gradient, as the JAX package's
custom VJPs do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..kernels.registry import dispatch

__all__ = ["Activation", "BatchNorm", "BilinearResize2D", "Convolution",
           "Deconvolution", "Dropout", "Embedding", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "LinearRegressionOutput", "LogisticRegressionOutput",
           "MAERegressionOutput", "MakeLoss", "Pooling", "RNN",
           "SoftmaxOutput", "UpSampling", "fused_batch_norm_relu", "log_softmax", "moments",
           "pick", "prelu", "slice_axis", "smooth_l1", "softmax",
           "rnn_param_size", "softmax_cross_entropy", "softmin"]

_DEFAULT_LAYOUTS = {3: "NCW", 4: "NCHW", 5: "NCDHW"}


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _layout(data, layout):
    if not layout or len(layout) != data.dim():
        layout = _DEFAULT_LAYOUTS.get(data.dim())
    if layout is None or layout[0] != "N" or "C" not in layout:
        raise MXNetError("unsupported input rank %d / layout %r"
                         % (data.dim(), layout))
    return layout


def _channels_last(layout):
    return layout.index("C") == len(layout) - 1


def _to_channels_first(t):
    """(N, *sp, C) -> (N, C, *sp) as a strided view, no copy."""
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def _to_channels_last(t):
    """(N, C, *sp) -> (N, *sp, C) as a strided view, no copy."""
    return t.permute(0, *range(2, t.dim()), 1)


def FullyConnected(data, weight, bias=None, num_hidden=0, no_bias=False,
                   flatten=True):
    """Dense layer; ``weight`` is ``(num_hidden, in_units)``."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def Convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout="NCHW"):
    """N-d convolution.  For a channels-last layout the convolution runs
    on channels-last strided views of the data and the OHWI weight, so
    cuDNN sees channels-last memory and returns it without a copy."""
    nsp = data.dim() - 2
    layout = _layout(data, layout)
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    dilate = _tuple(dilate, nsp) if dilate else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    if not data.is_floating_point():
        data = data.to(weight.dtype)
    b = None if no_bias else bias
    if _channels_last(layout):
        out = _CONV[nsp](_to_channels_first(data), _to_channels_first(weight),
                         b, stride, pad, dilate, num_group)
        return _to_channels_last(out)
    return _CONV[nsp](data, weight, b, stride, pad, dilate, num_group)


def Pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, count_include_pad=True,
            pooling_convention="valid", layout="NCHW"):
    """Max or average pooling over the spatial axes of ``layout``.
    ``pooling_convention="full"`` extends the right padding so ragged
    edges are kept (MXNet's ceil mode)."""
    nsp = data.dim() - 2
    layout = _layout(data, layout)
    cl = _channels_last(layout)
    x = _to_channels_first(data) if cl else data
    if pool_type not in ("max", "avg"):
        raise MXNetError("Pooling: bad pool_type %r" % pool_type)
    if global_pool:
        dims = tuple(range(2, x.dim()))
        out = x.amax(dim=dims, keepdim=True) if pool_type == "max" \
            else x.mean(dim=dims, keepdim=True)
        return _to_channels_last(out) if cl else out
    kernel = _tuple(kernel, nsp)
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    extra = [0] * nsp
    if pooling_convention == "full":
        for j in range(nsp):
            rem = (x.shape[2 + j] + 2 * pad[j] - kernel[j]) % stride[j]
            extra[j] = stride[j] - rem if rem else 0
    if nsp == 2 and not any(extra) and pool_type == "max" \
            and all(2 * p <= k for p, k in zip(pad, kernel)):
        out = F.max_pool2d(x, kernel, stride, pad)
    else:
        # explicit padding: -inf for max, 0 for avg
        widths = []
        for j in reversed(range(nsp)):
            widths += [pad[j], pad[j] + extra[j]]
        fill = -math.inf if pool_type == "max" else 0.0
        xp = F.pad(x, widths, value=fill)
        if pool_type == "max":
            out = _POOL[nsp][0](xp, kernel, stride)
        else:
            # the window mean, padding counted
            out = _POOL[nsp][1](xp, kernel, stride)
            if not count_include_pad:
                ones = F.pad(torch.ones_like(x[:1, :1]), widths, value=0.0)
                out = out / _POOL[nsp][1](ones, kernel, stride)
    return _to_channels_last(out) if cl else out


_POOL = {1: (F.max_pool1d, F.avg_pool1d), 2: (F.max_pool2d, F.avg_pool2d),
         3: (F.max_pool3d, F.avg_pool3d)}


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
              output_mean_var=False, training=False, sync=None):
    """Batch normalization with MXNet's statistics; returns ``(out,
    new_moving_mean, new_moving_var)``.  Statistics accumulate in fp32
    whatever the activation dtype.  In training the gradient flows
    through the batch mean and variance (only the moving-mean shift is
    detached).  ``sync``, the batch axis of a data-parallel step
    (:class:`mxnet_tpu_torch.parallel.collectives.BatchSync`), makes the
    batch moments the global batch's: all-reduced over the axis, their
    cotangent too."""
    axis = axis % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    reduce_dims = tuple(i for i in range(data.dim()) if i != axis)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    xf = data.float()
    if training and not use_global_stats:
        # shifted one-pass moments E[(x-c)^2] - E[x-c]^2, c = moving_mean
        c = moving_mean.detach().float().reshape(bshape)
        y = xf - c
        mean_y = y.mean(dim=reduce_dims)
        m2 = (y * y).mean(dim=reduce_dims)
        if sync is not None:
            # the global batch's moments: additive across ranks, being
            # centred on the (replicated) moving mean
            mean_y, m2 = sync.moments(mean_y, m2, differentiable=True)
        var = torch.clamp_min(m2 - mean_y * mean_y, 0.0)
        mean = mean_y + c.reshape(mean_y.shape)
        with torch.no_grad():
            # EMA blended in fp32, stored back at the aux dtype
            new_mean = (momentum * moving_mean.float()
                        + (1 - momentum) * mean).to(moving_mean.dtype)
            new_var = (momentum * moving_var.float()
                       + (1 - momentum) * var).to(moving_var.dtype)
    else:
        # eval: upcast before the eps add
        mean = moving_mean.float()
        var = moving_var.float()
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps) * g.float()
    out = (xf - mean.reshape(bshape)) * inv.reshape(bshape) \
        + beta.reshape(bshape).float()
    return out.to(data.dtype), new_mean, new_var


def fused_batch_norm_relu(data, gamma, beta, moving_mean, moving_var,
                          eps=1e-5, momentum=0.9, fix_gamma=True,
                          use_global_stats=False, axis=1, training=False,
                          sync=None):
    """Fused BatchNorm+ReLU: ``(out, new_moving_mean, new_moving_var)``.
    Over the last axis it runs the kernel tier
    (:func:`mxnet_tpu_torch.kernels.fused_bn_relu.fused_bn_relu`); over
    another axis it is ``relu(BatchNorm(...))`` and launches no kernel,
    as the JAX op falls back to its reference there.  ``sync`` as for
    :func:`BatchNorm`."""
    if axis % data.dim() != data.dim() - 1:
        out, new_mean, new_var = BatchNorm(
            data, gamma, beta, moving_mean, moving_var, eps=eps,
            momentum=momentum, fix_gamma=fix_gamma,
            use_global_stats=use_global_stats, axis=axis, training=training,
            sync=sync)
        return torch.relu(out), new_mean, new_var
    from ..kernels.fused_bn_relu import fused_bn_relu
    return fused_bn_relu(data, gamma, beta, moving_mean, moving_var,
                         eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=axis,
                         training=training, sync=sync)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def Activation(data, act_type="relu"):
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise MXNetError("Activation: bad act_type %r" % act_type) from None
    return fn(data)


def Flatten(data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def softmax(data, axis=-1, temperature=None):
    if temperature is not None:
        data = data / temperature
    return torch.softmax(data, dim=axis)


def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` indexed along ``axis`` by the integer-valued ``index``
    (``mode`` is accepted and unused, as in the JAX package)."""
    axis = axis % data.dim()
    idx = index.long().unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def softmax_cross_entropy(data, label):
    """Summed cross entropy over the batch."""
    return -pick(log_softmax(data, axis=-1), label, axis=-1).sum()


class _LayerNormLastAxis(torch.autograd.Function):
    """Forward: the ``layernorm_fwd`` kernel over a ``(rows, dim)`` view
    (its plain version on the CPU).  Backward: the plain math recomputed
    and differentiated, as the JAX package's ``_ln_pallas_bwd`` does."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps):
        x2d = data.reshape(-1, data.shape[-1]).contiguous()
        out = dispatch("layernorm_fwd", x2d, gamma, beta, eps=eps)
        ctx.save_for_backward(data, gamma, beta)
        ctx.eps = eps
        return out.reshape(data.shape)

    @staticmethod
    def backward(ctx, grad):
        from ..kernels.layernorm import layernorm_reference
        data, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (data, gamma, beta)]
            out = layernorm_reference(*ins, eps=ctx.eps)
            grads = torch.autograd.grad(out, ins, grad)
        return grads + (None,)


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization with fp32 statistics, output at the input
    dtype.  Over the last axis it runs the ``layernorm_fwd`` kernel (the
    port has no ``use_pallas`` switch); over another axis, plain math."""
    axis = axis % data.dim()
    if axis == data.dim() - 1:
        return _LayerNormLastAxis.apply(data, gamma, beta, float(eps))
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=axis, keepdim=True)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    out = (xf - mean) * torch.rsqrt(var + eps) \
        * gamma.reshape(bshape).float() + beta.reshape(bshape).float()
    return out.to(data.dtype)


def Embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` at the (integer-valued, possibly float) ids in
    ``data``; the gradient is a scatter-add.  The other arguments are
    MXNet's and read from ``weight``."""
    return F.embedding(data.long(), weight)


def Dropout(data, p=0.5, axes=(), training=False, generator=None,
            mode="training", cudnn_off=False):
    """Zero each element with probability ``p`` and scale the rest by
    ``1 / (1 - p)``, in training (always, with ``mode="always"``).
    ``axes`` share one draw along those axes.  The mask is drawn from
    ``generator``, by default the port's generator of ``data``'s device
    (:func:`mxnet_tpu_torch.random.generator`)."""
    if p <= 0 or (not training and mode != "always"):
        return data
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    gen = generator if generator is not None \
        else _random.generator(data.device)
    keep = 1.0 - p
    mask = torch.rand(shape, generator=gen, device=data.device) < keep
    return data * mask.to(data.dtype) / keep


def slice_axis(data, axis=0, begin=0, end=None):
    """``data[begin:end]`` along ``axis`` (a view)."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


# ----------------------------------------------------------------------
# The layer ops of the everyday Gluon layers and losses
# ----------------------------------------------------------------------

def _channel_shape(data):
    """Broadcast shape of a per-channel ``(C,)`` vector over axis 1 (axis
    0 of a 1-d input)."""
    shape = [1] * data.dim()
    shape[1 if data.dim() > 1 else 0] = -1
    return shape


def prelu(data, gamma):
    """``x`` where positive, ``gamma * x`` elsewhere, ``gamma`` per
    channel (the JAX package's ``_prelu``)."""
    return torch.where(data > 0, data, gamma.reshape(_channel_shape(data))
                       * data)


def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, training=False,
              generator=None):
    """MXNet's ``LeakyReLU`` family: ``leaky`` (``slope * x`` below 0),
    ``elu`` (``slope * expm1(x)``), ``selu``, ``gelu`` (exact, erf),
    ``prelu`` (``gamma`` per channel) and ``rrelu`` (in training a slope
    drawn per element from U(lower_bound, upper_bound) by ``generator``,
    by default the port's generator of ``data``'s device; their mean
    otherwise).  The JAX op takes the first four; ``prelu`` and ``rrelu``
    follow the reference MXNet operator."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "prelu":
        if gamma is None:
            raise MXNetError("LeakyReLU(act_type='prelu') needs gamma")
        return prelu(data, gamma)
    if act_type == "rrelu":
        if training:
            gen = generator if generator is not None \
                else _random.generator(data.device)
            u = torch.rand(data.shape, generator=gen, device=data.device)
            s = (lower_bound + (upper_bound - lower_bound) * u) \
                .to(data.dtype)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError("LeakyReLU: bad act_type %r" % act_type)


def softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Normalize each sample's channel over its spatial axes (biased
    variance, the input's dtype), then scale and shift per channel."""
    dims = tuple(range(2, data.dim()))
    mean = data.mean(dim=dims, keepdim=True)
    var = data.var(dim=dims, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = _channel_shape(data)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalize each sample over ``num_groups`` groups of its channels
    and their spatial axes (NCHW), then scale and shift per channel."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = _channel_shape(data)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def Deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                  layout="NCHW"):
    """Transposed convolution, the gradient of ``Convolution``: weight
    ``(in_c, out_c / num_group, *k)`` (``(in_c, *k, out_c / num_group)``
    channels-last).  Output extent ``(in - 1) * stride - 2 * pad +
    dilate * (k - 1) + 1 + adj``: the full transposed product cropped by
    ``pad`` on each side and extended by ``adj`` zeros-or-products on
    the right, so ``adj`` may reach past ``stride`` as in the JAX op
    (which, like this one, takes no ``target_shape``)."""
    nsp = data.dim() - 2
    if layout and len(layout) == data.dim() and _channels_last(layout):
        w = weight.permute(0, weight.dim() - 1, *range(1, weight.dim() - 1))
        out = Deconvolution(_to_channels_first(data), w, bias, kernel,
                            stride, dilate, pad, adj, num_filter, num_group,
                            no_bias, layout=None)
        return _to_channels_last(out)
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    dilate = _tuple(dilate, nsp) if dilate else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    adj = _tuple(adj, nsp) if adj else (0,) * nsp
    full = _CONV_T[nsp](data, weight, None, stride, 0, 0, num_group, dilate)
    idx = [slice(None), slice(None)]
    widths = []
    for j in range(nsp):
        size = full.shape[2 + j] - 2 * pad[j] + adj[j]
        idx.append(slice(pad[j], pad[j] + size))
        widths = [0, max(0, adj[j] - pad[j])] + widths
    out = F.pad(full, widths)[tuple(idx)] if any(widths) \
        else full[tuple(idx)]
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return out


def UpSampling(*data, scale=1, sample_type="nearest", num_args=1):
    """Nearest: each pixel of the first input repeated ``scale`` times
    along H and W.  Bilinear: a resize to ``scale`` times H and W with
    half-pixel centers (the JAX op's ``jax.image.resize``)."""
    x = data[0]
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return _resize_bilinear(x, x.shape[2] * scale, x.shape[3] * scale)


def _resize_bilinear(x, h, w):
    """``jax.image.resize(x, (N, C, h, w), "bilinear")``: half-pixel
    centers, and a triangle kernel widened by the scale when shrinking
    (antialiased), edges renormalized."""
    out = x.float()
    for axis, size in ((2, h), (3, w)):
        out = _resize_axis(out, axis, int(size))
    return out.to(x.dtype)


def _resize_axis(x, axis, size):
    n_in = x.shape[axis]
    if n_in == size:
        return x
    scale = size / n_in
    kscale = min(scale, 1.0)        # widen the kernel when shrinking
    centers = (torch.arange(size, dtype=torch.float64) + 0.5) / scale - 0.5
    src = torch.arange(n_in, dtype=torch.float64)
    wts = torch.clamp_min(
        1.0 - (centers[:, None] - src[None, :]).abs() * kscale, 0.0)
    wts = wts / wts.sum(dim=1, keepdim=True).clamp_min(1e-12)
    moved = x.movedim(axis, -1)
    out = torch.matmul(moved, wts.to(x.dtype).t().to(x.device))
    return out.movedim(-1, axis)


def BilinearResize2D(data, height=0, width=0, scale_height=None,
                     scale_width=None):
    """Bilinear resize of an NCHW input to ``(height, width)`` or by
    ``scale_height``/``scale_width``, with the JAX op's convention
    (``jax.image.resize``: half-pixel centers, antialiased when
    shrinking)."""
    h = int(data.shape[2] * scale_height) if scale_height else height
    w = int(data.shape[3] * scale_width) if scale_width else width
    return _resize_bilinear(data, h, w)


def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(data.abs() < 1.0 / s2, 0.5 * s2 * data * data,
                       data.abs() - 0.5 / s2)


def moments(data, axes=None, keepdims=False):
    """Mean and (biased) variance over ``axes`` (every axis by
    default)."""
    dims = tuple(range(data.dim())) if axes is None \
        else tuple(int(a) for a in axes)
    return (data.mean(dim=dims, keepdim=keepdims),
            data.var(dim=dims, keepdim=keepdims, unbiased=False))


class _SoftmaxOutput(torch.autograd.Function):
    """Forward ``softmax``; backward ``(p - one_hot(label)) *
    grad_scale``, masked and normalized, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization):
        axis = 1 if multi_output else -1
        prob = torch.softmax(data, dim=axis)
        ctx.save_for_backward(prob, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, multi_output,
                    normalization)
        return prob

    @staticmethod
    def backward(ctx, _head):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi_output, norm = ctx.args
        axis = 1 if multi_output else -1
        lab = label.long()
        onehot = F.one_hot(lab.clamp_min(0), prob.shape[axis]) \
            .to(prob.dtype) * (lab >= 0).unsqueeze(-1).to(prob.dtype)
        if multi_output:
            onehot = onehot.movedim(-1, 1)
        grad = prob - onehot
        keep = label != ignore_label
        if use_ignore:
            grad = grad * keep.to(prob.dtype).unsqueeze(axis)
        if norm == "batch":
            grad = grad / prob.shape[0]
        elif norm == "valid":
            valid = keep.sum().clamp_min(1) if use_ignore else label.numel()
            grad = grad / valid
        return (grad * grad_scale, None, None, None, None, None, None)


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  use_ignore=False, multi_output=False,
                  normalization="null"):
    """Softmax whose backward writes the cross-entropy gradient
    ``(p - one_hot(label)) * grad_scale`` and ignores the head gradient;
    ``normalization`` ``null``, ``batch`` or ``valid``."""
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError("SoftmaxOutput: bad normalization %r"
                         % (normalization,))
    return _SoftmaxOutput.apply(data, label.detach(), float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                bool(multi_output), normalization)


class _RegressionOutput(torch.autograd.Function):
    """Forward ``data`` (``sigmoid(data)`` for the logistic kind);
    backward ``(out - label)`` (its sign for MAE) times ``grad_scale``
    over the entries of one sample, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.grad_scale, ctx.kind = grad_scale, kind
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        n = out.shape[0] if out.dim() else 1
        grad = grad * ctx.grad_scale / (out.numel() // max(n, 1))
        return grad, None, None, None


def LinearRegressionOutput(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.detach(), float(grad_scale),
                                   "linear")


def MAERegressionOutput(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.detach(), float(grad_scale),
                                   "mae")


def LogisticRegressionOutput(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.detach(), float(grad_scale),
                                   "logistic")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward ``grad_scale`` everywhere, whatever
    the head gradient."""

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, head):
        return torch.full_like(head, ctx.grad_scale), None


def MakeLoss(data, grad_scale=1.0, normalization="null"):
    """Mark ``data`` as a loss: its gradient is ``grad_scale`` (the JAX
    op ignores ``normalization``)."""
    return _MakeLoss.apply(data, float(grad_scale))


# ----------------------------------------------------------------------
# Fused RNN (reference: src/operator/rnn.cc, cuDNN path cudnn_rnn-inl.h)
# ----------------------------------------------------------------------

# gates a mode's recurrence computes; each mode is also the name of
# PyTorch's fused recurrence (``torch._VF.lstm``, ...: cuDNN's RNN on
# the card, ATen's on the CPU), whose gate orders are the JAX package's
# (LSTM i, f, g, o; GRU r, z, n with n = tanh(xn + r * (W_hn h + b_hn)))
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _gates_for(mode):
    try:
        return _GATES[mode]
    except KeyError:
        raise MXNetError("RNN: unknown mode %r; choose from %s"
                         % (mode, ", ".join(sorted(_GATES)))) from None


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total flat parameter count, matching the layout of
    :func:`_rnn_unpack`."""
    g = _gates_for(mode)
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        per_dir = g * state_size * in_sz + g * state_size * state_size \
            + 2 * g * state_size
        total += per_dir * dirs
    return total


def _rnn_unpack(params, mode, input_size, state_size, num_layers,
                bidirectional):
    """Views of the flat parameter vector, per layer and direction:
    ``(W_ih (G*H, in), W_hh (G*H, H), b_ih (G*H,), b_hh (G*H,))``, in
    that order for each layer, for each direction (the JAX package's
    documented layout)."""
    g = _gates_for(mode)
    dirs = 2 if bidirectional else 1
    gh = g * state_size
    want = rnn_param_size(mode, input_size, state_size, num_layers,
                          bidirectional)
    if params.numel() != want:
        raise MXNetError("RNN: %d parameters given, %s needs %d"
                         % (params.numel(), mode, want))
    layers, off = [], 0

    def take(n, shape):
        nonlocal off
        out = params[off:off + n].view(shape)
        off += n
        return out

    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        layers.append([(take(gh * in_sz, (gh, in_sz)),
                        take(gh * state_size, (gh, state_size)),
                        take(gh, (gh,)), take(gh, (gh,)))
                       for _ in range(dirs)])
    return layers


def _rnn_cell_step(mode, x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One time step of one direction, written out (the JAX
    ``lax.scan`` body): ``(h', c')``.  The op runs the fused recurrence
    (:func:`_run_rnn_layer`); this is its plain statement, which the
    tests hold it to."""
    if mode == "gru":
        xr, xz, xn = torch.addmm(b_ih, x, w_ih.t()).chunk(3, -1)
        hr, hz, hn = torch.addmm(b_hh, h, w_hh.t()).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    gates = torch.addmm(b_ih, x, w_ih.t()) + torch.addmm(b_hh, h, w_hh.t())
    if mode == "lstm":
        i, f, g, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    return (torch.relu(gates) if mode == "rnn_relu"
            else torch.tanh(gates)), c


def _run_rnn_layer(mode, x, h0, c0, wts, reverse):
    """One direction of one layer over time, ``x`` ``(T, N, in)``:
    ``(ys (T, N, H), hT, cT)``.  One call of PyTorch's fused recurrence
    with ``num_layers=1`` and no dropout of its own.  Its ``train`` flag
    (cuDNN keeps the reserve its backward reads) is set whenever a
    gradient is to be taken, whatever the mode: the op's own dropout is
    applied outside it."""
    xs = torch.flip(x, (0,)) if reverse else x
    fn = getattr(torch._VF, mode)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, h0, c0) + tuple(wts))
    if mode == "lstm":
        ys, hT, cT = fn(xs, (h0.unsqueeze(0), c0.unsqueeze(0)), list(wts),
                        True, 1, 0.0, keep, False, False)
        cT = cT[0]
    else:
        ys, hT = fn(xs, h0.unsqueeze(0), list(wts), True, 1, 0.0, keep,
                    False, False)
        cT = c0
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, hT[0], cT


def RNN(data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=True, training=False, generator=None):
    """Fused multi-layer RNN over time-major ``data`` ``(T, N, input)``
    with the flat ``parameters`` of :func:`_rnn_unpack` and initial
    states ``(num_layers * dirs, N, H)``.  Returns ``(out, hy, cy)`` for
    ``lstm``, else ``(out, hy)``.  Each direction of each layer is one
    call of PyTorch's fused recurrence (cuDNN on the card); in training,
    inverted dropout of rate ``p`` follows every layer but the last, its
    mask drawn from ``generator`` (by default the port's generator of
    ``data``'s device)."""
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    if data.dim() != 3:
        raise MXNetError("RNN: data must be (T, N, input), got %s"
                         % (tuple(data.shape),))
    if state.shape[0] != num_layers * dirs or state.shape[-1] != H:
        raise MXNetError("RNN: state must be (%d, N, %d), got %s"
                         % (num_layers * dirs, H, tuple(state.shape)))
    if mode == "lstm" and state_cell is None:
        raise MXNetError("RNN: lstm needs state_cell")
    layers = _rnn_unpack(parameters, mode, data.shape[2], H, num_layers,
                         bidirectional)
    x = data
    hys, cys = [], []
    for li, per_dir in enumerate(layers):
        outs = []
        for d in range(dirs):
            h0 = state[li * dirs + d]
            c0 = state_cell[li * dirs + d] if mode == "lstm" else h0
            ys, hT, cT = _run_rnn_layer(mode, x, h0, c0, per_dir[d], d == 1)
            outs.append(ys)
            hys.append(hT)
            cys.append(cT)
        x = torch.cat(outs, dim=-1) if dirs > 1 else outs[0]
        if p > 0 and training and li < num_layers - 1:
            x = Dropout(x, p=p, training=True, generator=generator)
    hy = torch.stack(hys, dim=0)
    if mode == "lstm":
        return x, hy, torch.stack(cys, dim=0)
    return x, hy
