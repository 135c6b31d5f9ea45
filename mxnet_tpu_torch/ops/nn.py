"""Neural-network operators of the training slices (counterpart of the
subset of ``mxnet_tpu/ops/nn.py`` that ResNet and BERT reach).

Plain functions on tensors, layout-aware like the JAX ops: ``layout``
names the data layout (``NCHW`` or ``NHWC``) and the weight layout
follows it (``OIHW`` or ``OHWI``).  Convolutions and dense products go
to PyTorch (cuDNN and cuBLAS on the card), as the JAX package leaves
them to XLA outside any Pallas kernel.  ``BatchNorm`` keeps MXNet's
statistics (biased variance, ``new = momentum * old + (1 - momentum) *
batch``), which are not ``torch.nn.functional.batch_norm``'s.
``LayerNorm`` over the last axis runs the ``layernorm_fwd`` kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..kernels.registry import dispatch

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "Embedding",
           "Flatten", "FullyConnected", "LayerNorm", "Pooling",
           "fused_batch_norm_relu", "log_softmax", "pick", "slice_axis",
           "softmax", "softmax_cross_entropy"]

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
              training=False):
    """Batch normalization with MXNet's statistics; returns ``(out,
    new_moving_mean, new_moving_var)``.  Statistics accumulate in fp32
    whatever the activation dtype.  In training the gradient flows
    through the batch mean and variance (only the moving-mean shift is
    detached)."""
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
                          use_global_stats=False, axis=-1, training=False):
    """Fused BatchNorm+ReLU through the kernel tier
    (:func:`mxnet_tpu_torch.kernels.fused_bn_relu.fused_bn_relu`):
    ``(out, new_moving_mean, new_moving_var)``.  Channels-last only; it
    raises on any other ``axis``."""
    from ..kernels.fused_bn_relu import fused_bn_relu
    return fused_bn_relu(data, gamma, beta, moving_mean, moving_var,
                         eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=axis,
                         training=training)


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
