"""Fused BatchNorm+ReLU apply passes, forward and backward (counterpart
of ``mxnet_tpu/kernels/fused_bn_relu.py``'s Pallas kernels and custom
VJP).

- :func:`bn_relu_apply_reference` / :func:`bn_relu_apply_cuda` --
  ``relu(x * scale + offset)`` over a channels-last ``(rows, C)`` view,
  with ``scale = gamma * rsqrt(var + eps)`` and ``offset = beta -
  mean * scale`` folded into fp32 ``(C,)`` vectors.
- :func:`bn_relu_bwd_reference` / :func:`bn_relu_bwd_cuda` -- ``dx =
  a * (dyr - c1 - xhat * c2)`` with ``dyr`` the relu-masked cotangent
  and ``xhat = (x - mean) * inv``; the fp32 ``(C,)`` vectors ``a =
  gamma * inv``, ``mean``, ``inv``, ``c1``, ``c2`` come from the caller.
- :class:`BNReluApply` -- the autograd function around the two passes.
  Mean and variance arrive detached; in training with batch statistics
  their backward is folded into ``c1 = sum(dyr) / m`` and ``c2 =
  sum(dyr * xhat) / m``, zeros otherwise.  The two reductions are plain
  PyTorch, as the JAX package leaves them to XLA outside the kernel.

The ``*_cuda`` functions wrap the hand-written Hopper kernels of
``csrc/fused_bn_relu.cu`` (built on first use by
:mod:`mxnet_tpu_torch._build`); the ``*_reference`` functions are their
plain PyTorch versions, which run the CPU path and are the oracle the
kernels are held against on the card.  Activations are fp32 or bf16;
math is fp32 and results are stored at the activation dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from ..kernels.registry import count_launch, dispatch

__all__ = ["BNReluApply", "bn_relu_apply_cuda", "bn_relu_apply_reference",
           "bn_relu_bwd_cuda", "bn_relu_bwd_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bn_relu_apply_reference(x2d, scale, offset):
    """Plain version of the forward pass."""
    y = x2d.float() * scale[None, :] + offset[None, :]
    return torch.clamp_min(y, 0.0).to(x2d.dtype)


def bn_relu_bwd_reference(x2d, dy2d, y2d, a, mean, inv, c1, c2):
    """Plain version of the backward pass."""
    dyr = torch.where(y2d.float() > 0.0, dy2d.float(), 0.0)
    xhat = (x2d.float() - mean[None, :]) * inv[None, :]
    dx = a[None, :] * (dyr - c1[None, :] - xhat * c2[None, :])
    return dx.to(x2d.dtype)


def _check(fn, rows_like, vectors):
    """Raise unless every ``(name, tensor)`` of ``rows_like`` is a
    contiguous CUDA ``(rows, C)`` tensor of one fp32/bf16 dtype and
    every one of ``vectors`` a contiguous fp32 ``(C,)`` tensor on the
    same device."""
    name0, x = rows_like[0]
    dev = x.device
    if dev.type != "cuda":
        raise MXNetError("%s needs CUDA tensors, got %s on %s"
                         % (fn, name0, dev))
    if x.dim() != 2:
        raise MXNetError("%s: %s must be (rows, C), got %s"
                         % (fn, name0, tuple(x.shape)))
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError("%s: activations must be float32 or bfloat16, "
                         "got %s" % (fn, x.dtype))
    c = x.shape[1]
    for name, t in rows_like + vectors:
        if t.device != dev:
            raise MXNetError("%s: %s on %s, %s on %s"
                             % (fn, name, t.device, name0, dev))
        if not t.is_contiguous():
            raise MXNetError("%s: %s is not contiguous" % (fn, name))
    for name, t in rows_like[1:]:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise MXNetError("%s: %s is %s %s, %s is %s %s"
                             % (fn, name, tuple(t.shape), t.dtype, name0,
                                tuple(x.shape), x.dtype))
    for name, t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise MXNetError("%s: %s must be float32 of shape (%d,), got "
                             "%s %s" % (fn, name, c, t.dtype,
                                        tuple(t.shape)))


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("fused_bn_relu")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.bn_relu_fwd_launch.argtypes = [p, p, p, p, i64, i, i, p]
    lib.bn_relu_fwd_launch.restype = i
    lib.bn_relu_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i64, i,
                                       i, p]
    lib.bn_relu_bwd_launch.restype = i
    lib.bn_relu_error_string.argtypes = [i]
    lib.bn_relu_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc, what):
    if rc != 0:
        raise MXNetError("%s kernel launch failed: %s (%d)"
                         % (what, lib.bn_relu_error_string(rc).decode(), rc))


def bn_relu_apply_cuda(x2d, scale, offset):
    """Launch the forward kernel on PyTorch's current stream; returns
    ``relu(x2d * scale + offset)`` in ``x2d``'s dtype."""
    _check("bn_relu_apply_cuda", [("x", x2d)],
           [("scale", scale), ("offset", offset)])
    lib = _lib()
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.bn_relu_fwd_launch(
            x2d.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            out.data_ptr(), x2d.shape[0], x2d.shape[1],
            _DTYPE_CODES[x2d.dtype], stream)
    _raise_on(lib, rc, "bn_relu_apply")
    count_launch("bn_relu_apply", x2d.dtype,
                 cost_args=((x2d, scale, offset), {}))
    return out


def bn_relu_bwd_cuda(x2d, dy2d, y2d, a, mean, inv, c1, c2):
    """Launch the backward kernel on PyTorch's current stream (read at
    call time: backward runs on autograd's thread); returns ``dx`` in
    ``x2d``'s dtype."""
    _check("bn_relu_bwd_cuda", [("x", x2d), ("dy", dy2d), ("y", y2d)],
           [("a", a), ("mean", mean), ("inv", inv), ("c1", c1),
            ("c2", c2)])
    lib = _lib()
    dx = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.bn_relu_bwd_launch(
            x2d.data_ptr(), dy2d.data_ptr(), y2d.data_ptr(), a.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            dx.data_ptr(), x2d.shape[0], x2d.shape[1],
            _DTYPE_CODES[x2d.dtype], stream)
    _raise_on(lib, rc, "bn_relu_bwd")
    count_launch("bn_relu_bwd", x2d.dtype,
                 cost_args=((x2d, dy2d, y2d, a, mean, inv, c1, c2), {}))
    return dx


class BNReluApply(torch.autograd.Function):
    """``relu((x - mean) * gamma * rsqrt(var + eps) + beta)`` over a
    channels-last ``(rows, C)`` view, with the backward of the training
    statistics folded into ``dx`` (port of ``_bn_relu_apply`` and its
    custom VJP).  ``mean``/``var`` are fp32 and detached; ``gamma`` is
    the effective fp32 scale (ones when ``fix_gamma``).  ``sync``, the
    batch axis of a data-parallel step or None: the statistics are the
    global batch's, so the backward all-reduces its two sums over the
    axis (``gamma``'s and ``beta``'s gradients stay this rank's, summed
    with the other gradients)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, mean, var, eps, batch_stats,
                sync=None):
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        offset = beta.float() - mean * scale
        y2d = dispatch("bn_relu_apply", x2d, scale.contiguous(),
                       offset.contiguous())
        ctx.save_for_backward(x2d, y2d, gamma, mean, inv)
        ctx.batch_stats = batch_stats
        ctx.sync = sync
        ctx.beta_dtype = beta.dtype
        return y2d

    @staticmethod
    def backward(ctx, dy):
        x2d, y2d, gamma, mean, inv = ctx.saved_tensors
        dy = dy.contiguous()
        dyr = torch.where(y2d > 0, dy, 0).float()
        xhat = (x2d.float() - mean[None, :]) * inv[None, :]
        sum_dyr = dyr.sum(dim=0)
        sum_dyr_xhat = (dyr * xhat).sum(dim=0)
        m = x2d.shape[0]
        if ctx.batch_stats and ctx.sync is not None:
            sums = ctx.sync.sum_(torch.cat([sum_dyr, sum_dyr_xhat]))
            m *= ctx.sync.size
            c = sum_dyr.shape[0]
            c1, c2 = sums[:c] / m, sums[c:] / m
        elif ctx.batch_stats:
            c1, c2 = sum_dyr / m, sum_dyr_xhat / m
        else:
            c1 = c2 = torch.zeros_like(sum_dyr)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = dispatch("bn_relu_bwd", x2d, dy, y2d,
                          (gamma * inv).contiguous(), mean.contiguous(),
                          inv.contiguous(), c1.contiguous(),
                          c2.contiguous())
        dgamma = sum_dyr_xhat if ctx.needs_input_grad[1] else None
        dbeta = sum_dyr.to(ctx.beta_dtype) if ctx.needs_input_grad[2] \
            else None
        return dx, dgamma, dbeta, None, None, None, None, None
