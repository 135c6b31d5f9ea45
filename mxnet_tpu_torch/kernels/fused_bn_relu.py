"""Registry entries and call surface of fused BatchNorm+ReLU
(counterpart of ``mxnet_tpu/kernels/fused_bn_relu.py``).

Two kernels, each with its plain version:

- ``bn_relu_apply`` -- the forward pass ``relu(x * scale + offset)``;
- ``bn_relu_bwd`` -- the backward pass ``dx``.

:func:`fused_bn_relu` is the whole op the gluon fusion sites call: the
per-channel batch statistics (fp32, shifted one-pass moments, the same
math as :func:`mxnet_tpu_torch.ops.nn.BatchNorm`), the running-statistic
update, and the apply pass through :class:`~..ops.fused_bn_relu.BNReluApply`.
A CUDA activation launches the Hopper kernels, a CPU one runs the plain
versions.  Channels-last only: the caller pairs a ``BatchNorm`` only
when its axis is the input's last.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.fused_bn_relu import (BNReluApply, bn_relu_apply_cuda,
                                 bn_relu_apply_reference, bn_relu_bwd_cuda,
                                 bn_relu_bwd_reference)
from .costs import bn_relu_apply_cost, bn_relu_bwd_cost
from .registry import KernelSpec, register_kernel

__all__ = ["fused_bn_relu"]

register_kernel(KernelSpec(
    name="bn_relu_apply",
    plain=bn_relu_apply_reference,
    launch=bn_relu_apply_cuda,
    source="csrc/fused_bn_relu.cu",
    replaces="mxnet_tpu/kernels/fused_bn_relu.py:57 bn_relu_apply_pallas",
    cost=bn_relu_apply_cost,
    category="elementwise_fusion",
    remedies=("unfused-elementwise",),
))

register_kernel(KernelSpec(
    name="bn_relu_bwd",
    plain=bn_relu_bwd_reference,
    launch=bn_relu_bwd_cuda,
    source="csrc/fused_bn_relu.cu",
    replaces="mxnet_tpu/kernels/fused_bn_relu.py:93 bn_relu_bwd_pallas",
    cost=bn_relu_bwd_cost,
    category="elementwise_fusion",
    remedies=("unfused-elementwise",),
))


def fused_bn_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                  momentum=0.9, fix_gamma=True, use_global_stats=False,
                  axis=-1, training=False, sync=None):
    """Fused BatchNorm+ReLU: ``(out, new_moving_mean, new_moving_var)``,
    the contract of the ``BatchNorm`` op plus the relu epilogue.
    ``axis`` must be the last axis of ``data``.  ``sync``, the batch
    axis of a data-parallel step
    (:class:`mxnet_tpu_torch.parallel.collectives.BatchSync`), makes the
    training statistics (forward moments, backward sums) the global
    batch's."""
    if axis not in (-1, data.dim() - 1):
        raise MXNetError("fused_bn_relu is channels-last: axis %d of a "
                         "%d-d input is not the last" % (axis, data.dim()))
    c = data.shape[-1]
    x2d = data.reshape(-1, c).contiguous()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    gf = g.float()
    batch_stats = bool(training) and not use_global_stats
    sync = sync if batch_stats else None
    with torch.no_grad():
        if batch_stats:
            # shifted one-pass moments: the two reductions are
            # independent, and the moving-mean shift bounds the
            # cancellation of E[y^2] - E[y]^2
            shift = moving_mean.float()
            y = x2d.float() - shift[None, :]
            mean_y = y.mean(dim=0)
            m2 = (y * y).mean(dim=0)
            if sync is not None:
                mean_y, m2 = sync.moments(mean_y, m2)
            var = torch.clamp_min(m2 - mean_y * mean_y, 0.0)
            mean = mean_y + shift
            # EMA blended in fp32, stored back at the aux dtype
            new_mean = (momentum * moving_mean.float()
                        + (1 - momentum) * mean).to(moving_mean.dtype)
            new_var = (momentum * moving_var.float()
                       + (1 - momentum) * var).to(moving_var.dtype)
        else:
            mean = moving_mean.float().clone()
            var = moving_var.float().clone()
            new_mean, new_var = moving_mean, moving_var
    out2d = BNReluApply.apply(x2d, gf, beta, mean, var, float(eps),
                              batch_stats, sync)
    return out2d.reshape(data.shape), new_mean, new_var
