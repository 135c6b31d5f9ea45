"""Optimizer update operators (counterpart of the SGD, LARS and LAMB
subset of ``mxnet_tpu/ops/optimizer_ops.py``).

MXNet's forms, exactly: ``g = clip(grad * rescale_grad) + wd * weight``;
``sgd_update``: ``w' = w - lr * g``; ``sgd_mom_update``: ``mom' =
momentum * mom - lr * g``, ``w' = w + mom'``; ``lars_update``: ``mom' =
momentum * mom + lr * trust * g``, ``w' = w - mom'`` with the per-tensor
trust ratio; ``lamb_update_phase1`` the LAMB moments and update
direction, ``lamb_update_phase2`` the trust-ratio step.  Where the JAX
ops return new arrays, these update ``weight`` (and ``mom``, ``mean``,
``var``) in place under ``torch.no_grad()``, so a step allocates no
second copy of the model.

``lr``, ``wd`` and ``rescale_grad`` may be 0-d fp32 tensors (a captured
``TrainStep`` feeds them from the device); the update of a tensor below
fp32 is then computed in fp32, so a scalar is never rounded to the
weight's dtype.
"""
from __future__ import annotations

import torch

from ..kernels.optimizer_update import l2_norm

__all__ = ["lamb_update_phase1", "lamb_update_phase2", "lars_update",
           "sgd_mom_update", "sgd_update"]


def _fp32_if_fed(scalar, *tensors):
    """``tensors`` upcast to fp32 where ``scalar`` is a tensor."""
    if isinstance(scalar, torch.Tensor):
        return tuple(t.float() for t in tensors)
    return tensors


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    grad, weight = _fp32_if_fed(rescale_grad, grad, weight)
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.sub_(lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * g)
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def lars_update(weight, grad, mom, lr=0.01, momentum=0.9, eta=0.001,
                epsilon=1e-9, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """LARS: the learning rate scaled by the trust ratio ``eta * ||w|| /
    (||g|| + wd * ||w|| + eps)`` of this tensor (1 where either norm is
    0), ``g = clip(grad * rescale_grad)``; ``mom' = momentum * mom + lr *
    trust * (g + wd * w)``, ``w' = w - mom'``."""
    wf, grad = _fp32_if_fed(rescale_grad, weight, grad)
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    w_norm, g_norm = l2_norm(wf), l2_norm(g)
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + epsilon), 1.0)
    mom.copy_(momentum * mom + (lr * trust) * (g + wd * wf))
    weight.sub_(mom)
    return weight, mom


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB phase 1: updates ``mean`` and ``var`` in place and returns
    the update direction ``mean_hat / (sqrt(var_hat) + eps) + wd *
    weight``."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * (g * g))
    if bias_correction:
        mh = mean / (1 - beta1 ** t)
        vh = var / (1 - beta2 ** t)
    else:
        mh, vh = mean, var
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight


@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr=0.001, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB phase 2: ``weight -= lr * ratio * g`` in place, ``ratio =
    r1 / r2`` (``r1 = ||weight||`` clipped to the bounds, ``r2 =
    ||g||``), 1 where either norm is 0."""
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 == 0) | (r2 == 0), 1.0, r1 / r2)
    weight.sub_(lr * ratio * g)
    return weight
