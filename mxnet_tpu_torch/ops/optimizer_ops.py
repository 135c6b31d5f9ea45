"""Optimizer update operators (counterpart of the SGD subset of
``mxnet_tpu/ops/optimizer_ops.py``).

MXNet's forms, exactly: ``g = clip(grad * rescale_grad) + wd * weight``;
``sgd_update``: ``w' = w - lr * g``; ``sgd_mom_update``: ``mom' =
momentum * mom - lr * g``, ``w' = w + mom'``.  Where the JAX ops return
new arrays, these update ``weight`` (and ``mom``) in place under
``torch.no_grad()``, so a step allocates no second copy of the model.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_mom_update", "sgd_update"]


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
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
