"""Random sampling operators (counterpart of
``mxnet_tpu/ops/random_ops.py``).

Every sampler draws from the port's generator of the device it samples
on (:func:`mxnet_tpu_torch.random.generator`), so one
:func:`mxnet_tpu_torch.random.seed` repeats a run.  The numbers differ
from the JAX package's for the same seed (another generator): tests hold
shapes, dtypes, ranges and moments.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from .table import register, torch_dtype


def _gen(device):
    return _random.generator(device if device is not None else "cpu")


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _gamma(alpha, shape, device):
    """Gamma(alpha, 1) draws of ``shape`` (fp32)."""
    conc = torch.full(shape, float(alpha), device=device)
    return torch._standard_gamma(conc, generator=_gen(device))


@register("_random_uniform", args=(), aliases=("random_uniform",))
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                    device=None):
    out = torch.rand(_shape(shape), generator=_gen(device), device=device)
    return (low + (high - low) * out).to(torch_dtype(dtype))


@register("_random_normal", args=(), aliases=("random_normal", "normal"))
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                   device=None):
    out = torch.randn(_shape(shape), generator=_gen(device), device=device)
    return (loc + scale * out).to(torch_dtype(dtype))


@register("_random_gamma", args=())
def _random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  device=None):
    return (beta * _gamma(alpha, _shape(shape), device)).to(
        torch_dtype(dtype))


@register("_random_exponential", args=())
def _random_exponential(lam=1.0, shape=(), dtype="float32", device=None):
    out = torch.empty(_shape(shape), device=device)
    return out.exponential_(lam, generator=_gen(device)).to(
        torch_dtype(dtype))


@register("_random_poisson", args=())
def _random_poisson(lam=1.0, shape=(), dtype="float32", device=None):
    rate = torch.full(_shape(shape), float(lam), device=device)
    return torch.poisson(rate, generator=_gen(device)).to(torch_dtype(dtype))


@register("_random_negative_binomial", args=())
def _random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                              device=None):
    rate = _gamma(k, _shape(shape), device) * (1 - p) / p
    return torch.poisson(rate, generator=_gen(device)).to(torch_dtype(dtype))


@register("_random_randint", args=())
def _random_randint(low=0, high=1, shape=(), dtype="int32", device=None):
    return torch.randint(low, high, _shape(shape), generator=_gen(device),
                         device=device).to(torch_dtype(dtype))


@register("_sample_multinomial", args=("data",),
          aliases=("sample_multinomial",))
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Categorical draws from the probabilities on ``data``'s last axis:
    ``shape`` draws per row (one, unshaped, by default); with
    ``get_prob`` also each draw's log-probability."""
    n = math.prod(_shape(shape)) if shape else 1
    rows = data.reshape(-1, data.shape[-1]).clamp_min(1e-37)
    s = torch.multinomial(rows, n, replacement=True,
                          generator=_gen(data.device))
    s = s.reshape(data.shape[:-1] + ((n,) if shape else ()))
    out = s.to(torch_dtype(dtype))
    if not get_prob:
        return out
    logp = torch.log(data.clamp_min(1e-37)) - torch.log(
        data.sum(-1, keepdim=True))
    picked = torch.gather(logp, -1, s.reshape(data.shape[:-1] + (-1,)))
    return out, picked.reshape(s.shape)


@register("_shuffle", aliases=("shuffle",))
def _shuffle(data):
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", args=())
def _sample_unique_zipfian(range_max=1, shape=(), device=None):
    u = torch.rand(_shape(shape), generator=_gen(device), device=device)
    out = (torch.exp(u * math.log(range_max + 1.0)) - 1.0).to(torch.int32)
    return out.clamp(0, range_max - 1)


@register("_random_uniform_like")
def _random_uniform_like(data, low=0.0, high=1.0, loc=0.0, scale=1.0):
    out = torch.rand(data.shape, generator=_gen(data.device),
                     device=data.device)
    return (low + (high - low) * out).to(data.dtype)


@register("_random_normal_like")
def _random_normal_like(data, low=0.0, high=1.0, loc=0.0, scale=1.0):
    out = torch.randn(data.shape, generator=_gen(data.device),
                      device=data.device)
    return (loc + scale * out).to(data.dtype)
