"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``):
samplers that place their draws on ``ctx``, by default the current
context, drawn from the port's generator of that device."""
from __future__ import annotations

from .ndarray import invoke

__all__ = ["exponential", "gamma", "multinomial", "negative_binomial",
           "normal", "normal_like", "poisson", "randint", "randn",
           "shuffle", "uniform", "uniform_like"]


def _sample(opname, shape, ctx, dtype, out=None, **params):
    params.update(shape=() if shape is None else shape, dtype=dtype, ctx=ctx)
    return invoke(opname, [], params, out=out)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kwargs):
    return _sample("_random_uniform", shape, ctx, dtype, out, low=low,
                   high=high)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kwargs):
    return _sample("_random_normal", shape, ctx, dtype, out, loc=loc,
                   scale=scale)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          **kwargs):
    return _sample("_random_gamma", shape, ctx, dtype, alpha=alpha,
                   beta=beta)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, **kwargs):
    return _sample("_random_exponential", shape, ctx, dtype,
                   lam=1.0 / scale)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, **kwargs):
    return _sample("_random_poisson", shape, ctx, dtype, lam=lam)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      **kwargs):
    return _sample("_random_negative_binomial", shape, ctx, dtype, k=k, p=p)


def randint(low, high, shape=None, dtype="int32", ctx=None, **kwargs):
    return _sample("_random_randint", shape, ctx, dtype, low=low, high=high)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kwargs):
    params = {"get_prob": get_prob, "dtype": dtype}
    if shape is not None:
        params["shape"] = shape
    return invoke("_sample_multinomial", [data], params)


def shuffle(data, **kwargs):
    return invoke("_shuffle", [data], {})


def uniform_like(data, low=0.0, high=1.0):
    return invoke("_random_uniform_like", [data], {"low": low, "high": high})


def normal_like(data, loc=0.0, scale=1.0):
    return invoke("_random_normal_like", [data], {"loc": loc,
                                                  "scale": scale})
