"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

An :class:`Initializer` fills a tensor in place, by the parameter's
name first: names ending in ``bias`` or ``beta`` get 0, ``gamma`` 1,
``running_mean``/``moving_mean`` 0 and ``running_var``/``moving_var``
1; any other name is a weight and gets the initializer's own rule.
Random rules draw from an explicit :class:`torch.Generator` (the
process-wide default generator when none is given), on the CPU, and
copy into the target, so a seed gives the same numbers on every device.
The numbers differ from the JAX package's, which draws from numpy;
tests carry weights across instead (``gluon.convert``).
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Normal", "One", "Uniform", "Xavier", "Zero",
           "create", "register"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from an instance, a registered name or ``None``
    (the default, :class:`Uniform`)."""
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform()
    key = str(name).lower()
    key = {"zeros": "zero", "ones": "one", "gaussian": "normal"}.get(key, key)
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[key](**kwargs)


class Initializer:
    """Base initializer; ``init(name, tensor, generator)`` fills
    ``tensor`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        lname = str(name).lower()
        if lname.endswith("bias") or lname.endswith("beta"):
            arr.fill_(0.0)
        elif lname.endswith("gamma"):
            arr.fill_(1.0)
        elif lname.endswith("running_mean") or lname.endswith("moving_mean"):
            arr.fill_(0.0)
        elif lname.endswith("running_var") or lname.endswith("moving_var"):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%r)" % (type(self).__name__, self._kwargs)


def _fill_random(arr, draw, generator):
    """Draw on the CPU with ``draw(cpu_tensor, generator)`` and copy."""
    host = torch.empty(arr.shape, dtype=torch.float32)
    draw(host, generator)
    arr.copy_(host)


@register
class Zero(Initializer):
    def _init_weight(self, _name, arr, _generator):
        arr.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, _name, arr, _generator):
        arr.fill_(1.0)


@register
class Uniform(Initializer):
    """U(-scale, scale); the default initializer."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _name, arr, generator):
        _fill_random(arr, lambda t, g: t.uniform_(-self.scale, self.scale,
                                                  generator=g), generator)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _name, arr, generator):
        _fill_random(arr, lambda t, g: t.normal_(0.0, self.sigma,
                                                 generator=g), generator)


@register
class Xavier(Initializer):
    """Glorot: scale ``sqrt(magnitude / factor)``, the factor from the
    fan-in and fan-out of a ``(out, in, *kernel)`` shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier requires >=2D weight, got %s"
                             % (tuple(shape),))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("bad factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _fill_random(arr, lambda t, g: t.uniform_(-scale, scale,
                                                      generator=g),
                         generator)
        else:
            _fill_random(arr, lambda t, g: t.normal_(0.0, scale,
                                                     generator=g),
                         generator)
