"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

An :class:`Initializer` fills a tensor in place, by the parameter's
name first: names ending in ``bias`` or ``beta`` get 0, ``gamma`` 1,
``running_mean``/``moving_mean`` 0 and ``running_var``/``moving_var``
1; any other name is a weight and gets the initializer's own rule.
An :class:`InitDesc` name whose ``attrs`` hold ``"__init__"`` (a
registered name, or an initializer's :meth:`~Initializer.dumps`) is
filled by that initializer's weight rule instead.  :class:`Mixed`
routes a name to the first initializer whose pattern matches it.
Random rules draw from an explicit :class:`torch.Generator` (the
process-wide default generator when none is given), on the CPU, and
copy into the target, so a seed gives the same numbers on every device.
The numbers differ from the JAX package's, which draws from numpy;
tests carry weights across instead (``gluon.convert``) and hold random
rules to their distribution.
"""
from __future__ import annotations

import json
import math
import re

import torch

from .base import MXNetError

__all__ = ["Bilinear", "Constant", "InitDesc", "Initializer", "LSTMBias",
           "MSRAPrelu", "Mixed", "Normal", "One", "Orthogonal", "Uniform",
           "Xavier", "Zero", "create", "register"]

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


class InitDesc(str):
    """A parameter's name with attributes for its initializer
    (reference: ``initializer.py :: InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer; ``init(name, tensor, generator)`` fills
    ``tensor`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        chosen = getattr(name, "attrs", {}).get("__init__", "")
        if chosen:
            create(json.loads(chosen)[0] if chosen.startswith("[")
                   else chosen)._init_weight(name, arr, generator)
            return
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

    def dumps(self):
        """``[name, kwargs]`` as JSON, the form ``InitDesc`` attributes
        carry."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

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
class Constant(Initializer):
    """Every weight ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _name, arr, _generator):
        arr.fill_(self.value)


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


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: Gaussian, magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        Initializer.__init__(self, factor_type=factor_type, slope=slope)
        self.rnd_type = "gaussian"
        self.factor_type = factor_type
        self.magnitude = 2.0 / (1 + slope ** 2)


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis of a random ``(out, in)``
    matrix (uniform in [-1, 1] or standard normal), by SVD."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty(nout, nin, dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, _name, arr, _generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        x = i % shape[3]
        y = torch.div(i, shape[3], rounding_mode="floor") % shape[2]
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        arr.copy_(w.to(torch.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter (gate order i, f, g, o), which
    gets ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _name, arr, _generator):
        n = arr.shape[0] // 4
        arr.fill_(0.0)
        arr[n:2 * n] = self.forget_bias


class Mixed(Initializer):
    """The first of ``initializers`` whose regular expression in
    ``patterns`` matches the parameter's name fills it."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        for regex, init in self.map:
            if regex.match(name):
                init(name, arr, generator)
                return
        raise MXNetError("no initializer pattern matches %r" % (name,))
