"""Activation layers (counterpart of
``mxnet_tpu/gluon/nn/activations.py``): ``Activation``, ``LeakyReLU``,
``PReLU`` (a learned slope per channel), ``ELU``, ``SELU``, ``GELU``
(exact, as the JAX package's) and ``Swish``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "ELU", "GELU", "LeakyReLU", "PReLU", "SELU",
           "Swish"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)

    def __repr__(self):
        return "Activation(%s)" % self._act


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere; ``alpha`` is a
    parameter of ``in_channels`` entries (broadcast over axis 1)."""

    def __init__(self, alpha_initializer="zeros", in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F._prelu(x, alpha)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
