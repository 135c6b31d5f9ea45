"""Activation layer (counterpart of
``mxnet_tpu/gluon/nn/activations.py :: Activation``)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)

    def __repr__(self):
        return "Activation(%s)" % self._act
