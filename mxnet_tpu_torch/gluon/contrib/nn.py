"""Contrib layers (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``):
parallel branches concatenated, the identity, and the embedding with a
row-sparse gradient intent."""
from __future__ import annotations

from ..block import Block, HybridBlock
from .. import nn as _nn

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding"]


class Concurrent(Block):
    """Branches run on one input, their outputs concatenated on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._children)), b)

    def forward(self, x):
        import torch
        outs = [b(x) for b in self._children.values()]
        return torch.cat(outs, dim=self.axis)


class HybridConcurrent(HybridBlock):
    """:class:`Concurrent` as a hybrid block."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._children)), b)

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self._children.values()]
        return F.Concat(*outs, dim=self.axis)


class Identity(HybridBlock):
    """The input as it is (a residual branch's placeholder)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(_nn.Embedding):
    """``Embedding(sparse_grad=True)``: the gradient stays dense in the
    step, and the row-sparse win is the kvstore's and the optimizer's
    (``row_sparse_pull``, ``Optimizer.update_row_sparse``)."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         sparse_grad=True, **kwargs)
