"""Transformer layers (counterpart of
``mxnet_tpu/gluon/nn/transformer.py``): ``MultiHeadAttention``,
``PositionwiseFFN``, ``TransformerEncoderCell`` and
``TransformerEncoder``.

Layout is batch-major ``(batch, seq, units)``; heads fold into the batch
dimension, so attention runs over ``(batch * heads, seq, head_dim)``
through the flash kernels (:mod:`mxnet_tpu_torch.ops.transformer`).  As
in the JAX package, attention without a mask, or with a mask outside
training or without dropout, takes the flash path, which applies no
dropout to the attention probabilities; a mask together with dropout in
training materializes the scores in plain PyTorch.  ``use_flash``
(``MultiHeadAttention``, the encoder and its cells): ``None``, the
default, and ``True`` run the flash kernels; ``False`` runs the plain
attention math (``F.attention_reference``) where the JAX package runs
XLA's.

The tensor-parallel mode (``tp_mode=True``) gives the attention separate
q/k/v projections, whose output dims column-split cleanly; ``shard_tp(
mesh, axis)`` places them Megatron-style: q/k/v column-parallel, the
output projection row-parallel, the FFN column then row, LayerNorms and
the positional table replicated
(:mod:`mxnet_tpu_torch.parallel.tensor_parallel`).  A rank then runs the
attention of its ``heads / tp`` heads through the same flash kernels,
and each of the attention and the FFN sums its row-parallel output over
``tp`` once: two all-reduces a layer forward, two backward (the column
layers' input gradients).
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder"]


def _tp_place(param, mesh, spec):
    from ...parallel.tensor_parallel import place_param
    place_param(param, mesh, spec)


def _P(*parts):
    from ...parallel.mesh import PartitionSpec
    return PartitionSpec(*parts)


class MultiHeadAttention(HybridBlock):
    """Self multi-head attention with one fused ``(3 * units, in)``
    q/k/v projection and an output projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 use_flash=None, causal=False, tp_mode=False,
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError("units %d not divisible by heads %d"
                             % (units, num_heads))
        self._units = units
        self._heads = num_heads
        self._dropout = dropout
        self._use_flash = use_flash
        self._causal = causal
        self._tp_mode = tp_mode
        with self.name_scope():
            if tp_mode:
                # separate q/k/v projections: each weight's output dim
                # (heads * head_dim) column-splits cleanly over tp
                for nm in ("query", "key", "value"):
                    setattr(self, nm + "_weight", self.params.get(
                        nm + "_weight", shape=(units, 0), dtype=dtype,
                        allow_deferred_init=True))
                    setattr(self, nm + "_bias", self.params.get(
                        nm + "_bias", shape=(units,), dtype=dtype,
                        init="zeros") if use_bias else None)
                self.qkv_weight = self.qkv_bias = None
            else:
                self.qkv_weight = self.params.get(
                    "qkv_weight", shape=(3 * units, 0), dtype=dtype,
                    allow_deferred_init=True)
                self.qkv_bias = self.params.get(
                    "qkv_bias", shape=(3 * units,), dtype=dtype,
                    init="zeros") if use_bias else None
            self.out_weight = self.params.get(
                "out_weight", shape=(units, units), dtype=dtype)
            self.out_bias = self.params.get(
                "out_bias", shape=(units,), dtype=dtype,
                init="zeros") if use_bias else None

    def infer_shape(self, x, *args):
        if self._tp_mode:
            for nm in ("query", "key", "value"):
                getattr(self, nm + "_weight").shape = \
                    (self._units, x.shape[-1])
        else:
            self.qkv_weight.shape = (3 * self._units, x.shape[-1])

    def shard_tp(self, mesh, axis="tp"):
        """Megatron sharding: q/k/v column-parallel (output dims over
        ``axis``), out row-parallel (input dim over ``axis``)."""
        if not self._tp_mode:
            raise ValueError("build the attention with tp_mode=True "
                             "before sharding")
        if self._heads % mesh.axis_size(axis):
            raise MXNetError("%d heads do not split over %s=%d"
                             % (self._heads, axis, mesh.axis_size(axis)))
        for nm in ("query", "key", "value"):
            _tp_place(getattr(self, nm + "_weight"), mesh, _P(axis, None))
            bias = getattr(self, nm + "_bias")
            if bias is not None:
                _tp_place(bias, mesh, _P(axis))
        _tp_place(self.out_weight, mesh, _P(None, axis))
        if self.out_bias is not None:
            _tp_place(self.out_bias, mesh, _P())
        return self

    def _tp_axis(self):
        """``(mesh, axis)`` the q/k/v projections are split over, or
        None."""
        sh = self.query_weight._sharding if self._tp_mode else None
        if sh is None or sh.is_replicated:
            return None
        return sh.mesh, sh.spec[0]

    def hybrid_forward(self, F, x, mask=None, qkv_weight=None,
                       qkv_bias=None, out_weight=None, out_bias=None,
                       query_weight=None, query_bias=None, key_weight=None,
                       key_bias=None, value_weight=None, value_bias=None):
        b, seq, _ = x.shape
        u, h = self._units, self._heads
        hd = u // h
        tp = self._tp_axis()
        if tp is not None:
            # this rank's heads: h / tp of them, u / tp units
            from ...parallel import collectives
            n = tp[0].axis_size(tp[1])
            h, u = h // n, u // n
            x = collectives.pvary(x, *tp)

        def heads_of(t):   # (b, seq, u) -> (b * h, seq, hd)
            return t.reshape(b, seq, h, hd).permute(0, 2, 1, 3) \
                .reshape(b * h, seq, hd)

        if self._tp_mode:
            # this rank's q/k/v rows as one projection: one GEMM, the
            # plain layer's own at one rank
            qkv_weight = F.concat(query_weight, key_weight, value_weight,
                                  dim=0)
            qkv_bias = None if query_bias is None else F.concat(
                query_bias, key_bias, value_bias, dim=0)
        qkv = F.FullyConnected(x, qkv_weight, qkv_bias, num_hidden=3 * u,
                               no_bias=qkv_bias is None, flatten=False)
        q = heads_of(F.slice_axis(qkv, axis=2, begin=0, end=u))
        k = heads_of(F.slice_axis(qkv, axis=2, begin=u, end=2 * u))
        v = heads_of(F.slice_axis(qkv, axis=2, begin=2 * u, end=3 * u))
        if self._use_flash is False and (
                mask is None or not self._dropout
                or not autograd.is_training()):
            ctx_out = F.attention_reference(
                q, k, v, None if mask is None else mask.reshape(b, seq, seq),
                causal=self._causal, heads=h)
        elif mask is None:
            ctx_out = F.flash_attention(q, k, v, causal=self._causal)
        elif not self._dropout or not autograd.is_training():
            ctx_out = F.flash_attention_masked(
                q, k, v, mask.reshape(b, seq, seq), heads=h)
        else:
            scores = torch.bmm(q, k.transpose(1, 2)) * (1.0 / hd ** 0.5)
            m = mask.reshape(b, 1, seq, seq).expand(b, h, seq, seq) \
                .reshape(b * h, seq, seq)
            scores = torch.where(m != 0, scores, -1e30)
            att = F.Dropout(torch.softmax(scores, dim=-1), p=self._dropout,
                            training=True)
            ctx_out = torch.bmm(att, v)
        out = ctx_out.reshape(b, h, seq, hd).permute(0, 2, 1, 3) \
            .reshape(b, seq, u)
        if tp is not None:
            # row-parallel output projection: partial products summed
            # over tp, then the (replicated) bias
            out = collectives.psum(F.FullyConnected(
                out, out_weight, None, num_hidden=self._units, no_bias=True,
                flatten=False), *tp)
            return out if out_bias is None else out + out_bias
        return F.FullyConnected(out, out_weight, out_bias,
                                num_hidden=self._units,
                                no_bias=out_bias is None, flatten=False)


class PositionwiseFFN(HybridBlock):
    """Feed-forward block (BERT intermediate + output)."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = Dense(hidden_size, activation=activation,
                               flatten=False, in_units=units, dtype=dtype)
            self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                               dtype=dtype)
            self.drop = Dropout(dropout)

    def shard_tp(self, mesh, axis="tp"):
        _tp_place(self.ffn_1.weight, mesh, _P(axis, None))
        if self.ffn_1.bias is not None:
            _tp_place(self.ffn_1.bias, mesh, _P(axis))
        _tp_place(self.ffn_2.weight, mesh, _P(None, axis))
        if self.ffn_2.bias is not None:
            _tp_place(self.ffn_2.bias, mesh, _P())
        return self

    def hybrid_forward(self, F, x):
        return self.drop(self.ffn_2(self.ffn_1(x)))


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder cell (BERT style): ``LN(x + MHA(x))``, then
    ``LN(. + FFN(.))``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 use_flash=None, tp_mode=False, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                use_flash=use_flash,
                                                tp_mode=tp_mode,
                                                dtype=dtype)
            self.attn_drop = Dropout(dropout)
            self.ln_1 = LayerNorm(in_channels=units)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       dtype=dtype)
            self.ln_2 = LayerNorm(in_channels=units)

    def shard_tp(self, mesh, axis="tp"):
        self.attention.shard_tp(mesh, axis)
        self.ffn.shard_tp(mesh, axis)
        for p in (self.ln_1, self.ln_2):
            for prm in p.collect_params().values():
                _tp_place(prm, mesh, _P())
        return self

    def hybrid_forward(self, F, x, mask=None):
        att = self.attn_drop(self.attention(x, mask))
        x = self.ln_1(x + att)
        return self.ln_2(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """Stack of encoder cells with a learned positional embedding."""

    def __init__(self, units, hidden_size, num_layers, num_heads,
                 max_length=512, dropout=0.0, use_flash=None,
                 tp_mode=False, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), dtype=dtype)
            self.drop = Dropout(dropout)
            self.ln = LayerNorm(in_channels=units)
            self.cells = []
            for i in range(num_layers):
                cell = TransformerEncoderCell(units, hidden_size, num_heads,
                                              dropout=dropout,
                                              use_flash=use_flash,
                                              tp_mode=tp_mode,
                                              dtype=dtype)
                setattr(self, "cell%d" % i, cell)
                self.cells.append(cell)

    def shard_tp(self, mesh, axis="tp"):
        for cell in self.cells:
            cell.shard_tp(mesh, axis)
        _tp_place(self.position_weight, mesh, _P())
        for prm in self.ln.collect_params().values():
            _tp_place(prm, mesh, _P())
        return self

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        seq = x.shape[1]
        x = x + F.slice_axis(position_weight, axis=0, begin=0,
                             end=seq).unsqueeze(0)
        x = self.drop(self.ln(x))
        # each cell carries distinct weights and a CUDA graph has no
        # loop: the capture records every layer, once per key
        for cell in self.cells:  # mxlint: disable=python-loop-unroll
            x = cell(x, mask)
        return x
