"""Attention operators (counterpart of ``mxnet_tpu/ops/transformer.py``):
the four interleaved-projection matmuls and flash attention.

The interleaved ops keep the reference's layout, one projection tensor
``(seq, batch, heads * k * head_dim)`` with each head's q/k/v (or k/v)
contiguous; ``*_qk`` scales the scores by ``1 / sqrt(head_dim)`` and
gives ``(batch * heads, qlen, kvlen)``, ``*_valatt`` gives ``(seq, batch,
heads * head_dim)``.  They are batched matmuls on views, differentiated
by torch autograd.

``flash_attention(q, k, v, causal, scale)`` and
``flash_attention_masked(q, k, v, mask, heads, scale)`` over ``(batch *
heads, seq, head_dim)`` tensors, the mask ``(batch, seq, seq)`` with
nonzero = attend.  Both run :class:`FlashAttention`, the port of the JAX
package's ``_flash`` / ``_flash_masked`` custom VJPs: the forward kernel
saves ``(q, k, v, out, lse)``; the backward computes ``delta =
rowsum(dout * out)`` in fp32 and runs the backward kernels, which replay
the scores from ``lse``.  A CUDA tensor launches the kernels of
:mod:`mxnet_tpu_torch.kernels.flash_attention`, a CPU tensor runs their
plain versions.  There is no auto gate and no ``use_pallas`` switch:
:func:`attention_reference` is the plain attention math a layer runs
when its caller asks for it (``use_flash=False``), the JAX package's
``_attention_reference(_masked)``, differentiated by autograd.
"""
from __future__ import annotations

import math

import torch

from ..kernels.registry import dispatch
from .table import register

__all__ = ["FlashAttention", "attention_reference", "flash_attention",
           "flash_attention_masked", "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt"]


def _heads_major(x, heads, parts):
    """``(seq, batch, heads * parts * hd)`` -> ``parts`` tensors of
    ``(batch * heads, seq, hd)``."""
    seq, batch, emb = x.shape
    hd = emb // (parts * heads)
    x = x.reshape(seq, batch, heads, parts, hd)
    return [x[:, :, :, i].permute(1, 2, 0, 3).reshape(batch * heads, seq, hd)
            for i in range(parts)], hd


def _seq_major(out, batch, heads):
    """``(batch * heads, seq, hd)`` -> ``(seq, batch, heads * hd)``."""
    _, seq, hd = out.shape
    return out.reshape(batch, heads, seq, hd).permute(2, 0, 1, 3) \
        .reshape(seq, batch, heads * hd)


@register("interleaved_matmul_selfatt_qk", args=("queries_keys_values",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """Scaled scores ``Q K^T / sqrt(hd)`` from an interleaved qkv
    projection."""
    (q, k, _), hd = _heads_major(queries_keys_values, heads, 3)
    return torch.bmm(q, k.transpose(1, 2)) * (1.0 / math.sqrt(hd))


@register("interleaved_matmul_selfatt_valatt",
          args=("queries_keys_values", "attention"))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """``attention . V`` back in the sequence-major layout."""
    (_, _, v), _ = _heads_major(queries_keys_values, heads, 3)
    return _seq_major(torch.bmm(attention, v),
                      queries_keys_values.shape[1], heads)


@register("interleaved_matmul_encdec_qk", args=("queries", "keys_values"))
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """Cross-attention scores from ``(qlen, batch, embed)`` queries and an
    interleaved ``(kvlen, batch, 2 * embed)`` key/value projection."""
    (q,), hd = _heads_major(queries, heads, 1)
    (k, _), _ = _heads_major(keys_values, heads, 2)
    return torch.bmm(q, k.transpose(1, 2)) * (1.0 / math.sqrt(hd))


@register("interleaved_matmul_encdec_valatt",
          args=("keys_values", "attention"))
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """``attention . V`` of the cross attention, ``(qlen, batch, embed)``."""
    (_, v), _ = _heads_major(keys_values, heads, 2)
    return _seq_major(torch.bmm(attention, v), keys_values.shape[1], heads)


class FlashAttention(torch.autograd.Function):
    """``softmax(q k^T * scale [masked]) v`` with the blockwise backward.
    ``mask`` is a float ``(b, seq, seq)`` tensor or ``None``; it takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, heads):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = dispatch("flash_attention_fwd", q, k, v, mask=mask,
                            causal=causal, scale=scale, heads=heads)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal, ctx.scale, ctx.heads = causal, scale, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq, dk, dv = dispatch("flash_attention_bwd", q, k, v, lse, dout,
                              delta, mask=mask, causal=ctx.causal,
                              scale=ctx.scale, heads=ctx.heads)
        return dq, dk, dv, None, None, None, None


def _scale(q, scale):
    if scale is None or scale < 0:
        return 1.0 / math.sqrt(q.shape[-1])
    return float(scale)


def flash_attention(q, k, v, causal=False, scale=-1.0, use_pallas=None,
                    block_q=256, block_k=256):
    """Fused scaled-dot-product attention; ``scale < 0`` means
    ``1 / sqrt(head_dim)``.  ``use_pallas``, ``block_q`` and ``block_k``
    are the JAX op's and unused: the port has no switch, and the kernel
    picks its own tiles."""
    return FlashAttention.apply(q, k, v, None, bool(causal), _scale(q, scale),
                                1)


def flash_attention_masked(q, k, v, mask, scale=-1.0, use_pallas=None,
                           heads=1, block_q=256, block_k=256):
    """Masked flash attention: ``mask`` ``(batch, seq_q, seq_k)``,
    nonzero = attend, shared across the ``heads`` heads folded into
    q/k/v's leading dim (the JAX op's arguments, in its order)."""
    maskf = mask.detach().to(device=q.device, dtype=torch.float32) \
        .contiguous()
    return FlashAttention.apply(q, k, v, maskf, False, _scale(q, scale),
                                int(heads))


def attention_reference(q, k, v, mask=None, causal=False, scale=-1.0,
                        heads=1):
    """Plain attention over ``(batch * heads, seq, head_dim)`` tensors:
    the products of the inputs' values accumulated in fp32, masked
    scores (``mask`` ``(batch, seq_q, seq_k)``, nonzero = attend, shared
    by ``heads``; ``causal``) at -1e30, softmax in fp32, the
    probabilities rounded to ``v``'s dtype before ``P v``, the result
    at ``q``'s dtype."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(q,
                                                                  scale)
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, -1e30)
    if mask is not None:
        keep = mask.detach().to(s.device).repeat_interleave(heads,
                                                            dim=0) > 0
        s = torch.where(keep, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)
