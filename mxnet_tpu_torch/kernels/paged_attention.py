"""Registry entry and call surface of decode-step paged attention
(counterpart of ``mxnet_tpu/kernels/paged_attention.py``).

:func:`paged_attention` is what the decode model calls: a CUDA ``q``
launches the Hopper kernel, a CPU ``q`` runs the plain version.
"""
from __future__ import annotations

from ..ops.paged_attention import (paged_attention_cuda,
                                   paged_attention_reference)
from .costs import paged_attention_cost
from .registry import KernelSpec, dispatch, register_kernel

__all__ = ["paged_attention"]

register_kernel(KernelSpec(
    name="paged_attention",
    plain=paged_attention_reference,
    launch=paged_attention_cuda,
    source="csrc/paged_attention.cu",
    replaces="mxnet_tpu/ops/pallas/paged_attention.py:112 "
             "paged_attention_pallas",
    cost=paged_attention_cost,
    category="conv_dot",
))


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    scale=1.0):
    """``q`` (slots, heads, d); per-layer cache slabs (num_blocks,
    block_size, heads, d); ``block_tables`` (slots, max_blocks) int32;
    ``context_lens`` (slots, 1) int32 -> (slots, heads, d)."""
    return dispatch("paged_attention", q, k_cache, v_cache, block_tables,
                    context_lens, scale=scale)
