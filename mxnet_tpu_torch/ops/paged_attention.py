"""Decode-step paged attention: one query token per slot attends over
the K/V that its block table names in the paged cache (counterpart of
``mxnet_tpu/ops/pallas/paged_attention.py``).

- :func:`paged_attention_reference` -- the plain PyTorch version:
  gather the table's blocks, masked softmax.  It runs the CPU path and
  is the oracle the CUDA kernel is held against on the card.
- :func:`paged_attention_cuda` -- the wrapper of the hand-written
  Hopper kernel ``csrc/paged_attention.cu`` (built on first use by
  :mod:`mxnet_tpu_torch._build`).  The kernel cuts each slot's context
  into partitions of :func:`partition_blocks` table blocks and merges
  their partial softmax results; the wrapper hands it the fp32 scratch
  for the partials and the per-(slot, head) merge tickets, both kept
  per stream and reused from call to call.

Layout: q ``(slots, heads, head_dim)``; per-layer cache slabs
``(num_blocks, block_size, heads, head_dim)``; ``block_tables``
``(slots, max_blocks)`` int32; ``context_lens`` ``(slots, 1)`` int32
(tokens 0..ctx-1 are live).  fp32 accumulation whatever the cache
dtype; the output has the dtype of ``q``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from ..kernels.registry import count_launch

__all__ = ["NEG_INF", "PARTITION_TOKENS", "paged_attention_reference",
           "paged_attention_cuda", "partition_blocks"]

NEG_INF = -1e30
PARTITION_TOKENS = 64      # about the tokens one kernel block takes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_reference(q, k_cache, v_cache, block_tables,
                              context_lens, scale=1.0):
    """Gather-then-softmax: take the table's blocks into a contiguous
    ``(slots, max_blocks*block_size, heads, d)`` view and mask positions
    past each slot's context length."""
    s_, h, d = q.shape
    _nb, bs, _, _ = k_cache.shape
    mb = block_tables.shape[1]
    idx = block_tables.long()
    k = k_cache[idx].reshape(s_, mb * bs, h, d).float()
    v = v_cache[idx].reshape(s_, mb * bs, h, d).float()
    scores = torch.einsum("shd,sthd->sht", q.float(), k) * scale
    pos = torch.arange(mb * bs, device=q.device)
    live = pos[None, None, :] < context_lens.reshape(s_, 1, 1)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    # dead positions weigh exactly 0, so ctx 0 gives zeros as the TPU
    # kernel does (the JAX reference averages V there instead)
    p = torch.where(live, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("sht,sthd->shd", p / l, v)
    return out.to(q.dtype)


def partition_blocks(block_size):
    """Table blocks in one of the kernel's context partitions: about
    ``PARTITION_TOKENS`` tokens, and at least one block."""
    return max(1, PARTITION_TOKENS // int(block_size))


def _check(q, k_cache, v_cache, block_tables, context_lens):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError("paged_attention_cuda needs CUDA tensors, got q "
                         "on %s" % dev)
    named = (("k_cache", k_cache), ("v_cache", v_cache),
             ("block_tables", block_tables),
             ("context_lens", context_lens))
    for name, t in named:
        if t.device != dev:
            raise MXNetError("paged_attention_cuda: %s on %s, q on %s"
                             % (name, t.device, dev))
    for name, t in (("q", q),) + named:
        if not t.is_contiguous():
            raise MXNetError("paged_attention_cuda: %s is not contiguous"
                             % name)
    if q.dtype not in _DTYPE_CODES or k_cache.dtype not in _DTYPE_CODES:
        raise MXNetError("paged_attention_cuda: q and caches must be "
                         "float32 or bfloat16, got %s / %s"
                         % (q.dtype, k_cache.dtype))
    if v_cache.dtype != k_cache.dtype:
        raise MXNetError("paged_attention_cuda: k/v caches differ in "
                         "dtype (%s / %s)" % (k_cache.dtype, v_cache.dtype))
    if block_tables.dtype != torch.int32 \
            or context_lens.dtype != torch.int32:
        raise MXNetError("paged_attention_cuda: block_tables and "
                         "context_lens must be int32")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise MXNetError("paged_attention_cuda: q must be (slots, heads, "
                         "d) and caches (blocks, block_size, heads, d)")
    slots, heads, d = q.shape
    if k_cache.shape != v_cache.shape or tuple(k_cache.shape[2:]) \
            != (heads, d):
        raise MXNetError("paged_attention_cuda: cache shapes %s / %s do "
                         "not match q %s" % (tuple(k_cache.shape),
                                             tuple(v_cache.shape),
                                             tuple(q.shape)))
    if block_tables.dim() != 2 or block_tables.shape[0] != slots \
            or context_lens.numel() != slots:
        raise MXNetError("paged_attention_cuda: block_tables %s / "
                         "context_lens %s do not match %d slots"
                         % (tuple(block_tables.shape),
                            tuple(context_lens.shape), slots))
    if heads < 1 or d < 1 or k_cache.shape[1] < 1 \
            or block_tables.shape[1] < 1:
        raise MXNetError("paged_attention_cuda: heads, head_dim, "
                         "block_size and max_blocks must be positive")
    if slots > 65535 or heads > 65535:
        raise MXNetError("paged_attention_cuda: slots %d or heads %d > "
                         "65535" % (slots, heads))


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("paged_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, i, ctypes.c_float, i, i, p]
    lib.paged_attention_launch.restype = i
    lib.paged_attention_error_string.argtypes = [i]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


_scratch = {}


def _scratch_for(device, stream, n_tickets, n_partials):
    """The merge tickets (int32) and partials (fp32) of ``stream``, at
    least ``n_tickets`` and ``n_partials`` long.  A stream's calls run
    in order, so they share one pair, made once and grown to the largest
    call: the kernel leaves the tickets at zero, and a call reads only
    the partials it wrote."""
    key = (device.index, stream)
    pair = _scratch.get(key)
    if pair is None or pair[0].numel() < n_tickets \
            or pair[1].numel() < n_partials:
        if pair is not None:
            n_tickets = max(n_tickets, pair[0].numel())
            n_partials = max(n_partials, pair[1].numel())
        pair = _scratch[key] = (
            torch.zeros(n_tickets, dtype=torch.int32, device=device),
            torch.empty(n_partials, dtype=torch.float32, device=device))
    return pair


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens,
                         scale=1.0):
    """Launch the Hopper kernel on PyTorch's current stream; returns
    ``(slots, heads, head_dim)`` in ``q``'s dtype.  Raises on tensors it
    does not take and on a refused launch."""
    _check(q, k_cache, v_cache, block_tables, context_lens)
    lib = _lib()
    slots, heads, d = q.shape
    block_size, max_blocks = k_cache.shape[1], block_tables.shape[1]
    part = partition_blocks(block_size)
    max_parts = -(-max_blocks // part)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tickets, partials = _scratch_for(
            q.device, stream, slots * heads,
            slots * max_parts * heads * (d + 2))
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            out.data_ptr(), partials.data_ptr(), tickets.data_ptr(), slots,
            heads, d, block_size, max_blocks, part, float(scale),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], stream)
    if rc != 0:
        raise MXNetError("paged_attention kernel launch failed: %s (%d)"
                         % (lib.paged_attention_error_string(rc).decode(),
                            rc))
    count_launch("paged_attention")
    return out
