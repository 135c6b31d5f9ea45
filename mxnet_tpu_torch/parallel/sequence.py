"""Sequence/context parallelism: ring attention over a mesh axis
(counterpart of ``mxnet_tpu/parallel/sequence.py``).

Ring attention shards the sequence over a mesh axis, each rank holding
``seq / n`` of Q/K/V.  K/V blocks rotate around the ring
(:func:`~.collectives.ppermute`, one hop a block) while each rank folds
every block into a running online-softmax ``(max, sum, acc)`` carry, so
attention memory stays O(seq/n * d) a rank.  As in the JAX package the
blocks are plain fp32 matmuls (the JAX ring reaches no Pallas kernel)
and the ring turns ``n`` times.  Composes with data parallelism: mesh
``{'dp': a, 'sp': b}``, the batch*heads dimension split over ``dp``,
the sequence over ``sp``.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import collectives as _coll
from .mesh import NamedSharding, PartitionSpec as P, annotate

__all__ = ["ring_attention", "ring_attention_sharded"]

_NEG_INF = -1e30


def _ring_attention_local(q, k, v, mesh, axis_name, causal, scale):
    """This rank's output block: q/k/v are its ``(bh, seq_local, d)``."""
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    bh, sl, d = q.shape
    qf = q.float()
    rows = idx * sl + torch.arange(sl, device=q.device)
    cols_local = torch.arange(sl, device=q.device)
    m = torch.full((bh, sl, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((bh, sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sl, d), dtype=torch.float32, device=q.device)
    kb, vb, src = k, v, idx
    for _ in range(n):
        s = torch.bmm(qf, kb.float().transpose(1, 2)) * scale
        if causal:
            cols = src * sl + cols_local
            s = torch.where((rows[:, None] >= cols[None, :])[None], s,
                            _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(p, vb.float())
        m = m_new
        # rotate KV one hop around the ring
        kb = _coll.ppermute(kb, mesh, axis_name, 1)
        vb = _coll.ppermute(vb, mesh, axis_name, 1)
        src = (src - 1) % n
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None):
    """Sequence-parallel attention: q/k/v are this rank's ``(bh,
    seq_local, d)`` blocks of arrays whose ``seq`` is split over
    ``mesh[axis_name]`` in rank order; returns this rank's output block,
    annotated with the global shape."""
    if axis_name not in mesh.shape:
        raise MXNetError("mesh has no axis %r" % axis_name)
    n = mesh.axis_size(axis_name)
    bh, sl, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = _ring_attention_local(q, k, v, mesh, axis_name, causal, scale)
    sh = NamedSharding(mesh, P(None, axis_name, None))
    return annotate(out, sh, (bh, sl * n, d))


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           scale=None):
    """Convenience wrapper taking the full ``(bh, seq, d)`` arrays
    (NDArrays or tensors, the same on every rank): each rank takes its
    sequence block onto the mesh's device and returns its output block
    as an NDArray."""
    from ..ndarray import NDArray
    n = mesh.axis_size(axis_name) if axis_name in mesh.shape else None
    if n is None:
        raise MXNetError("mesh has no axis %r" % axis_name)
    seq = q.shape[1]
    if seq % n:
        raise MXNetError("seq %d not divisible by %s=%d"
                         % (seq, axis_name, n))
    sh = NamedSharding(mesh, P(None, axis_name, None))

    def local(t):
        t = t._data if isinstance(t, NDArray) else torch.as_tensor(t)
        return t[sh.local_slices(t.shape)].to(mesh.device)
    return NDArray(ring_attention(local(q), local(k), local(v), mesh,
                                  axis_name=axis_name, causal=causal,
                                  scale=scale))
