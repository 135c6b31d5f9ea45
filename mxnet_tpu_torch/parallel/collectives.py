"""Collectives over a named mesh axis (counterpart of the ``jax.lax``
collectives the JAX package's ``shard_map`` bodies call, and of the ones
XLA's partitioner inserts).

Each is a ``torch.distributed`` call on the process subgroup of this
rank's slice along the axis (:meth:`Mesh.group`): NCCL for CUDA tensors,
gloo for CPU ones.  An axis of size 1 still issues its call.  Each is
differentiable, its backward the transpose of its forward:

- :func:`psum` -- all-reduce (sum); backward the identity: the value is
  replicated after it, so every rank's cotangent is already the whole
  one (``grad="psum"`` all-reduces the cotangent too, for a value each
  rank's own part of a summed loss reads);
- :func:`pvary` -- the identity; backward a psum: a replicated value
  read by rank-local work (a column-parallel layer's input);
- :func:`all_gather` -- gather along a dimension; backward a
  reduce-scatter (``grad="slice"``: this rank's slice, when the gathered
  value feeds a replicated loss);
- :func:`reduce_scatter` -- backward an all-gather;
- :func:`all_to_all` -- split one dimension over the ranks and
  concatenate along another; backward the inverse exchange;
- :func:`ppermute` -- send to the rank ``shift`` places on around the
  axis's ring and receive from the one ``shift`` back
  (``batch_isend_irecv``; a ring of one is an ``all_to_all_single``
  with itself); backward the reverse rotation.

Every call is counted by name, with its bytes (:func:`counts`); a call
recorded into a CUDA graph counts at each replay of the graph, as a hand
kernel's launch does (:mod:`..kernels.registry`).
"""
from __future__ import annotations

import threading
from collections import Counter

import torch
import torch.distributed as dist

from ..kernels import registry as _registry

__all__ = ["psum", "pvary", "all_gather", "reduce_scatter", "all_to_all",
           "ppermute", "broadcast_", "all_reduce_", "counts",
           "reset_counts", "BatchSync"]

_lock = threading.Lock()
_calls = Counter()
_bytes = Counter()
_TALLY = "collective"


def _add(detail, n):
    name, nbytes = detail
    with _lock:
        _calls[name] += n
        _bytes[name] += n * nbytes


_registry.register_counter(_TALLY, _add)


def _count(name, t):
    detail = (name, t.numel() * t.element_size())
    if not _registry.count_captured(_TALLY, detail):
        _add(detail, 1)


def counts():
    """``{name: {"calls": n, "bytes": b}}`` since the last reset."""
    with _lock:
        return {k: {"calls": _calls[k], "bytes": _bytes[k]}
                for k in sorted(_calls)}


def reset_counts():
    with _lock:
        _calls.clear()
        _bytes.clear()


# -- in-place primitives (no autograd) -----------------------------------

def all_reduce_(t, mesh, axis, op="sum"):
    """Sum (``op="max"``/``"min"``: the extremum) ``t`` in place over
    the axis; returns ``t``."""
    pg, _ranks = mesh.group(axis)
    _count("all_reduce", t)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(t, op=red, group=pg)
    return t


def broadcast_(t, mesh, axis, root=0):
    """Overwrite ``t`` in place with the value of the axis's rank
    ``root`` (an index within the slice); returns ``t``."""
    pg, ranks = mesh.group(axis)
    _count("broadcast", t)
    dist.broadcast(t, src=ranks[root], group=pg)
    return t


def _gather(x, mesh, axis, dim):
    pg, ranks = mesh.group(axis)
    n = len(ranks)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", xm)
    dist.all_gather_into_tensor(out, xm, group=pg)
    return out.movedim(0, dim)


def _scatter(x, mesh, axis, dim):
    pg, ranks = mesh.group(axis)
    n = len(ranks)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter", xm)
    dist.reduce_scatter_tensor(out, xm, group=pg)
    return out.movedim(0, dim)


def _slice_of(x, mesh, axis, dim):
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


def _exchange(x, mesh, axis, split_dim, concat_dim):
    pg, ranks = mesh.group(axis)
    n = len(ranks)
    # (n, ...) chunks of split_dim, rank-major, contiguous for the call
    xs = x.movedim(split_dim, 0)
    chunks = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    _count("all_to_all", chunks)
    dist.all_to_all_single(out, chunks, group=pg)
    # out[j] is rank j's chunk for us: concatenate along concat_dim
    parts = out.movedim(1, split_dim + 1) if split_dim else out
    parts = [p for p in parts.unbind(0)]
    return torch.cat(parts, dim=concat_dim)


def _rotate(x, mesh, axis, shift):
    pg, ranks = mesh.group(axis)
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("ppermute", x)
    if n == 1:
        dist.all_to_all_single(out, x, group=pg)
        return out
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group=pg),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group=pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# -- differentiable collectives ------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, grad):
        ctx.mesh, ctx.axis, ctx.grad = mesh, axis, grad
        return all_reduce_(x.detach().contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "psum":
            g = all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axis)
        return g, None, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        return _gather(x.detach(), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            dx = _slice_of(g, ctx.mesh, ctx.axis, ctx.dim).contiguous()
        else:
            dx = _scatter(g, ctx.mesh, ctx.axis, ctx.dim)
        return dx, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter(x.detach(), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return _exchange(x.detach(), mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis, ctx.concat_dim,
                         ctx.split_dim), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _rotate(x.detach(), mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def psum(x, mesh, axis, grad="identity"):
    """The sum of ``x`` over the ranks of ``axis`` (a name or a tuple of
    names), on every one of them."""
    return _PSum.apply(x, mesh, axis, grad)


def pvary(x, mesh, axis):
    """``x`` unchanged; its gradient summed over ``axis``."""
    return _PVary.apply(x, mesh, axis)


def all_gather(x, mesh, axis, dim=0, grad="reduce_scatter"):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, mesh, axis, dim % x.dim(), grad)


def reduce_scatter(x, mesh, axis, dim=0):
    """This rank's slice along ``dim`` of the sum of the ranks' ``x``."""
    return _ReduceScatter.apply(x, mesh, axis, dim % x.dim())


def all_to_all(x, mesh, axis, split_dim=0, concat_dim=0):
    """Chunk ``j`` of ``x`` along ``split_dim`` goes to the axis's rank
    ``j``; the chunks received are concatenated along ``concat_dim`` in
    rank order."""
    return _AllToAll.apply(x, mesh, axis, split_dim % x.dim(),
                           concat_dim % x.dim())


def ppermute(x, mesh, axis, shift=1):
    """``x`` of the rank ``shift`` places back around the axis's ring
    (``lax.ppermute`` with ``perm=[(i, (i + shift) % n)]``)."""
    return _PPermute.apply(x, mesh, axis, int(shift))


# -- the batch axis of a data-parallel step --------------------------------

class BatchSync:
    """The batch axis of a data-parallel step, handed by the step to each
    BatchNorm site (its ``sync=``): the ranks along ``axis`` hold equal
    slices of the global batch, so a site all-reduces its forward
    moments and the two sums of its backward over it and normalizes by
    the global batch's statistics."""

    def __init__(self, mesh, axis):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)

    def sum_(self, t):
        """``t`` summed over the axis, in place (no autograd)."""
        return all_reduce_(t, self.mesh, self.axis)

    def moments(self, mean, m2, differentiable=False):
        """The global batch's ``(E[y], E[y^2])`` from this rank's: one
        all-reduce of both.  ``differentiable`` all-reduces their
        cotangent in the backward too."""
        both = torch.cat([mean, m2])
        if differentiable:
            both = psum(both, self.mesh, self.axis, grad="psum")
        else:
            both = self.sum_(both)
        both = both / self.size
        return both[:mean.shape[0]], both[mean.shape[0]:]
