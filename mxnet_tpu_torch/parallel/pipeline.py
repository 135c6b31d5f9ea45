"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

GPipe: the S stages are one stacked parameter tree with a leading stage
axis sharded over ``pp`` -- each rank holds its stage's weights -- and
microbatches move stage to stage by ``batch_isend_irecv``
(:func:`~.collectives.ppermute`).  The JAX package runs the schedule as
one ``shard_map`` program whose every device computes at every tick;
here rank ``s`` runs its stage at tick ``t`` on microbatch ``t - s``
when there is one, and every rank sends on at every tick, so the ranks'
collectives stay in lockstep.  Requirements: homogeneous stages (one
``stage_fn``, stacked params).  The bubble fraction is (S-1)/(M+S-1);
raise the microbatch count M to amortize it.  Differentiable end to end:
the rotation's backward is the reverse rotation.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import collectives as _coll
from .mesh import NamedSharding, PartitionSpec as P, global_shape_of

__all__ = ["stack_stage_params", "shard_stacked_params", "pipeline_apply"]


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def stack_stage_params(param_trees):
    """Stack S per-stage parameter trees (dicts, lists or tuples of
    tensors) into one tree with a leading stage axis (shard it over
    ``pp``)."""
    return _tree_map(lambda *leaves: torch.stack(
        [torch.as_tensor(v) for v in leaves]), *param_trees)


def shard_stacked_params(stacked, mesh, axis="pp"):
    """Place a stacked parameter tree with its stage axis over ``pp``:
    each rank keeps its stage, a ``(1, ...)`` slice of rank 0's value
    on the mesh's device."""
    from .tensor_parallel import place_value

    def put(leaf):
        leaf = torch.as_tensor(leaf).to(mesh.device)
        spec = P(axis, *([None] * (leaf.dim() - 1)))
        return place_value(leaf, NamedSharding(mesh, spec))
    return _tree_map(put, stacked)


def pipeline_apply(stage_fn, stacked_params, microbatches, mesh,
                   axis="pp"):
    """Run ``microbatches`` ``(M, mb, ...)`` through S pipelined stages.

    ``stage_fn(stage_params, x) -> x`` applies one stage; S is
    ``mesh.shape[axis]``; ``stacked_params`` leaves have leading stage
    dim S (:func:`stack_stage_params` + :func:`shard_stacked_params`;
    each rank holds its ``(1, ...)`` slice).  Returns the ``(M, mb,
    ...)`` outputs on every rank."""
    S = mesh.shape[axis] if axis in mesh.shape else None
    if S is None:
        raise MXNetError("mesh has no axis %r" % axis)
    M = microbatches.shape[0]
    leaves = _leaves(stacked_params)
    if not leaves:
        raise MXNetError("stacked_params has no array leaves")
    lead = {global_shape_of(leaf)[0] if leaf.dim() else None
            for leaf in leaves}
    if lead != {S}:
        raise MXNetError(
            "stacked params have leading stage dim(s) %s but the %r mesh "
            "axis has %d devices; stack exactly one stage per device "
            "(scalar leaves cannot be staged)"
            % (sorted(map(str, lead)), axis, S))
    if any(mesh.shape[a] > 1 for a in mesh.axis_names if a != axis):
        raise MXNetError("pipeline_apply uses every device of the mesh "
                         "for stages; pass a 1-D pp mesh")
    if any(leaf.shape[0] != 1 for leaf in leaves):
        raise MXNetError("stacked params are not placed: shard them over "
                         "%r first (shard_stacked_params)" % axis)
    idx = mesh.axis_index(axis)
    local = _tree_map(lambda p: p[0], stacked_params)
    xs = microbatches.to(mesh.device)
    # differentiating: every rank's backward must run every rotation's
    # reverse, in the same order, so each sent value joins the output
    # (times 0) and the idle ticks send a value that takes a gradient
    grad = torch.is_grad_enabled() and (xs.requires_grad or any(
        leaf.requires_grad for leaf in leaves))
    zero = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device,
                       requires_grad=grad)
    anchor = None
    state = None
    outputs = [None] * M
    for t in range(M + S - 1):
        mb = t - idx                    # the microbatch at this stage now
        if 0 <= mb < M:
            inp = xs[mb] if idx == 0 else state
            out = stage_fn(local, inp)
            if idx == S - 1:
                outputs[mb] = out
        else:
            out = zero
        state = _coll.ppermute(out, mesh, axis, 1)
        if grad:
            tie = (state * 0).sum()
            anchor = tie if anchor is None else anchor + tie
    outs = torch.stack([o if o is not None else zero for o in outputs])
    if anchor is not None:
        outs = outs + anchor
    # only the last stage holds outputs (the others zeros): the sum
    # replicates them on every rank
    return _coll.psum(outs, mesh, axis)
