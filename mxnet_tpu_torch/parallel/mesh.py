"""Device meshes over a world of processes, one card each (counterpart of
``mxnet_tpu/parallel/mesh.py``).

The JAX package addresses its devices through a ``jax.sharding.Mesh``
and lets XLA's partitioner insert the collectives.  The port runs one
process per card -- the JAX package's own model for a multi-host run
(``global_mesh``, ``stage_process_local``, ``put_replicated``) -- for
every mesh:

- a :class:`Mesh` is a grid of the world's ranks with axis names; each
  axis has one ``torch.distributed`` process subgroup per slice, made
  when the mesh is made, by every rank in the same order;
- a sharded parameter or batch is the rank's local shard, a tensor that
  carries its :class:`NamedSharding` and global shape
  (:func:`annotate`, :func:`sharding_of`); a replicated one is the full
  value on every rank;
- the collectives are explicit calls of :mod:`.collectives`, issued
  where XLA's partitioner puts them.

The world is :mod:`mxnet_tpu_torch.distributed`'s: one group whose
backend is ``"cpu:gloo,cuda:nccl"`` where NCCL is built, so CPU tensors
(the host collectives) go through gloo and CUDA tensors through NCCL,
whose communicator is made at the first CUDA collective.  A process
that joined no world makes a mesh over a world of one rank (an
in-process store): its collectives still run, through NCCL on the
card.
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["make_mesh", "Mesh", "NamedSharding", "PartitionSpec",
           "local_devices", "default_mesh", "global_mesh", "AXIS_ROLES",
           "put_replicated", "stage_process_local", "annotate",
           "sharding_of", "global_shape_of", "shard_tensor"]

# Canonical mesh-axis vocabulary (the JAX package's): the parallel
# layers, the docs and the sharding sanitizer (analysis.sharding, rule
# ``mesh-axis-unknown``) speak these five roles; a PartitionSpec naming
# an axis outside this table and outside every Mesh/make_mesh
# construction in the linted tree is flagged.
AXIS_ROLES = OrderedDict([
    ("dp", "data parallel: batch dim sharded, gradients all-reduced"),
    ("tp", "tensor (model) parallel: Megatron column/row weight splits"),
    ("pp", "pipeline parallel: one stage a rank, microbatches sent on"),
    ("sp", "sequence/context parallel: ring-attention KV rotation"),
    ("ep", "expert parallel: stacked MoE experts, all-to-all dispatch"),
])


class PartitionSpec(tuple):
    """How each dimension of an array maps onto mesh axes: an axis
    name, a tuple of names, or None (not sharded) per dimension, as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)

    def axes(self):
        """The mesh axes the spec names, in order."""
        out = []
        for p in self:
            for a in (p if isinstance(p, tuple) else (p,)):
                if a is not None and a not in out:
                    out.append(a)
        return out


def _ensure_world():
    """``(world size, rank)``, joining the launcher's world
    (:func:`~mxnet_tpu_torch.distributed.distributed_init`) or, in a
    process that has none, making a world of one rank over an in-process
    store."""
    import torch.distributed as dist
    from .. import distributed as _dist
    if not dist.is_initialized():
        _dist.distributed_init()
    if not dist.is_initialized():
        dist.init_process_group(_dist._backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
    return dist.get_world_size(), dist.get_rank()


def local_devices(platform=None):
    """The devices of this process: its card (``cuda:rank % count``),
    or the CPU when ``platform="cpu"``.  Raises when no card is visible
    and the CPU was not asked for."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is visible: a mesh runs on the "
                         "cards unless device=\"cpu\" is given")
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    return [torch.device("cuda", rank % torch.cuda.device_count())]


class Mesh:
    """A grid of world ranks with named axes.  ``devices`` is the rank
    grid (as the JAX mesh's device grid), ``shape`` the ``{axis: size}``
    map, ``device`` this process's card (or the CPU).  ``group(axis)``
    is the process subgroup of this rank's slice along ``axis`` (a
    tuple of axes: the slice varying along all of them),
    ``axis_index(axis)`` this rank's coordinate along it."""

    def __init__(self, ranks, axis_names, device=None):
        import torch.distributed as dist
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = dist.get_rank()
        self.device = torch.device(device) if device is not None \
            else local_devices()[0]
        where = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) \
            else None
        self._groups = {}
        # every rank of the world makes every subgroup, in one order
        for n in range(1, len(self.axis_names) + 1):
            for combo in itertools.combinations(self.axis_names, n):
                self._make_groups(combo)

    def _make_groups(self, axes):
        import torch.distributed as dist
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        grid = np.transpose(self.devices, rest + dims).reshape(
            -1, int(np.prod([self.devices.shape[d] for d in dims])))
        for row in grid:
            ranks = [int(r) for r in row]
            pg = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[tuple(axes)] = (pg, ranks)

    def _key(self, axis):
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        for a in axes:
            if a not in self.shape:
                raise MXNetError("mesh has no axis %r (axes %s)"
                                 % (a, list(self.axis_names)))
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axis):
        """``(process group, ranks)`` of this rank's slice along
        ``axis`` (a name or a tuple of names)."""
        if self.coords is None:
            raise MXNetError("rank %d is not in this mesh" % self.rank)
        return self._groups[self._key(axis)]

    def axis_size(self, axis):
        return int(np.prod([self.shape[a] for a in self._key(axis)]))

    def axis_index(self, axis):
        """This rank's index within its slice along ``axis``."""
        return self.group(axis)[1].index(self.rank)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%r: %d" % kv
                                      for kv in self.shape.items())


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: which slice of an array
    each rank holds."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        for a in self.spec.axes():
            mesh._key(a)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)

    @property
    def is_replicated(self):
        return not self.spec.axes()

    def is_equivalent_to(self, other, ndim):
        if other is None:
            return False
        a = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        b = tuple(other.spec) + (None,) * (ndim - len(other.spec))
        return self.mesh is other.mesh and a == b

    def _dim_axes(self, dim):
        part = self.spec[dim] if dim < len(self.spec) else None
        if part is None:
            return ()
        return part if isinstance(part, tuple) else (part,)

    def shard_shape(self, global_shape):
        out = []
        for d, size in enumerate(global_shape):
            n = int(np.prod([self.mesh.shape[a]
                             for a in self._dim_axes(d)]))
            if size % n:
                raise MXNetError(
                    "dim %d of size %d does not split over %s (%d ranks)"
                    % (d, size, self._dim_axes(d), n))
            out.append(size // n)
        return tuple(out)

    def local_slices(self, global_shape):
        """The slices of the global array this rank holds."""
        out = []
        for d, size in enumerate(global_shape):
            axes = self._dim_axes(d)
            if not axes:
                out.append(slice(None))
                continue
            idx, n = 0, 1
            for a in axes:          # the first axis is the major one
                idx = idx * self.mesh.shape[a] + self.mesh.axis_index(a)
                n *= self.mesh.shape[a]
            step = size // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)


def annotate(t, sharding, global_shape):
    """Mark ``t`` (a tensor) as this rank's shard of an array of
    ``global_shape`` laid out by ``sharding``; returns ``t``."""
    t._mx_sharding = sharding
    t._mx_global_shape = tuple(global_shape)
    return t


def sharding_of(t):
    """The :class:`NamedSharding` ``t`` was annotated with, or None."""
    t = getattr(t, "_data", t)
    return getattr(t, "_mx_sharding", None)


def global_shape_of(t):
    t = getattr(t, "_data", t)
    return getattr(t, "_mx_global_shape", tuple(t.shape))


def shard_tensor(full, sharding):
    """This rank's shard of the full array ``full`` (a copy), annotated."""
    local = full[sharding.local_slices(full.shape)].contiguous().clone()
    return annotate(local, sharding, full.shape)


def make_mesh(axes, devices=None, device=None):
    """A :class:`Mesh` from ``{'dp': 4, 'tp': 2}``-style axis sizes over
    the world's ranks (``devices``: a list of ranks, all by default).
    ``-1`` for one axis means all remaining ranks.  Axis order follows
    insertion order, the last axis varying fastest.  ``device`` is this
    process's device (its card by default; ``"cpu"`` for a gloo world on
    the CPU).  Every rank of the world must make the same meshes in the
    same order: each makes the process subgroups of every slice."""
    axes = OrderedDict(axes)
    world, _rank = _ensure_world()
    devices = list(devices if devices is not None else range(world))
    n = len(devices)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise MXNetError("only one mesh axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n % known:
            raise MXNetError("cannot infer -1 axis: %d devices not divisible "
                             "by %d" % (n, known))
        sizes[sizes.index(-1)] = n // known
    total = int(math.prod(sizes))
    if total > n:
        raise MXNetError("mesh wants %d devices, only %d available"
                         % (total, n))
    ranks = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(ranks, tuple(axes.keys()), device=device)


_default_mesh = None


def default_mesh():
    """A 1-D data-parallel mesh over the whole world (cached)."""
    global _default_mesh
    world, _rank = _ensure_world()
    if _default_mesh is None or _default_mesh.size != world:
        _default_mesh = make_mesh({"dp": -1})
    return _default_mesh


_global_meshes = {}


def global_mesh(axes=None, device=None):
    """The one mesh an SPMD program runs over: every rank of the world.
    Default axes ``{"dp": -1}``; pass e.g. ``{"dp": -1, "tp": 2}`` for a
    2-D mesh; ``device`` as for :func:`make_mesh`.  Cached per (axes,
    world size, device), so every caller -- ``TrainStep``,
    ``DeviceFeed``, checkpoint resharding -- agrees on one rank
    order."""
    axes = OrderedDict(axes if axes is not None else {"dp": -1})
    if "dp" not in axes:
        raise MXNetError("global_mesh needs a 'dp' axis (got %r)"
                         % list(axes))
    world, _rank = _ensure_world()
    key = (tuple(axes.items()), world, str(device))
    mesh = _global_meshes.get(key)
    if mesh is None:
        mesh = _global_meshes[key] = make_mesh(axes, device=device)
    return mesh


def put_replicated(x, sharding):
    """Place one value replicated on the mesh: rank 0's value, broadcast
    to every rank of the mesh (the JAX package assembles the global
    array from each process's copy, which callers must have synced).
    Returns the full value on this rank's device, annotated."""
    from . import collectives
    mesh = sharding.mesh
    t = getattr(x, "_data", x)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    t = t.detach().to(mesh.device).contiguous().clone()
    collectives.broadcast_(t, mesh, tuple(mesh.axis_names))
    return annotate(t, sharding, t.shape)


def stage_process_local(x, sharding):
    """Land one process-local batch shard as this rank's slice of the
    global array: every rank contributes its local batch, and the
    global batch is ``(ranks along the sharded axes) x local`` along
    each sharded dimension.  The tensor lands on the mesh's device,
    annotated with the sharding and the global shape; a tensor already
    annotated with an equivalent sharding is returned as it is."""
    t = getattr(x, "_data", x)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    have = getattr(t, "_mx_sharding", None)
    if have is not None and have.is_equivalent_to(sharding, t.dim()):
        return t
    mesh = sharding.mesh
    if t.device != mesh.device:
        t = t.to(mesh.device, non_blocking=True)
    gshape = [s * int(np.prod([mesh.shape[a]
                               for a in sharding._dim_axes(d)]))
              for d, s in enumerate(t.shape)]
    if t is x:
        t = t.view(t.shape)     # annotate a new tensor, not the caller's
    return annotate(t, sharding, gshape)
