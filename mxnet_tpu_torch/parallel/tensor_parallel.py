"""Tensor (model) parallelism over a mesh axis (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``).

Megatron-style: a column-parallel Dense splits its weight's output dim
over the ``tp`` axis, the paired row-parallel Dense its input dim.  The
JAX package writes only the shardings and lets XLA's partitioner insert
the one all-reduce at the row layer's output.  The port holds each
rank's shard and issues the collectives itself (:mod:`.collectives`):

- a column layer reads the replicated input through :func:`pvary`
  (the identity forward; backward the all-reduce of the input
  gradient over ``tp``) and holds its output slice;
- a row layer multiplies its input slice by its weight slice, sums the
  partial products over ``tp`` (:func:`psum`) and adds its replicated
  bias after the sum;
- an Embedding split on its hidden dim gathers its output over ``tp``.

:func:`place_param` places a parameter (rank 0's value, then this
rank's shard); ``shard_block_tp`` places an existing block's parameters
by name rule, the ``ColumnParallelDense``/``RowParallelDense`` layers
build tp-native models.  A ``Dense`` or ``Embedding`` whose weight was
placed sharded runs its sharded forward wherever it sits
(:func:`dense_forward`, :func:`embedding_forward`).
"""
from __future__ import annotations

import re

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from . import collectives as _coll
from .mesh import NamedSharding, PartitionSpec as P, annotate

__all__ = ["place_param", "place_value", "ColumnParallelDense",
           "RowParallelDense", "TensorParallelMLP", "shard_block_tp",
           "dense_forward", "embedding_forward", "shard_summed_norms"]


def place_value(full, sharding):
    """Rank 0's ``full`` (broadcast over the whole mesh, in place), then
    this rank's shard of it, annotated with ``sharding``."""
    import torch
    mesh = sharding.mesh
    with torch.no_grad():
        buf = full.detach().contiguous()
        _coll.broadcast_(buf, mesh, tuple(mesh.axis_names))
        local = buf if sharding.is_replicated else \
            buf[sharding.local_slices(buf.shape)].contiguous().clone()
    return annotate(local, sharding, full.shape)


def place_param(param, mesh, spec):
    """Place a Parameter on the mesh under ``spec``: record the sharding
    and, when the value exists, replace it by this rank's shard of rank
    0's value (a deferred parameter is placed when it is
    materialized)."""
    sh = NamedSharding(mesh, spec)
    have = param._sharding
    if param._placed and have is not None and have.mesh is mesh \
            and tuple(have.spec) == tuple(sh.spec):
        return
    if param._placed and have is not None and not have.is_replicated:
        raise MXNetError("parameter %s is already sharded as %r"
                         % (param.name, have))
    param._sharding = sh
    if param._data is None:
        return
    param._data = param._wrap(place_value(param._data, sh))
    param._placed = True


def shard_summed_norms(tensors, *norms):
    """Per-tensor norms with each sharded tensor's (one annotated with a
    mesh's sharding) made the whole parameter's: one all-reduce of the
    squared norms of the sharded tensors a mesh and axis set.  A
    replicated tensor's norm is kept as it is (its value is the same on
    every rank).  A bucketed LAMB or LARS takes it as its
    ``shard_norms``, where XLA's partitioner makes the JAX step's norms
    global by itself."""
    import torch
    groups = {}
    for k, t in enumerate(tensors):
        sh = getattr(t, "_mx_sharding", None)
        if sh is None or sh.is_replicated:
            continue
        axes = tuple(sh.spec.axes())
        groups.setdefault((id(sh.mesh), axes), (sh.mesh, axes, []))[2] \
            .append(k)
    if not groups:
        return norms
    out = [list(n.unbind(0)) for n in norms]
    for mesh, axes, ks in groups.values():
        sq = torch.stack([n[k] for n in norms for k in ks]) ** 2
        total = _coll.all_reduce_(sq, mesh, axes).sqrt()
        for j, lst in enumerate(out):
            for q, k in enumerate(ks):
                lst[k] = total[j * len(ks) + q]
    return [torch.stack(lst) for lst in out]


def _axis_of(part):
    if isinstance(part, tuple):
        if len(part) != 1:
            raise MXNetError("a Dense dim splits over one mesh axis, "
                             "not %r" % (part,))
        return part[0]
    return part


def _dense_role(layer):
    """``("col" | "row", mesh, axis)`` of a Dense whose weight is
    sharded, None otherwise."""
    sh = layer.weight._sharding
    if sh is None or sh.is_replicated:
        return None
    spec = tuple(sh.spec) + (None,) * (2 - len(sh.spec))
    if spec[0] is not None and spec[1] is None:
        return "col", sh.mesh, _axis_of(spec[0])
    if spec[1] is not None and spec[0] is None:
        return "row", sh.mesh, _axis_of(spec[1])
    raise MXNetError("Dense %s: weight sharding %r is neither column- "
                     "nor row-parallel" % (layer.name, sh.spec))


def dense_in_units(layer, in_units):
    """The global in_units of a Dense given its input's last dim: a
    row-parallel layer's input is its slice."""
    role = _dense_role(layer)
    if role is not None and role[0] == "row":
        return in_units * role[1].axis_size(role[2])
    return in_units


def dense_forward(F, layer, x, weight, bias):
    """The forward of a Dense whose weight is sharded over a mesh
    axis: column- or row-parallel by its weight's spec."""
    role, mesh, axis = _dense_role(layer)
    if role == "col":
        x = _coll.pvary(x, mesh, axis)
        bsh = layer.bias._sharding if layer.bias is not None else None
        if layer.bias is not None and (bsh is None or bsh.is_replicated):
            raise MXNetError("column-parallel Dense %s: its bias must be "
                             "split with its outputs" % layer.name)
        out = F.FullyConnected(x, weight, bias, num_hidden=layer._units,
                               no_bias=bias is None,
                               flatten=layer._flatten)
    else:
        out = F.FullyConnected(x, weight, None, num_hidden=layer._units,
                               no_bias=True, flatten=layer._flatten)
        out = _coll.psum(out, mesh, axis)
        if bias is not None:
            out = out + bias
    if layer._act:
        out = F.Activation(out, act_type=layer._act)
    return out


def embedding_forward(F, layer, x, weight):
    """The forward of an Embedding whose weight is split on its hidden
    dim: the local columns, gathered over the axis (this rank's slice
    of the gradient back: every rank reads the gathered rows)."""
    sh = layer.weight._sharding
    spec = tuple(sh.spec) + (None,) * (2 - len(sh.spec))
    if spec[0] is not None or spec[1] is None:
        raise MXNetError("Embedding %s: only a split of the hidden dim "
                         "(PartitionSpec(None, axis)) is supported, not "
                         "%r" % (layer.name, sh.spec))
    out = F.Embedding(x, weight)
    return _coll.all_gather(out, sh.mesh, _axis_of(spec[1]), dim=-1,
                            grad="slice")


class ColumnParallelDense(nn.Dense):
    """Dense with the weight split on the OUTPUT dim over ``tp``
    (Megatron column-parallel linear).  Output stays tp-sharded; follow
    with a RowParallelDense to come back together."""

    def __init__(self, units, mesh=None, axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self._tp_mesh = mesh
        self._tp_axis = axis

    def shard(self, mesh=None):
        mesh = mesh or self._tp_mesh
        if mesh is None:
            raise MXNetError("no mesh to shard over")
        # weight (units, in): split rows (outputs); bias follows
        place_param(self.weight, mesh, P(self._tp_axis, None))
        if getattr(self, "bias", None) is not None:
            place_param(self.bias, mesh, P(self._tp_axis))
        return self


class RowParallelDense(nn.Dense):
    """Dense with the weight split on the INPUT dim over ``tp``: the
    partial products all-reduce at the output, then the bias."""

    def __init__(self, units, mesh=None, axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self._tp_mesh = mesh
        self._tp_axis = axis

    def shard(self, mesh=None):
        mesh = mesh or self._tp_mesh
        if mesh is None:
            raise MXNetError("no mesh to shard over")
        # weight (units, in): split columns (inputs); bias replicated
        place_param(self.weight, mesh, P(None, self._tp_axis))
        if getattr(self, "bias", None) is not None:
            place_param(self.bias, mesh, P())
        return self


class TensorParallelMLP(HybridBlock):
    """The canonical tp block: column-parallel up-projection, gelu,
    row-parallel down-projection -- ONE all-reduce per MLP, the
    transformer FFN recipe."""

    def __init__(self, hidden, units, mesh=None, axis="tp",
                 activation="gelu", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.up = ColumnParallelDense(hidden, mesh=mesh, axis=axis,
                                          flatten=False)
            self.act = nn.Activation(activation)
            self.down = RowParallelDense(units, mesh=mesh, axis=axis,
                                         flatten=False)

    def shard(self, mesh=None):
        self.up.shard(mesh)
        self.down.shard(mesh)
        return self

    def hybrid_forward(self, F, x):
        return self.down(self.act(self.up(x)))


# default Megatron-ish rules for annotating an existing model:
# (regex on param name) -> PartitionSpec builder given the tp axis name
_DEFAULT_RULES = [
    (r".*(qkv|query|key|value|up|fc1|ffn_1|intermediate).*weight",
     lambda ax: P(ax, None)),
    (r".*(qkv|query|key|value|up|fc1|ffn_1|intermediate).*bias",
     lambda ax: P(ax)),
    (r".*(proj|out|down|fc2|ffn_2|output).*weight",
     lambda ax: P(None, ax)),
    (r".*embed.*weight", lambda ax: P(None, ax)),
]


def shard_block_tp(block, mesh, axis="tp", rules=None):
    """Place an existing block's parameters with tp shardings by name
    rule; unmatched params are replicated.  Returns the names that were
    tp-sharded (for asserting coverage in tests)."""
    rules = [(re.compile(pat), fn) for pat, fn in
             (rules or _DEFAULT_RULES)]
    sharded = []
    for p in block.collect_params().values():
        spec = None
        for pat, fn in rules:
            if pat.match(p.name):
                spec = fn(axis)
                break
        if spec is None:
            spec = P()
        else:
            sharded.append(p.name)
        place_param(p, mesh, spec)
    return sharded
