"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(counterpart of ``mxnet_tpu/parallel/moe.py``).

The experts are ONE stacked parameter ``(E, d_in, d_hid)`` sharded on
its expert axis over ``ep``; routing is a dense one-hot dispatch with a
static capacity (top-1, Switch/GShard): tokens past an expert's
capacity are dropped, every shape stays fixed.  The capacity comes from
the token count the layer sees globally, as the JAX layer's does.  On a
mesh, with the experts placed by :meth:`MixtureOfExperts.shard`:

- replicated tokens (the same ``(T, d)`` on every rank): each rank fills
  and runs its own experts' inboxes and the expert outputs are gathered
  over ``ep`` (:func:`~.collectives.all_gather`) for the combine;
- tokens split over ``ep`` (a batch placed by ``shard_batch(x, mesh,
  axis_name="ep")``): a token's slot in its expert's queue counts the
  tokens of the ranks before (one all-gather of the per-expert counts),
  each rank sends every expert owner its tokens' inbox rows
  (:func:`~.collectives.all_to_all`), the owners run their experts and
  the outputs are gathered back for the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..base import MXNetError
from ..gluon.block import HybridBlock
from . import collectives as _coll
from .mesh import PartitionSpec as P, sharding_of

__all__ = ["MixtureOfExperts", "moe_load_balancing_loss"]


class MixtureOfExperts(HybridBlock):
    """Top-1 (Switch) MoE feed-forward layer.

    Input ``(tokens, d_model)`` -> gate -> dispatch at capacity ->
    per-expert FFN -> combine.  ``shard(mesh)`` places the stacked
    expert weights over the ``ep`` axis.
    """

    def __init__(self, num_experts, d_model, d_hidden, capacity_factor=1.25,
                 mesh=None, axis="ep", **kwargs):
        super().__init__(**kwargs)
        self._E = int(num_experts)
        self._dm = int(d_model)
        self._dh = int(d_hidden)
        self._cf = float(capacity_factor)
        self._mesh = mesh
        self._axis = axis
        from .. import initializer as init_mod
        # per-expert Xavier fan: the generic Xavier rule would read the
        # stacked (E, d_in, d_out) shape as a conv kernel and mis-scale
        bound = float((6.0 / (d_model + d_hidden)) ** 0.5)
        with self.name_scope():
            self.gate = self.params.get(
                "gate", shape=(d_model, num_experts), init="xavier")
            self.w_up = self.params.get(
                "w_up", shape=(num_experts, d_model, d_hidden),
                init=init_mod.Uniform(bound))
            self.w_down = self.params.get(
                "w_down", shape=(num_experts, d_hidden, d_model),
                init=init_mod.Uniform(bound))

    def shard(self, mesh=None):
        from .tensor_parallel import place_param
        mesh = mesh or self._mesh
        if mesh is None:
            raise MXNetError("no mesh to shard over")
        if self._E % mesh.axis_size(self._axis):
            raise MXNetError("%d experts do not split over %s=%d"
                             % (self._E, self._axis,
                                mesh.axis_size(self._axis)))
        for p, spec in ((self.w_up, P(self._axis, None, None)),
                        (self.w_down, P(self._axis, None, None)),
                        (self.gate, P())):
            place_param(p, mesh, spec)
        return self

    def hybrid_forward(self, F, x, gate=None, w_up=None, w_down=None):
        return _route_of(self, x)(x, gate, w_up, w_down, self._E, self._cf)


def _route_of(layer, x):
    """The forward for the layer's placement and the tokens': one
    device, replicated tokens or tokens split over the expert axis
    (each taking the mesh and axis)."""
    import functools
    sh = layer.w_up._sharding
    if sh is None or sh.is_replicated:
        return _moe_forward
    xs = sharding_of(x)
    fn = _moe_forward_tokens_split \
        if xs is not None and layer._axis in xs.spec.axes() \
        else _moe_forward_replicated
    return functools.partial(fn, mesh=sh.mesh, axis=layer._axis)


def _route(x, gate_w, E, C, offset=None):
    """Gate, top-1 expert, each token's slot in its expert's queue
    (``offset``: the slots the ranks before took) and the dispatch
    tensor ``(T, E, C)``."""
    logits = x @ gate_w                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_val, expert = probs.max(dim=-1)              # (T,)
    onehot = F_.one_hot(expert, E).to(torch.int32)    # (T, E)
    pos = torch.cumsum(onehot, dim=0) * onehot        # 1-based
    pos_in_expert = pos.sum(dim=-1) - 1               # (T,)
    if offset is not None:
        pos_in_expert = pos_in_expert + (onehot * offset[None]).sum(dim=-1)
    keep = pos_in_expert < C                          # overflow drops
    disp = (onehot.to(x.dtype)[:, :, None]
            * F_.one_hot(torch.clamp(pos_in_expert, 0, C - 1), C)
            .to(x.dtype)[:, None, :]
            * keep[:, None, None].to(x.dtype))
    return disp, gate_val, onehot


def _experts(inbox, w_up, w_down):
    h = F_.gelu(torch.einsum("ecd,edh->ech", inbox, w_up),
                approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w_down)


def _moe_forward(x, gate_w, w_up, w_down, E, capacity_factor):
    """(T, d) tokens -> (T, d); static-capacity top-1 dispatch."""
    T = x.shape[0]
    C = max(1, int(capacity_factor * T / E))
    disp, gate_val, _ = _route(x, gate_w, E, C)
    inbox = torch.einsum("tec,td->ecd", disp, x)      # (E, C, d)
    out_e = _experts(inbox, w_up, w_down)
    out = torch.einsum("tec,ecd->td", disp, out_e)
    return out * gate_val[:, None]


def _moe_forward_replicated(x, gate_w, w_up, w_down, E, capacity_factor,
                            mesh, axis):
    T = x.shape[0]
    C = max(1, int(capacity_factor * T / E))
    El = w_up.shape[0]
    e0 = mesh.axis_index(axis) * El
    disp, gate_val, _ = _route(x, gate_w, E, C)
    # this rank's experts' inboxes; the input's gradient sums the ranks'
    inbox = torch.einsum("tec,td->ecd", disp[:, e0:e0 + El],
                         _coll.pvary(x, mesh, axis))
    out_e = _coll.all_gather(_experts(inbox, w_up, w_down), mesh, axis,
                             dim=0, grad="slice")
    out = torch.einsum("tec,ecd->td", disp, out_e)
    return out * gate_val[:, None]


def _moe_forward_tokens_split(x, gate_w, w_up, w_down, E, capacity_factor,
                              mesh, axis):
    n = mesh.axis_size(axis)
    T = x.shape[0] * n                 # the tokens the layer sees
    C = max(1, int(capacity_factor * T / E))
    probs_expert = torch.softmax(x.detach() @ gate_w.detach(), dim=-1) \
        .argmax(dim=-1)
    mine = torch.bincount(probs_expert, minlength=E).to(torch.int32)
    counts = _coll.all_gather(mine[None], mesh, axis, dim=0)   # (n, E)
    idx = mesh.axis_index(axis)
    offset = counts[:idx].sum(dim=0)
    disp, gate_val, _ = _route(x, gate_w, E, C, offset=offset)
    rows = torch.einsum("tec,td->ecd", disp, x)        # (E, C, d)
    # every expert owner gets the ranks' rows for its experts, summed
    got = _coll.all_to_all(rows, mesh, axis, split_dim=0, concat_dim=0)
    El = E // n
    inbox = got.reshape((n, El) + tuple(got.shape[1:])).sum(dim=0)
    out_e = _coll.all_gather(_experts(inbox, w_up, w_down), mesh, axis,
                             dim=0)
    out = torch.einsum("tec,ecd->td", disp, out_e)
    return out * gate_val[:, None]


def moe_load_balancing_loss(x, gate_w):
    """Auxiliary load-balance loss (Switch eq. 4): E * sum_e f_e * p_e."""
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    expert = probs.argmax(dim=-1)
    frac = F_.one_hot(expert, E).to(probs.dtype).mean(dim=0)
    prob_mean = probs.mean(dim=0)
    return E * torch.sum(frac * prob_mean)
