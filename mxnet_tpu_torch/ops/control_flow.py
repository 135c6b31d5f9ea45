"""The control-flow constructs (counterpart of ``foreach``,
``while_loop`` and ``cond`` in ``mxnet_tpu/ndarray/contrib.py``), on
tensors: ``F.contrib.*`` of a ``hybrid_forward``, and under
``mx.nd.contrib.*`` on NDArrays (:mod:`..ndarray.contrib`).

The body's ops are recorded as they run, under ``record`` in predict
mode (the JAX package's ``autograd.pause()``), and gradients flow
through ``data``, the states, ``loop_vars`` and ``inputs`` only: while a
construct records, a tensor that requires a gradient and is neither one
of its operands nor made inside the body -- an array the body's closure
captures, a block's parameter -- is read detached (:class:`_Operands`),
a constant to the gradient as in the JAX package, where the construct
is one tape node (thread a weight through the state if it must train).
The backward is the ops' own, so a hybridized block's backward graph
captures it.

Nothing is read back to the host, so each construct runs inside a
captured CUDA graph:

- ``foreach`` unrolls the body over the leading axis of ``data``;
- ``while_loop`` runs exactly ``max_iterations`` masked steps (required):
  a step after the condition first fails keeps the loop variables and
  outputs zeros;
- ``cond`` runs both branches and selects by the predicate on the card.
  Each branch gets its inputs through a ``where`` on the predicate (the
  inputs themselves for the branch taken, a detached copy for the
  other), so a NaN or inf in the gradient of the branch not taken never
  reaches the inputs' gradients.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError

__all__ = ["cond", "foreach", "while_loop"]


def _aslist(x):
    if x is None:
        return [], True
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _unlist(lst, single):
    if single:
        return lst[0] if lst else None
    return lst


class _Operands(torch.overrides.TorchFunctionMode):
    """Detaches every gradient-taking tensor an op is given that is
    neither an operand of the construct nor made inside its body."""

    def __init__(self, operands):
        super().__init__()
        self.known = {id(t) for t in operands}

    def _cut(self, x):
        if isinstance(x, torch.Tensor) and x.requires_grad \
                and id(x) not in self.known:
            return x.detach()
        return x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args = tuple(self._cut(a) if not isinstance(a, (list, tuple))
                     else type(a)(self._cut(b) for b in a) for a in args)
        kwargs = {k: self._cut(v) for k, v in (kwargs or {}).items()}
        out = func(*args, **kwargs)
        for o in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(o, torch.Tensor):
                self.known.add(id(o))
        return out


def run(pure, tensors):
    """``pure`` over ``tensors``: recorded, with gradients through the
    operands alone, when a gradient is recorded through any of them;
    else plainly."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        with autograd.record(train_mode=False), _Operands(tensors):
            return list(pure(*tensors))
    with torch.no_grad(), autograd.pause():
        return list(pure(*tensors))


def _identity(x):
    return x


def foreach(body, data, init_states, box=_identity, unbox=_identity):
    """``body(data_t, states) -> (out_t, states)`` over the leading axis
    of ``data``: the stacked outputs and the final states.  ``box``
    turns a tensor into what the body takes (an NDArray under
    ``mx.nd.contrib``), ``unbox`` back."""
    datas, single_data = _aslist(data)
    states, single_state = _aslist(init_states)
    n_data, meta = len(datas), {}

    def pure(*vals):
        xs, carry = vals[:n_data], list(vals[n_data:])
        steps = []
        for t in range(xs[0].shape[0] if xs else 0):
            out, new = body(_unlist([box(x[t]) for x in xs], single_data),
                            _unlist([box(c) for c in carry], single_state))
            outs, meta["out_single"] = _aslist(out)
            steps.append([unbox(o) for o in outs])
            carry = [unbox(n) for n in _aslist(new)[0]]
        stacked = [torch.stack(col) for col in zip(*steps)]
        return tuple(stacked) + tuple(carry)

    outs = [box(o) for o in run(pure, [unbox(d) for d in datas]
                                 + [unbox(s) for s in states])]
    n_out = len(outs) - len(states)
    return (_unlist(outs[:n_out], meta.get("out_single", True)),
            _unlist(outs[n_out:], single_state))


def while_loop(cond, func, loop_vars, max_iterations=None, box=_identity,
               unbox=_identity):
    """``func(*vars) -> (out, vars)`` while ``cond(*vars)``, as exactly
    ``max_iterations`` masked steps: the stacked per-step outputs (zero
    after the stop) and the final loop variables."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations "
                         "(static bound for the compiled loop)")
    vars_, single = _aslist(loop_vars)
    meta = {}

    def pure(*vals):
        vs = list(vals)
        active = torch.ones((), dtype=torch.bool, device=vs[0].device)
        steps = []
        for _ in range(int(max_iterations)):
            nds = [box(v) for v in vs]
            c = unbox(cond(*nds))
            out, new = func(*nds)
            outs, meta["out_single"] = _aslist(out)
            active = active & c.to(torch.bool).reshape(())
            vs = [torch.where(active, unbox(n), v)
                  for n, v in zip(_aslist(new)[0], vs)]
            steps.append([torch.where(active, unbox(o),
                                      torch.zeros_like(unbox(o)))
                          for o in outs])
        return tuple(torch.stack(col) for col in zip(*steps)) + tuple(vs)

    outs = [box(o) for o in run(pure, [unbox(v) for v in vars_])]
    n_out = len(outs) - len(vars_)
    return (_unlist(outs[:n_out], meta.get("out_single", True)),
            _unlist(outs[n_out:], single))


def cond(pred, then_func, else_func, inputs=None, box=_identity,
         unbox=_identity):
    """``then_func(*inputs)`` where ``pred`` is nonzero, else
    ``else_func(*inputs)``, selected on the device."""
    inputs, _ = _aslist(inputs)
    meta = {}

    def branch(fn, ins):
        outs, meta["single"] = _aslist(fn(*[box(x) for x in ins]))
        return [unbox(o) for o in outs]

    def pure(p, *vals):
        p = p.to(torch.bool).reshape(())
        then_out = branch(then_func, [torch.where(p, v, v.detach())
                                      for v in vals])
        else_out = branch(else_func, [torch.where(p, v.detach(), v)
                                      for v in vals])
        return tuple(torch.where(p, a, b)
                     for a, b in zip(then_out, else_out))

    outs = [box(o) for o in run(pure, [unbox(pred)]
                                 + [unbox(x) for x in inputs])]
    return _unlist(outs, meta.get("single", True))
