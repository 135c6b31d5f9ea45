"""The non-finite sentinel, runtime half (counterpart of the runtime
layer of ``mxnet_tpu/analysis/numerics.py``).

Behind ``MXNET_TPU_NUMERICS_CHECK=1`` (read once at import; tests flip
it with :func:`_set_check`), ``TrainStep`` reads the finite flag its
step already computes, once after the step.  On the first non-finite
step it recomputes that step's gradients eagerly, from the weights the
step kept (a non-finite step keeps the pre-step weights and states) on
the same batch with the random state of the step, names the first
offender (:func:`attribute_nonfinite`, NaN before Inf) and raises
:class:`NonFiniteError`.  Disarmed, the default, the step makes no host
read for it.

The eager twins serve code outside ``TrainStep``:
:func:`finite_all` (and :func:`finite_tree` on tensors) is one finite
check over a set of arrays, a 0-d bool on their device, with no host
read (the fp16 loss scaler's overflow check, ``TrainStep``'s finite
select); :func:`finite_sentinel` checks named arrays when the sentinel
is armed, with one host read, and raises :class:`NonFiniteError`
naming the first offender.  Where the JAX functions flatten each dtype
group into one buffer for XLA to fuse, these reduce each array where it
lies and combine the flags: the same answer without a copy of every
gradient.

The ``numerics.nonfinite`` chaos point (armed with
:func:`poison_action`) lets a test or a chaos run poison one batch with
:func:`poison_nd`, so the fault flows through forward and backward and
the sentinel, not the injector, must catch it; ``TrainStep`` and the
continuous trainer visit it once a step.  Checks and detections count
under the JAX package's ``numerics.*`` telemetry instruments, and
:func:`status_row` is the ``/statusz`` row.  The JAX package's static
lints and HLO audit are not part of the port.
"""
from __future__ import annotations

import time

import torch

from .. import env
from ..bucketing import dtype_groups

__all__ = ["NonFiniteError", "attribute_nonfinite", "check_enabled",
           "finite_all", "finite_sentinel", "finite_tree", "note_check",
           "poison_action", "poison_nd", "record_nonfinite", "status_row"]

_CHECK = env.get("MXNET_TPU_NUMERICS_CHECK")

# the sentinel's record: checks made and their host-read seconds,
# non-finite steps seen, the last one
_STATE = {"checks": 0, "check_seconds": 0.0, "nonfinite": 0, "last": None}


def check_enabled() -> bool:
    """Is the non-finite sentinel armed (``MXNET_TPU_NUMERICS_CHECK``)?"""
    return _CHECK


def _set_check(flag):
    """Arm or disarm the sentinel without re-importing; returns the
    previous setting."""
    global _CHECK
    prev = _CHECK
    _CHECK = bool(flag)
    return prev


class NonFiniteError(RuntimeError):
    """A gradient (or the loss) went NaN/Inf; ``param`` names the first
    offender, ``step`` the update count, ``kind`` is ``'nan'`` or
    ``'inf'``.  Raised after the step kept the pre-step weights and
    optimizer state, so a handler can lower the lr or skip the batch and
    go on."""

    def __init__(self, param, step, kind):
        super().__init__(
            "non-finite gradient: %s in parameter %r at step %s "
            "(weights kept at their pre-step values)" % (kind, param, step))
        self.param = param
        self.step = step
        self.kind = kind


def _float_leaves(leaves):
    return [x for x in leaves
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def finite_tree(leaves):
    """Whether every element of every floating tensor of ``leaves`` is
    finite, as a 0-d bool on their device (on the CPU when there is
    none); other leaves (integer counters) are skipped.  Each dtype
    group reduces to one flag; no host read."""
    fl = _float_leaves(leaves)
    if not fl:
        return torch.tensor(True)
    flags = [torch.stack([torch.isfinite(fl[i]).all() for i in idxs]).all()
             for _dtype, idxs in dtype_groups(fl)]
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def finite_all(arrays):
    """:func:`finite_tree` over NDArrays or tensors: one finite check
    over the set, a device boolean the caller reads when it chooses."""
    return finite_tree([getattr(a, "_data", a) for a in arrays])


def attribute_nonfinite(named):
    """``(name, kind)`` of the first non-finite entry of ``(name,
    tensor)`` pairs, NaN reported before Inf when both occur; None when
    every entry is finite.  Reads each tensor on the host (the failure
    path only)."""
    first_inf = None
    for name, t in named:
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            continue
        t = t.detach()
        if bool(torch.isnan(t).any()):
            return name, "nan"
        if first_inf is None and bool(torch.isinf(t).any()):
            first_inf = (name, "inf")
    return first_inf


def note_check(seconds):
    """Book one sentinel check of ``seconds`` (its host read): the
    ``/statusz`` counter and the ``numerics.checks`` /
    ``numerics.check_time`` instruments."""
    _STATE["checks"] += 1
    _STATE["check_seconds"] += seconds
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.numerics_check(seconds)


def finite_sentinel(named, step=None):
    """Check ``(name, array)`` pairs for non-finite values with one
    host read and raise :class:`NonFiniteError` naming the first
    offender (NaN before Inf).  Disarmed, the default, it touches
    nothing.  Returns True on a clean pass."""
    if not _CHECK:
        return True
    named = list(named)
    ok_dev = finite_all([a for _n, a in named])
    t0 = time.perf_counter()
    ok = bool(ok_dev)
    note_check(time.perf_counter() - t0)
    if ok:
        return True
    hit = attribute_nonfinite(
        [(n, getattr(a, "_data", a)) for n, a in named])
    param, kind = hit if hit is not None else ("<unattributed>",
                                               "nonfinite")
    record_nonfinite(param, step, kind)
    raise NonFiniteError(param, step, kind)


def record_nonfinite(param, step, kind):
    """Book a detected non-finite step: telemetry and the ``/statusz``
    row."""
    _STATE["nonfinite"] += 1
    _STATE["last"] = {"param": param, "step": step, "kind": kind}
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.numerics_nonfinite(param, step, kind)


# -- chaos integration -------------------------------------------------

def poison_action(ctx):
    """The ``numerics.nonfinite`` chaos action: instead of raising,
    mark the caller's ``box`` so IT poisons the in-flight batch with a
    NaN -- the fault then flows through forward/backward and must be
    caught by the sentinel, not by the injector.  Arm with::

        chaos.on("numerics.nonfinite", numerics.poison_action, nth=3)
    """
    box = ctx.get("box")
    if box is not None:
        box["poison"] = True


def poison_nd(x):
    """A copy of a floating array (NDArray or tensor) with element 0 set
    to NaN, in the wrapper it came in; any other array comes back as it
    is."""
    data = getattr(x, "_data", x)
    if not data.is_floating_point():
        return x
    poisoned = data.detach().clone()
    poisoned.view(-1)[0] = float("nan")
    if hasattr(x, "_data"):
        from ..ndarray import NDArray
        return NDArray(poisoned)
    return poisoned


def status_row():
    """The ``/statusz`` numerics row: sentinel arm state, checks run,
    non-finite steps seen, and the last attribution."""
    return {"armed": _CHECK, "checks": _STATE["checks"],
            "nonfinite": _STATE["nonfinite"], "last": _STATE["last"]}
