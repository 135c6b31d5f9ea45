"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp``).

One policy, read at the port's op namespace: under an active target
dtype, :func:`apply_op_casts` casts the float inputs of the ops the
three lists of :mod:`.lists` name (:mod:`mxnet_tpu_torch.ops` applies it
to each such op it holds).  The cast is ``tensor.to(dtype)`` under
autograd, whose backward returns the gradient at the source dtype: fp32
parameters keep fp32 gradients, as the cast's VJP gives them in the JAX
package.

- ``bfloat16`` (the default): products in bf16, softmax and losses in
  fp32, no loss scaling.
- ``float16``: the same casts, plus dynamic loss scaling
  (:class:`LossScaler`) attached to a ``Trainer`` by :func:`init_trainer`
  and applied by :func:`scale_loss`; ``Trainer.step`` and ``TrainStep``
  skip the update on overflow.

The policy is thread-local, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import MXNetError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["LossScaler", "apply_op_casts", "convert_hybrid_block", "init",
           "init_trainer", "is_active", "lists", "policy_token",
           "scale_loss", "scope", "shutdown", "target_dtype", "unscale"]

_state = threading.local()
_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _st():
    if not hasattr(_state, "dtype"):
        _state.dtype = None
    return _state


def init(target_dtype="bfloat16"):
    """Activate mixed precision on this thread."""
    key = str(target_dtype).replace("torch.", "")
    if key not in _TARGETS:
        raise MXNetError("amp target_dtype must be bfloat16 or float16, "
                         "got %r" % (target_dtype,))
    _st().dtype = _TARGETS[key]


def shutdown():
    """Deactivate mixed precision on this thread."""
    _st().dtype = None


@contextlib.contextmanager
def scope(target_dtype="bfloat16"):
    """Mixed precision inside the ``with`` block only."""
    prev = _st().dtype
    init(target_dtype)
    try:
        yield
    finally:
        _state.dtype = prev


def is_active():
    return _st().dtype is not None


def target_dtype():
    """The active target dtype (a ``torch.dtype``), or None."""
    return _st().dtype


def policy_token():
    """A hashable token of the active policy (None when inactive)."""
    d = _st().dtype
    return str(d).replace("torch.", "") if d is not None else None


_TARGET_OPS = frozenset(lists.TARGET_DTYPE_OPS)
_FP32_OPS = frozenset(lists.FP32_OPS)
_WIDEST_OPS = frozenset(lists.WIDEST_TYPE_CASTS)
LISTED_OPS = _TARGET_OPS | _FP32_OPS | _WIDEST_OPS


def _is_float(d):
    return isinstance(d, torch.Tensor) and d.is_floating_point()


def _cast_floats(datas, dtype):
    return [d.to(dtype) if _is_float(d) else d for d in datas]


def apply_op_casts(op_name, datas):
    """An op's arguments cast by the active policy: float tensors to the
    target dtype for a TARGET op, to fp32 for an FP32 op, to fp32 for a
    WIDEST op that mixes fp32 with a narrower float.  Other arguments
    (ints, strings, integer tensors) pass unchanged.  Returns a list."""
    datas = list(datas)
    td = _st().dtype
    if td is None:
        return datas
    if op_name in _TARGET_OPS:
        return _cast_floats(datas, td)
    if op_name in _FP32_OPS:
        return _cast_floats(datas, torch.float32)
    if op_name in _WIDEST_OPS:
        dts = [d.dtype for d in datas if _is_float(d)]
        if torch.float32 in dts and any(dt != torch.float32 for dt in dts):
            return _cast_floats(datas, torch.float32)
    return datas


# ----------------------------------------------------------------------
# Trainer integration (fp16 loss scaling)
# ----------------------------------------------------------------------

def init_trainer(trainer, loss_scaler=None):
    """Attach dynamic loss scaling to a ``Trainer``."""
    trainer._amp_loss_scaler = loss_scaler or LossScaler()
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield the loss times the trainer's loss scale, for backward."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the gradients by the loss scale in place, and mark the
    trainer so that ``step()`` does not divide a second time."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            g = p._data.grad if p._data is not None else None
            if g is not None:
                g.mul_(inv)
    trainer._amp_unscaled = True


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None):
    """The block, set up for mixed precision.  The port runs eagerly and
    its casts are the op namespace's policy, so converting is activating
    the policy."""
    init(target_dtype)
    return block
