"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
the control-flow constructs ``foreach``, ``while_loop`` and ``cond`` on
NDArrays (:mod:`..ops.control_flow`: one tape node each, gradients
through their explicit operands only, nothing read back to the host),
and the JAX package's contrib ops under their nested names -- the same
functions as the flat ``mx.nd`` ones."""
import sys as _sys

import numpy as _np
import torch as _torch

from ..ops import control_flow as _cf
from . import register as _register
from .ndarray import NDArray

__all__ = ["cond", "foreach", "while_loop"]

# the JAX package's list, in its order
_NAMES = ("box_iou", "box_nms", "ROIAlign", "ROIPooling", "quantize",
          "quantize_v2", "dequantize", "requantize",
          "quantized_fully_connected", "CTCLoss", "ctc_loss", "im2col",
          "col2im", "interleaved_matmul_selfatt_qk",
          "interleaved_matmul_selfatt_valatt",
          "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
          "flash_attention")


def _unbox(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, _torch.Tensor):
        return x
    return _torch.as_tensor(_np.asarray(x, _np.float32))


def foreach(body, data, init_states):
    """Scan ``body(data_t, states) -> (out_t, states)`` over the leading
    axis of ``data``; returns (stacked outputs, final states)."""
    return _cf.foreach(body, data, init_states, box=NDArray, unbox=_unbox)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*vars) -> (out, vars)`` while ``cond(*vars)``, as
    ``max_iterations`` masked steps; outputs after the stop are zero."""
    return _cf.while_loop(cond, func, loop_vars, max_iterations,
                          box=NDArray, unbox=_unbox)


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` else ``else_func(*inputs)``,
    selected on the device."""
    return _cf.cond(pred, then_func, else_func, inputs, box=NDArray,
                    unbox=_unbox)


def _export():
    ns = _register.populate({})
    mod = _sys.modules[__name__]
    for name in _NAMES:
        setattr(mod, name, ns[name])


_export()
