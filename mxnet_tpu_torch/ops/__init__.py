"""The port's operator namespace -- the ``F`` a block's
``hybrid_forward(F, x, ...)`` receives (counterpart of
``mxnet_tpu.ndarray``'s registered ops).  Kernel bodies and their plain
PyTorch versions live in the kernel modules (``kernels.*``) and in
``ops.paged_attention`` and ``ops.fused_bn_relu``.

This namespace is the port's AMP chokepoint, as ``ndarray.invoke`` is
the JAX package's: every op here whose name is on one of
:mod:`mxnet_tpu_torch.amp.lists` casts its inputs by the active policy
(:func:`mxnet_tpu_torch.amp.apply_op_casts`) before it runs."""
import functools

from .. import amp as _amp
from .nn import (Activation, BatchNorm, Convolution, Dropout, Embedding,
                 Flatten, FullyConnected, LayerNorm, Pooling,
                 fused_batch_norm_relu, log_softmax, pick, slice_axis,
                 softmax_cross_entropy)
from .optimizer_ops import (lamb_update_phase1, lamb_update_phase2,
                            lars_update, sgd_mom_update, sgd_update)
from .transformer import flash_attention, flash_attention_masked

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "Embedding",
           "Flatten", "FullyConnected", "LayerNorm", "Pooling",
           "flash_attention", "flash_attention_masked",
           "fused_batch_norm_relu", "lamb_update_phase1",
           "lamb_update_phase2", "lars_update", "log_softmax", "pick",
           "sgd_mom_update", "sgd_update", "slice_axis",
           "softmax_cross_entropy"]


def _with_amp_casts(name, fn):
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if _amp.is_active():
            cast = _amp.apply_op_casts(name, list(args)
                                       + list(kwargs.values()))
            args = cast[:len(args)]
            kwargs = dict(zip(kwargs, cast[len(args):]))
        return fn(*args, **kwargs)
    return op


for _name in sorted(_amp.LISTED_OPS.intersection(__all__)):
    globals()[_name] = _with_amp_casts(_name, globals()[_name])
