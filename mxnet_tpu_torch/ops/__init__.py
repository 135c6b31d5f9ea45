"""The port's operator namespace -- the ``F`` a block's
``hybrid_forward(F, x, ...)`` receives -- and the op table behind
``mx.nd.*`` (counterpart of ``mxnet_tpu.ndarray``'s registered ops).
Kernel bodies and their plain PyTorch versions live in the kernel
modules (``kernels.*``) and in ``ops.paged_attention`` and
``ops.fused_bn_relu``; the tensor ops of ``mx.nd`` in ``ops.tensor`` and
``ops.random_ops``, entered with the layer ops below into
:data:`~.table.TABLE`.

This module is the port's AMP chokepoint, as ``ndarray.invoke`` is the
JAX package's: every table entry whose name is on one of
:mod:`mxnet_tpu_torch.amp.lists` has its function wrapped here, once, to
cast its inputs by the active policy
(:func:`mxnet_tpu_torch.amp.apply_op_casts`) before it runs; a listed op
of this namespace is that same wrapped function."""
import functools

from .. import amp as _amp
from . import random_ops, table, tensor  # noqa: F401 -- fill the table
from .nn import (Activation, BatchNorm, Convolution, Dropout, Embedding,
                 Flatten, FullyConnected, LayerNorm, Pooling,
                 fused_batch_norm_relu, log_softmax, pick, slice_axis,
                 softmax, softmax_cross_entropy)
from .optimizer_ops import (lamb_update_phase1, lamb_update_phase2,
                            lars_update, sgd_mom_update, sgd_update)
from .transformer import (attention_reference, flash_attention,
                          flash_attention_masked)

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "Embedding",
           "Flatten", "FullyConnected", "LayerNorm", "Pooling",
           "attention_reference", "flash_attention", "flash_attention_masked",
           "fused_batch_norm_relu", "lamb_update_phase1",
           "lamb_update_phase2", "lars_update", "log_softmax", "pick",
           "sgd_mom_update", "sgd_update", "slice_axis", "softmax",
           "softmax_cross_entropy", "table"]

# the layer ops of mx.nd, under the JAX package's names and arguments
for _name, _args, _aliases in (
        ("Activation", ("data",), ()),
        ("Convolution", ("data", "weight", "bias"), ()),
        ("Dropout", ("data",), ()),
        ("Embedding", ("data", "weight"), ()),
        ("FullyConnected", ("data", "weight", "bias"), ()),
        ("LayerNorm", ("data", "gamma", "beta"), ()),
        ("Pooling", ("data",), ()),
        ("log_softmax", ("data",), ()),
        ("softmax", ("data",), ("SoftmaxActivation",)),
        ("softmax_cross_entropy", ("data", "label"), ())):
    table.register(_name, args=_args, aliases=_aliases)(globals()[_name])


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


# one wrapping: each listed table entry, and the namespace global that
# the layer ops above registered as that entry, share the cast function
for _spec in table.TABLE.values():
    if _spec.name in _amp.LISTED_OPS:
        _spec.fn = _with_amp_casts(_spec.name, _spec.fn)
        if _spec.name in __all__:
            globals()[_spec.name] = _spec.fn
