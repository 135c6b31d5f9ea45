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
from ..base import MXNetError
from . import contrib_ops, linalg, random_ops, table, tensor  # noqa: F401
from . import control_flow
from .contrib_ops import CTCLoss, col2im, im2col
from .nn import (Activation, BatchNorm, BilinearResize2D, Convolution,
                 Deconvolution, Dropout, Embedding, Flatten, FullyConnected,
                 GroupNorm, InstanceNorm, LayerNorm, LeakyReLU,
                 LinearRegressionOutput, LogisticRegressionOutput,
                 MAERegressionOutput, MakeLoss, Pooling, RNN,
                 SoftmaxOutput, UpSampling, fused_batch_norm_relu, log_softmax, moments,
                 pick, prelu, slice_axis, smooth_l1, softmax,
                 softmax_cross_entropy, softmin)
from .optimizer_ops import (lamb_update_phase1, lamb_update_phase2,
                            lars_update, sgd_mom_update, sgd_update)
from .registry import OP_REGISTRY, Op, OpParam, get_op, list_ops, register
from .transformer import (attention_reference, flash_attention,
                          flash_attention_masked)

__all__ = ["Activation", "BatchNorm", "BilinearResize2D", "CTCLoss",
           "Convolution", "Deconvolution", "Dropout", "Embedding", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "LinearRegressionOutput", "LogisticRegressionOutput",
           "MAERegressionOutput", "MakeLoss", "OP_REGISTRY", "Op", "OpParam",
           "Pooling", "RNN", "SoftmaxOutput",
           "UpSampling", "attention_reference", "col2im", "flash_attention",
           "flash_attention_masked", "fused_batch_norm_relu", "get_op",
           "im2col", "lamb_update_phase1", "lamb_update_phase2",
           "lars_update", "list_ops", "log_softmax", "moments", "pick",
           "prelu", "register", "sgd_mom_update", "sgd_update", "slice_axis",
           "smooth_l1", "softmax", "softmax_cross_entropy", "softmin",
           "table"]

_BN_ARGS = ("data", "gamma", "beta", "moving_mean", "moving_var")
# the layer ops of mx.nd, under the JAX package's names and arguments
for _name, _fn, _args, _aliases, _variadic in (
        ("Activation", Activation, ("data",), (), False),
        ("BatchNorm", BatchNorm, _BN_ARGS, (), False),
        ("BilinearResize2D", BilinearResize2D, ("data",), (), False),
        ("Convolution", Convolution, ("data", "weight", "bias"), (), False),
        ("Deconvolution", Deconvolution, ("data", "weight", "bias"), (),
         False),
        ("Dropout", Dropout, ("data",), (), False),
        ("Embedding", Embedding, ("data", "weight"), (), False),
        ("FullyConnected", FullyConnected, ("data", "weight", "bias"), (),
         False),
        ("GroupNorm", GroupNorm, ("data", "gamma", "beta"), (), False),
        ("InstanceNorm", InstanceNorm, ("data", "gamma", "beta"), (), False),
        ("LayerNorm", LayerNorm, ("data", "gamma", "beta"), (), False),
        ("LeakyReLU", LeakyReLU, ("data", "gamma"), (), False),
        ("LinearRegressionOutput", LinearRegressionOutput,
         ("data", "label"), (), False),
        ("LogisticRegressionOutput", LogisticRegressionOutput,
         ("data", "label"), (), False),
        ("MAERegressionOutput", MAERegressionOutput, ("data", "label"), (),
         False),
        ("MakeLoss", MakeLoss, ("data",), ("make_loss",), False),
        ("Pooling", Pooling, ("data",), (), False),
        ("RNN", RNN, ("data", "parameters", "state", "state_cell"), (),
         False),
        ("SoftmaxOutput", SoftmaxOutput, ("data", "label"), (), False),
        ("UpSampling", UpSampling, ("data",), (), True),
        ("_prelu", prelu, ("data", "gamma"), (), False),
        ("flash_attention", flash_attention, ("q", "k", "v"), (), False),
        ("flash_attention_masked", flash_attention_masked,
         ("q", "k", "v", "mask"), (), False),
        ("fused_batch_norm_relu", fused_batch_norm_relu, _BN_ARGS, (),
         False),
        ("log_softmax", log_softmax, ("data",), (), False),
        ("moments", moments, ("data",), (), False),
        ("smooth_l1", smooth_l1, ("data",), (), False),
        ("softmax", softmax, ("data",), ("SoftmaxActivation",), False),
        ("softmax_cross_entropy", softmax_cross_entropy, ("data", "label"),
         (), False),
        ("softmin", softmin, ("data",), (), False)):
    table.register(_name, args=_args, aliases=_aliases,
                   variadic=_variadic)(_fn)


class _Contrib:
    """``F.contrib`` of a ``hybrid_forward`` (the JAX package's ``F`` is
    ``mx.nd``, whose ``contrib`` this mirrors on tensors): the
    control-flow constructs and the contrib ops of the table."""

    foreach = staticmethod(control_flow.foreach)
    while_loop = staticmethod(control_flow.while_loop)
    cond = staticmethod(control_flow.cond)

    def __getattr__(self, name):
        return table.lookup(name).fn


contrib = _Contrib()


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


def __getattr__(name):
    """Every other op of the table under its ``mx.nd`` name or alias,
    as the ``F`` of a ``hybrid_forward`` (``F.Concat``, ``F.clip``,
    ``F.sigmoid``): the table's function on tensors."""
    try:
        return table.lookup(name).fn
    except MXNetError:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name)) from None
