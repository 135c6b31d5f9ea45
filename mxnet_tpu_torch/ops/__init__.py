"""The port's operator namespace -- the ``F`` a block's
``hybrid_forward(F, x, ...)`` receives (counterpart of
``mxnet_tpu.ndarray``'s registered ops).  Kernel bodies and their plain
PyTorch versions live in their own modules (``ops.paged_attention``,
``ops.fused_bn_relu``)."""
from .nn import (Activation, BatchNorm, Convolution, Flatten,
                 FullyConnected, Pooling, fused_batch_norm_relu,
                 log_softmax, pick, softmax_cross_entropy)
from .optimizer_ops import sgd_mom_update, sgd_update

__all__ = ["Activation", "BatchNorm", "Convolution", "Flatten",
           "FullyConnected", "Pooling", "fused_batch_norm_relu",
           "log_softmax", "pick", "sgd_mom_update", "sgd_update",
           "softmax_cross_entropy"]
