"""The port's operator namespace -- the ``F`` a block's
``hybrid_forward(F, x, ...)`` receives (counterpart of
``mxnet_tpu.ndarray``'s registered ops).  Kernel bodies and their plain
PyTorch versions live in the kernel modules (``kernels.*``) and in
``ops.paged_attention`` and ``ops.fused_bn_relu``."""
from .nn import (Activation, BatchNorm, Convolution, Dropout, Embedding,
                 Flatten, FullyConnected, LayerNorm, Pooling,
                 fused_batch_norm_relu, log_softmax, pick, slice_axis,
                 softmax_cross_entropy)
from .optimizer_ops import (lamb_update_phase1, lamb_update_phase2,
                            sgd_mom_update, sgd_update)
from .transformer import flash_attention, flash_attention_masked

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "Embedding",
           "Flatten", "FullyConnected", "LayerNorm", "Pooling",
           "flash_attention", "flash_attention_masked",
           "fused_batch_norm_relu", "lamb_update_phase1",
           "lamb_update_phase2", "log_softmax", "pick", "sgd_mom_update",
           "sgd_update", "slice_axis", "softmax_cross_entropy"]
