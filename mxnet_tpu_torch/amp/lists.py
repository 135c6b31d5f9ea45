"""AMP cast lists (the port's own copy of ``mxnet_tpu/amp/lists.py``).

Names are the JAX package's op names.  An op on none of the lists runs
in whatever dtype its inputs already have.  The port's op namespace
(:mod:`mxnet_tpu_torch.ops`) applies the casts to every op it holds
under one of these names.
"""

# Products that run on the tensor cores: inputs cast to the target dtype.
TARGET_DTYPE_OPS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "matmul",
    "einsum",
    "tensordot",
    "RNN",
]

# Ops kept in float32 for range and precision (softmax, reductions,
# losses).  BatchNorm and LayerNorm are not here: they keep fp32
# statistics internally and return the activation dtype.
FP32_OPS = [
    "L2Normalization",
    "softmax",
    "log_softmax",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "norm",
    "mean",
    "sum",
    "prod",
    "_np_var",
    "_np_std",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "erf",
    "erfinv",
    "gamma",
    "gammaln",
    "smooth_l1",
    "MakeLoss",
    "LinearRegressionOutput",
    "LogisticRegressionOutput",
    "MAERegressionOutput",
]

# Multi-input elementwise ops: every float input cast to fp32 when fp32
# meets a narrower float.
WIDEST_TYPE_CASTS = [
    "elemwise_add",
    "elemwise_sub",
    "elemwise_mul",
    "elemwise_div",
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "broadcast_mod",
    "broadcast_power",
    "broadcast_maximum",
    "broadcast_minimum",
    "broadcast_hypot",
    "Concat",
    "concat",
    "stack",
    "where",
    "maximum",
    "minimum",
    "add_n",
]
