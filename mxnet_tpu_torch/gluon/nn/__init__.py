"""Gluon layers of the training slices (counterpart of
``mxnet_tpu/gluon/nn``)."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridSequential, LayerNorm, Sequential)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool2D", "HybridSequential",
           "LayerNorm", "MaxPool2D", "MultiHeadAttention", "PositionwiseFFN",
           "Sequential", "TransformerEncoder", "TransformerEncoderCell"]
