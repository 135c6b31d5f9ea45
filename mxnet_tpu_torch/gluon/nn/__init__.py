"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``), with
``SymbolBlock`` (an exported graph run as a block)."""
from ..block import Block, HybridBlock, SymbolBlock
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU, PReLU,
                          Swish)
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential,
                           SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          MaxPool1D, MaxPool2D, MaxPool3D, ReflectionPad2D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "Block", "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Dense", "Dropout", "ELU", "Embedding", "Flatten",
           "GELU", "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GroupNorm", "HybridBlock", "HybridLambda", "HybridSequential",
           "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "MultiHeadAttention", "PReLU",
           "PositionwiseFFN", "ReflectionPad2D", "SELU", "Sequential",
           "SymbolBlock",
           "Swish", "SyncBatchNorm", "TransformerEncoder",
           "TransformerEncoderCell"]
