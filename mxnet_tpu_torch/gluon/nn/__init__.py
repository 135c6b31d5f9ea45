"""Gluon layers of the training slice (counterpart of
``mxnet_tpu/gluon/nn``)."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Flatten, HybridSequential,
                           Sequential)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "MaxPool2D",
           "Sequential"]
