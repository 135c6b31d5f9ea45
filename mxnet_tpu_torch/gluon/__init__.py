"""Gluon, the training slices (counterpart of ``mxnet_tpu/gluon``):
blocks, parameters, layers, losses, the Trainer and the ResNet and BERT
model zoo."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "DeferredInitializationError", "HybridBlock",
           "Parameter", "ParameterDict", "Trainer", "loss", "model_zoo",
           "nn"]
