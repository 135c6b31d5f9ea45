"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters,
layers, losses, the Trainer, ``data`` (datasets, samplers, DataLoader,
vision), the ResNet and BERT model zoo and the recurrent layers and
cells (``rnn``), and ``SymbolBlock`` to run an exported graph."""
from . import data, loss, model_zoo, nn, rnn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "Constant", "DeferredInitializationError", "HybridBlock",
           "Parameter", "ParameterDict", "SymbolBlock", "Trainer", "data",
           "loss", "model_zoo", "nn", "rnn"]
