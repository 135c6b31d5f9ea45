"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters,
layers, losses, the Trainer, ``data`` (datasets, samplers, DataLoader,
vision), the ResNet and BERT model zoo and the recurrent layers and
cells (``rnn``), ``SymbolBlock`` to run an exported graph, and
``contrib`` (``Concurrent``, ``HybridConcurrent``, ``Identity``,
``SparseEmbedding``)."""
from . import data, loss, model_zoo, nn, rnn
from . import contrib
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "Constant", "DeferredInitializationError", "HybridBlock",
           "Parameter", "ParameterDict", "SymbolBlock", "Trainer", "contrib",
           "data", "loss", "model_zoo", "nn", "rnn"]
