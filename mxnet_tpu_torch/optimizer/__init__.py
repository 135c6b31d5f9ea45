"""Optimizers (counterpart of ``mxnet_tpu.optimizer``): SGD with
momentum; the others come with their slices."""
from .optimizer import (SGD, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["SGD", "Optimizer", "Updater", "create", "get_updater",
           "register"]
