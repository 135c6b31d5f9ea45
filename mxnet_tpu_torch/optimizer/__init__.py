"""Optimizers (counterpart of ``mxnet_tpu.optimizer``): SGD with
momentum and LAMB; the others come with their slices."""
from .optimizer import (LAMB, SGD, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["LAMB", "SGD", "Optimizer", "Updater", "create", "get_updater",
           "register"]
