"""Optimizers (counterpart of ``mxnet_tpu.optimizer``): SGD with
momentum, LARS and LAMB; the others come with their slices."""
from .optimizer import (LAMB, LARS, SGD, Optimizer, Updater, create,
                        get_updater, register)

__all__ = ["LAMB", "LARS", "SGD", "Optimizer", "Updater", "create",
           "get_updater", "register"]
