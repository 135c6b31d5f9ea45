"""Optimizers and learning-rate schedulers (counterpart of
``mxnet_tpu.optimizer``): every optimizer of the JAX package's
registry, the four schedulers, multi-precision fp16 updates and the
:class:`Updater`."""
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import (LAMB, LARS, NAG, SGD, AdaGrad, Adam, AdamW, Ftrl,
                        Optimizer, RMSProp, Signum, Updater, create,
                        get_updater, register)

__all__ = ["LAMB", "LARS", "NAG", "SGD", "AdaGrad", "Adam", "AdamW",
           "CosineScheduler", "FactorScheduler", "Ftrl", "LRScheduler",
           "MultiFactorScheduler", "Optimizer", "PolyScheduler", "RMSProp",
           "Signum", "Updater", "create", "get_updater", "lr_scheduler",
           "register"]
