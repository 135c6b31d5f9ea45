"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the ResNet
family."""
from . import vision

__all__ = ["vision"]
