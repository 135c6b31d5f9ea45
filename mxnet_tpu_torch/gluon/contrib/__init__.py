"""``gluon.contrib`` (counterpart of ``mxnet_tpu/gluon/contrib``)."""
from . import nn

__all__ = ["nn"]
