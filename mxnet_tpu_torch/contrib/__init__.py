"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib``)."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
