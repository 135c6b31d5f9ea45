"""Training steps (counterpart of ``mxnet_tpu.parallel``): the
single-device :class:`TrainStep`."""
from .data_parallel import TrainStep

__all__ = ["TrainStep"]
