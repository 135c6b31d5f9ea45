"""``mxnet_tpu_torch.serving`` -- the generative serving tier on PyTorch
(``ModelRegistry.register_generative`` / ``generate`` over the
:mod:`.decode` engine)."""
from .batcher import RequestTimeout, ServableClosed, ServingQueueFull
from .registry import ModelRegistry

__all__ = ["ModelRegistry", "RequestTimeout", "ServableClosed",
           "ServingQueueFull"]
