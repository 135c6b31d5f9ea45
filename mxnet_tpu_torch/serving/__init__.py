"""``mxnet_tpu_torch.serving`` -- the serving tier on PyTorch
(counterpart of ``mxnet_tpu/serving``):

- the fixed-shape tier: ``ModelRegistry.register(block=, checkpoint=)``
  -> :class:`DynamicBatcher` -> :class:`BucketExecutorPool`, one eager
  inference forward per padded batch bucket;
- the generative tier: ``ModelRegistry.register_generative`` /
  ``generate`` over the :mod:`.decode` engine.

The JAX package's compile cache and StableHLO fingerprints, ``symbol=``
and ``onnx=`` sources, ``RegistryWatcher`` and telemetry are not ported
yet.
"""
from .batcher import (DynamicBatcher, RequestTimeout, ServableClosed,
                      ServingQueueFull)
from .executor import BucketExecutorPool
from .registry import ModelRegistry, Servable

__all__ = ["BucketExecutorPool", "DynamicBatcher", "ModelRegistry",
           "RequestTimeout", "Servable", "ServableClosed",
           "ServingQueueFull"]
