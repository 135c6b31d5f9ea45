"""``mxnet_tpu_torch.serving`` -- the serving tier on PyTorch
(counterpart of ``mxnet_tpu/serving``):

- the fixed-shape tier: ``ModelRegistry.register(block=, checkpoint=,
  symbol=, onnx=)`` -> :class:`DynamicBatcher` ->
  :class:`BucketExecutorPool`, one captured CUDA graph per padded batch
  bucket on the card (a ``symbol=``/``params=`` pair or an ``onnx=``
  file is loaded as a ``SymbolBlock``);
- the generative tier: ``ModelRegistry.register_generative`` /
  ``generate`` over the :mod:`.decode` engine;
- the always-on loop (``loop.py``): :class:`ContinuousTrainer` publishes
  atomic checkpoints while :class:`RegistryWatcher` (and, for a
  decoder, :class:`GenerativeWatcher`) discovers each new verified step
  and hot-swaps the servable with zero dropped requests.

The exports are the JAX package's, less its ``CompileCache`` and
``stablehlo_fingerprint``: CUDA graphs have no portable serialized form
to cache, and there is no StableHLO (ROADMAP, port conventions).
"""
from .batcher import (DynamicBatcher, RequestTimeout, ServableClosed,
                      ServingQueueFull)
from .decode import (DecodeEngine, GenerationStream, GenerativeServable,
                     GenerativeWatcher, KVCacheExhausted, PagedKVCache,
                     TinyGPT, tiny_gpt)
from .executor import BucketExecutorPool
from .loop import ContinuousTrainer, RegistryWatcher
from .registry import ModelRegistry, Servable

__all__ = [
    "ModelRegistry", "Servable", "DynamicBatcher", "BucketExecutorPool",
    "ContinuousTrainer", "RegistryWatcher",
    "ServingQueueFull", "RequestTimeout", "ServableClosed",
    "DecodeEngine", "GenerationStream", "GenerativeServable",
    "GenerativeWatcher", "KVCacheExhausted", "PagedKVCache",
    "TinyGPT", "tiny_gpt",
]
