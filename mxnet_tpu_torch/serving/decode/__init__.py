"""``mxnet_tpu_torch.serving.decode`` -- the generative serving tier:

- :class:`~.kvcache.PagedKVCache` -- fixed-size blocks carved from
  per-layer K/V slabs on the device, a block table per request;
- :class:`~.engine.DecodeEngine` -- bucketed prefill and decode with
  continuous batching and whole-budget admission;
- :class:`~.engine.GenerativeServable` -- the registry's handle;
- :class:`~.engine.GenerativeWatcher` -- hot-swaps a generative
  servable to each new verified checkpoint step, mid-decode;
- :class:`~.model.TinyGPT` -- a GPT-style decoder in pure-function
  form whose decode step attends through the Hopper ``paged_attention``
  kernel (``kernels.paged_attention``);
- :func:`~.convert.params_from_numpy` -- carries a parameter dict
  across by name.
"""
from .convert import params_from_numpy
from .engine import (DecodeEngine, GenerationStream, GenerativeServable,
                     GenerativeWatcher)
from .kvcache import (SCRATCH_BLOCK, BlockTable, KVCacheExhausted,
                      PagedKVCache)
from .model import TinyGPT, tiny_gpt

__all__ = ["BlockTable", "DecodeEngine", "GenerationStream",
           "GenerativeServable", "GenerativeWatcher", "KVCacheExhausted", "PagedKVCache",
           "SCRATCH_BLOCK", "TinyGPT", "params_from_numpy", "tiny_gpt"]
