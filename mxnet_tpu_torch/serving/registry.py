"""Multi-tenant model registry: name -> generative servable (counterpart
of ``mxnet_tpu/serving/registry.py``; the fixed-shape ``register`` path
and its compile cache are not ported yet).

::

    reg = ModelRegistry()
    reg.register_generative("gpt", model, params=params)
    tokens = reg.generate("gpt", [3, 7, 1], 16).tokens()
    reg.shutdown(drain=True)
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from ..context import resolve_device
from .batcher import ServableClosed

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """Name -> servable store; the multi-tenant serving surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._servables = {}

    # -- registration ---------------------------------------------------
    def register_generative(self, name, model, params=None,
                            checkpoint=None, prefill_buckets=None,
                            decode_buckets=None,
                            block_size=None, num_blocks=None,
                            max_queue=None, warmup=True,
                            kv_dtype="float32", device=None):
        """Deploy an autoregressive decoder as a generative servable.

        ``model`` is the pure-function spec
        (:class:`~mxnet_tpu_torch.serving.decode.TinyGPT`-shaped);
        weights come from ``params=``, a flat name->array dict (tensors
        or numpy arrays), moved to ``device`` (CUDA unless ``"cpu"``).
        Registration warms every prefill and decode bucket, then
        installs; re-registering a name swaps mid-decode safely -- the
        old engine drains its half-generated sequences to completion
        while the replacement takes new requests.
        """
        from .decode.convert import params_from_numpy
        from .decode.engine import DecodeEngine, GenerativeServable
        if checkpoint is not None:
            raise MXNetError("register_generative: checkpoint= is not yet "
                             "ported; pass params=")
        if params is None:
            raise MXNetError("register_generative needs params=")
        dev = resolve_device(device)
        engine = DecodeEngine(model, params_from_numpy(params, dev),
                              prefill_buckets=prefill_buckets,
                              decode_buckets=decode_buckets,
                              block_size=block_size,
                              num_blocks=num_blocks,
                              max_queue=max_queue, label=name,
                              kv_dtype=kv_dtype, device=dev)
        if warmup:
            engine.warmup()
        engine.start()
        servable = GenerativeServable(name, engine)
        with self._lock:
            old = self._servables.get(name)
            self._servables[name] = servable
        if old is not None:
            # drain=True keeps STEPPING the old engine until every
            # half-generated sequence finishes on the old weights
            old.close(drain=True)
        return servable

    # -- lookup / client ------------------------------------------------
    def servable(self, name):
        with self._lock:
            s = self._servables.get(name)
        if s is None:
            raise MXNetError("serving: no servable %r (registered: %s)"
                             % (name, self.names()))
        return s

    def names(self):
        with self._lock:
            return sorted(self._servables)

    def generate(self, name, prompt, max_new_tokens, eos_id=None,
                 timeout=None):
        """Stream generated tokens from the named generative servable
        (a :class:`~mxnet_tpu_torch.serving.decode.GenerationStream`).
        A hot swap between lookup and admission closes the old handle;
        the replacement is installed by then, so the lookup retries
        against it."""
        for _ in range(8):
            s = self.servable(name)
            if not hasattr(s, "generate"):
                raise MXNetError("serving: servable %r (source=%r) is "
                                 "not generative" % (name, s.source))
            try:
                return s.generate(prompt, max_new_tokens,
                                  eos_id=eos_id, timeout=timeout)
            except ServableClosed:
                with self._lock:
                    cur = self._servables.get(name)
                if cur is None or cur is s:
                    raise               # really closed, not swapped
        raise ServableClosed(
            "serving: servable %r kept closing mid-generate (flapping "
            "re-registration?)" % name)

    # -- lifecycle ------------------------------------------------------
    def unregister(self, name, drain=True):
        with self._lock:
            s = self._servables.pop(name, None)
        if s is None:
            raise MXNetError("serving: no servable %r" % name)
        s.close(drain=drain)

    def shutdown(self, drain=True):
        """Close every servable (draining by default)."""
        with self._lock:
            servables = list(self._servables.values())
            self._servables.clear()
        for s in servables:
            s.close(drain=drain)

    def __contains__(self, name):
        with self._lock:
            return name in self._servables

    def __len__(self):
        with self._lock:
            return len(self._servables)
