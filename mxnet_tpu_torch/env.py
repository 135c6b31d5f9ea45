"""Typed registry of the ``MXNET_*`` environment variables the port reads.

Counterpart of ``mxnet_tpu/env.py``, holding only the variables the
port reads: checkpoints, serving, the numerics sentinel and the device
feed.  Names, defaults and the boolean convention (only ``"0"`` is
false) are the JAX package's, so one environment configures both.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

from .base import MXNetError

__all__ = ["EnvVar", "REGISTRY", "get"]


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: Callable
    default: Any
    doc: str

    def read(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            if self.type is bool:
                return raw != "0"
            return self.type(raw)
        except (TypeError, ValueError) as e:
            raise MXNetError("env var %s=%r is not a valid %s"
                             % (self.name, raw, self.type.__name__)) from e


_VARS = [
    EnvVar("MXNET_TPU_CKPT_ASYNC", bool, False,
           "'1' makes CheckpointManager saves asynchronous by default: "
           "the state is copied to host memory at save(), then "
           "serialized and committed on a background thread.  "
           "Per-manager override: CheckpointManager(async_save=...)."),
    EnvVar("MXNET_TPU_CKPT_MAX_TO_KEEP", int, 0,
           "Default retention for CheckpointManager: keep at most this "
           "many step checkpoints (steps matching keep_every_n_steps "
           "are exempt).  0 keeps everything."),
    EnvVar("MXNET_TPU_SERVING_BUCKETS", str, "1,2,4,8,16,32",
           "Default padded batch buckets of a fixed-shape servable: a "
           "micro-batch of n requests pads to the smallest bucket >= n; "
           "every bucket is warmed at registration.  Per-servable "
           "override: ModelRegistry.register(buckets=...)."),
    EnvVar("MXNET_TPU_SERVING_MAX_WAIT_MS", float, 5.0,
           "Micro-batch assembly deadline (milliseconds): a batch "
           "dispatches when the largest bucket fills or the oldest "
           "queued request has waited this long.  Per-servable "
           "override: ModelRegistry.register(max_wait_ms=...)."),
    EnvVar("MXNET_TPU_SERVING_QUEUE", int, 256,
           "Bounded request-queue depth per servable; a submit against "
           "a full queue raises ServingQueueFull."),
    EnvVar("MXNET_TPU_SERVING_KV_BLOCK", int, 16,
           "Tokens per KV-cache block.  Per-model override: "
           "register_generative(block_size=...)."),
    EnvVar("MXNET_TPU_SERVING_KV_BLOCKS", int, 512,
           "Preallocated KV-cache blocks per generative servable "
           "(block 0 is the scratch block).  Per-model override: "
           "register_generative(num_blocks=...)."),
    EnvVar("MXNET_TPU_SERVING_DECODE_BUCKETS", str, "1,2,4,8",
           "Slot-count buckets of the continuous-batching decode step; "
           "the largest bounds concurrent sequences."),
    EnvVar("MXNET_TPU_NUMERICS_CHECK", bool, False,
           "'1' arms the non-finite sentinel (analysis.numerics): "
           "TrainStep reads its step's finite flag once after the step "
           "and, on the first non-finite step, recomputes the gradients "
           "from the kept weights to name WHICH parameter went NaN/Inf, "
           "then raises NonFiniteError.  Off: no host read."),
    EnvVar("MXNET_TPU_SERVING_PREFILL_BUCKETS", str, "16,32,64,128",
           "Prompt-length buckets of prefill (batch 1); the largest is "
           "the longest admissible prompt."),
    EnvVar("MXNET_TPU_FEED_DEPTH", int, 2,
           "Default bounded-queue depth of mx.dataio.DeviceFeed: how "
           "many landed batches the background producer may run ahead "
           "of the consumer (its pinned ring holds one slot more).  2 = "
           "double buffering.  Per-feed override: "
           "DeviceFeed(depth=...)."),
    EnvVar("MXNET_TPU_FEED_COMPACT", bool, True,
           "Ship feed batches to the card in their compact source dtype "
           "(uint8 stays uint8 -- 4x less copy traffic than its float32 "
           "cast) and expand them there with the feed's transform.  "
           "'0' casts on the host to the transform's dtype before the "
           "copy (A/B numerics debugging).  Per-feed override: "
           "DeviceFeed(compact=...)."),
]

REGISTRY = {v.name: v for v in _VARS}


def get(name):
    """Typed read of a registered variable (its default when unset)."""
    try:
        var = REGISTRY[name]
    except KeyError:
        raise MXNetError("unregistered env var %r" % name) from None
    return var.read()
