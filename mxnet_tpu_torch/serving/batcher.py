"""Serving error types (counterpart of the exceptions of
``mxnet_tpu/serving/batcher.py``; its dynamic batcher is not ported
yet)."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingQueueFull", "RequestTimeout", "ServableClosed"]


class ServingQueueFull(MXNetError):
    """Submit rejected: the bounded request queue is at capacity, or the
    KV cache cannot cover the request (the load-shedding contract --
    back off or scale out)."""


class RequestTimeout(MXNetError):
    """The request's deadline passed while it was still queued."""


class ServableClosed(MXNetError):
    """Submit rejected: the servable is closed or draining."""
