"""Per-bucket executor pool (counterpart of
``mxnet_tpu/serving/executor.py``).

A servable forward is one function ``fn(x) -> tuple(outputs)`` over a
padded batch whose size is one of a fixed set of buckets, run in
inference mode (``autograd`` not recording, ``is_training()`` false,
under ``torch.inference_mode()``).  The JAX package compiles one
executable per bucket ahead of time (``serving/cache.py ::
CompileCache``); the port's counterpart on the card is one captured CUDA
graph per bucket, all in one memory pool (:mod:`.._capture`):
:meth:`BucketExecutorPool.warmup` runs every bucket once on zeros on the
capture stream (cuDNN's algorithm choice, the hand kernels' build and
the allocator's growth happen there) and captures it.  :meth:`call`
copies the padded batch into the bucket's static input, replays the
graph and returns copies of its outputs, which the next call does not
overwrite.  A bucket whose parameters were rebound since capture (the
pool's ``watch``) is captured again.  On the CPU a bucket runs eagerly.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .. import _capture
from .. import autograd
from ..base import MXNetError

__all__ = ["BucketExecutorPool"]


class BucketExecutorPool:
    """Forwards over padded batch buckets on one device: captured
    graphs on the card, eager calls on the CPU.

    Parameters
    ----------
    fn : callable ``(x tensor) -> tuple(tensors)``
    input_shape : per-sample shape (no batch dim)
    dtype : input dtype
    buckets : batch-size buckets; requests pad to the smallest bucket
        that fits
    device : the ``torch.device`` the forward runs on
    watch : callable returning the tensors ``fn`` reads that may be
        rebound (the block's parameters); a rebound one makes its
        bucket's graph capture again
    """

    def __init__(self, fn, input_shape, dtype, buckets, device,
                 watch=None):
        self._fn = fn
        self.input_shape = tuple(int(s) for s in input_shape)
        self.dtype = np.dtype(dtype)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("serving: buckets must be positive ints, "
                             "got %r" % (buckets,))
        self.device = device
        self._watch = watch or (lambda: ())
        self._num_outputs = None
        self._owner = _capture.GraphOwner("BucketExecutorPool", device)
        self._lock = threading.Lock()

    @property
    def max_bucket(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket that holds ``n`` samples."""
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError("serving: batch of %d exceeds the largest "
                         "bucket %d" % (n, self.max_bucket))

    def warm_buckets(self):
        return sorted(self._owner.keys())

    def capture_stats(self):
        """Graphs captured, seconds capturing, pool bytes, replays."""
        return self._owner.stats()

    def device_scope(self):
        """Make the pool's card current (a no-op on the CPU): the
        batcher's worker thread runs inside it."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _as_tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, self.dtype))
        return x

    def _forward(self, x):
        with torch.inference_mode(), autograd.pause(train_mode=False):
            outs = tuple(self._fn(x))
        if self._num_outputs is None:
            self._num_outputs = len(outs)
        return outs

    def _run(self, bucket, x):
        return self._owner.run(bucket, self._forward, [x], self._watch(),
                               "bucket %d" % bucket)

    def warmup(self):
        """Run every bucket once on zeros and, on the card, capture and
        replay its graph; returns the seconds it took."""
        t0 = time.perf_counter()
        with self.device_scope(), self._lock:
            for b in self.buckets:
                zeros = torch.zeros((b,) + self.input_shape,
                                    dtype=getattr(torch, self.dtype.name),
                                    device=self.device)
                for _ in range(2 if self._owner.cuda else 1):
                    self._run(b, zeros)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def call(self, bucket, x):
        """Run the forward on a batch ``x`` already padded to
        ``bucket`` (a host array or a tensor); returns the output
        tuple, on the device, which the next call does not
        overwrite."""
        if bucket not in self.buckets:
            raise MXNetError("serving: %d is not a bucket of %r"
                             % (bucket, self.buckets))
        if tuple(x.shape) != (bucket,) + self.input_shape:
            raise MXNetError("serving: batch of shape %r for bucket %d"
                             % (tuple(x.shape), bucket))
        with self.device_scope(), self._lock:
            return self._run(bucket, self._as_tensor(x))

    @property
    def num_outputs(self):
        return self._num_outputs
