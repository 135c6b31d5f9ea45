"""Per-bucket executor pool (counterpart of
``mxnet_tpu/serving/executor.py``).

A servable forward is one function ``fn(x) -> tuple(outputs)`` over a
padded batch whose size is one of a fixed set of buckets.  The JAX
package compiles one executable per bucket ahead of time; the port runs
each bucket as one eager forward in inference mode (``autograd`` not
recording, ``is_training()`` false, under ``torch.inference_mode()``).
:meth:`BucketExecutorPool.warmup` runs every bucket once on zeros, so
cuDNN's algorithm choice, the hand kernels' build and the allocator's
first growth happen before any request.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError

__all__ = ["BucketExecutorPool"]


class BucketExecutorPool:
    """Eager forwards over padded batch buckets on one device.

    Parameters
    ----------
    fn : callable ``(x tensor) -> tuple(tensors)``
    input_shape : per-sample shape (no batch dim)
    dtype : input dtype
    buckets : batch-size buckets; requests pad to the smallest bucket
        that fits
    device : the ``torch.device`` the forward runs on
    """

    def __init__(self, fn, input_shape, dtype, buckets, device):
        self._fn = fn
        self.input_shape = tuple(int(s) for s in input_shape)
        self.dtype = np.dtype(dtype)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("serving: buckets must be positive ints, "
                             "got %r" % (buckets,))
        self.device = device
        self._warm = set()
        self._num_outputs = None

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
        return sorted(self._warm)

    def device_scope(self):
        """Make the pool's card current (a no-op on the CPU): the
        batcher's worker thread runs inside it."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, self.dtype))
        with torch.inference_mode(), autograd.pause(train_mode=False), \
                self.device_scope():
            outs = self._fn(x.to(self.device))
        if self._num_outputs is None:
            self._num_outputs = len(outs)
        return outs

    def warmup(self):
        """Run every bucket once on zeros; returns the seconds it
        took."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self._run(np.zeros((b,) + self.input_shape, self.dtype))
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def call(self, bucket, x):
        """Run the forward on a batch ``x`` already padded to
        ``bucket`` (a host array or a tensor); returns the output
        tuple, on the device."""
        if bucket not in self.buckets:
            raise MXNetError("serving: %d is not a bucket of %r"
                             % (bucket, self.buckets))
        if tuple(x.shape) != (bucket,) + self.input_shape:
            raise MXNetError("serving: batch of shape %r for bucket %d"
                             % (tuple(x.shape), bucket))
        return self._run(x)

    @property
    def num_outputs(self):
        return self._num_outputs
