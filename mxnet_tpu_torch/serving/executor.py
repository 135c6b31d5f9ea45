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

:meth:`BucketExecutorPool.fingerprint` is a stable digest of what a
bucket's graph computes: the block's structure, its parameters' names,
shapes and dtypes, the bucket's input shape and dtype, the backend
settings a capture bakes in and the kernel libraries.  It is equal
across re-registrations of one architecture and differs across buckets
(the JAX package's is a digest of the normalized StableHLO).  CUDA
graphs have no portable serialized form, so there is no compile cache:
every registration captures anew, and with the registry's
``compile_cache`` on every bucket counts a
``serving.compile_cache_misses``.

:meth:`BucketExecutorPool.hbm_plan` predicts each bucket's peak device
memory from the two smallest buckets' warm-ups on the card: what the
bucket's capture allocated at its peak above what was allocated before
it (after the eager run, which makes the libraries' one-time
workspaces), plus the servable's parameter bytes, fit to a const +
per-item line.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time

import numpy as np
import torch

from .. import _build, _capture
from .. import autograd
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["BucketExecutorPool", "device_hbm_bytes"]


def device_hbm_bytes(device):
    """The card's total memory (``torch.cuda.mem_get_info``); None on
    the CPU, where serving skips its memory validation."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


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
    device : the ``torch.device`` the forward runs on (the card unless
        ``"cpu"``)
    watch : callable returning the tensors ``fn`` reads that may be
        rebound (the block's parameters); a rebound one makes its
        bucket's graph capture again
    label : the servable's name (telemetry)
    structure : what :meth:`fingerprint` records of the model (a
        JSON-able description of its structure and parameters)
    param_bytes : the bytes of the parameters ``fn`` reads
        (:meth:`hbm_plan`'s constant)
    compile_cache : count each warmed bucket as a compile-cache miss
    pure_fn, params : the JAX package's form, in place of ``fn``:
        ``pure_fn(params, x) -> tuple(tensors)`` over ``params``
        (``{name: tensor}``), which are then what ``watch``,
        ``structure`` and ``param_bytes`` default to
    cache : the JAX package's compile cache; any value but None turns
        ``compile_cache`` on (there is no cache to keep: a CUDA graph
        has no portable serialized form)
    """

    def __init__(self, fn=None, input_shape=None, dtype="float32",
                 buckets=None, device=None, watch=None, label="servable",
                 structure=None, param_bytes=0, compile_cache=False, *,
                 pure_fn=None, params=None, cache=None):
        if (fn is None) == (pure_fn is None):
            raise MXNetError("BucketExecutorPool: give fn or pure_fn "
                             "(with params), not both")
        if input_shape is None or buckets is None:
            raise MXNetError("BucketExecutorPool: input_shape and "
                             "buckets are required")
        if pure_fn is not None:
            params = dict(params or {})

            def fn(x):
                return tuple(pure_fn(params, x))

            tensors = tuple(params.values())
            watch = watch or (lambda: tensors)
            if structure is None:
                structure = {"params": [[k, list(v.shape), str(v.dtype)]
                                        for k, v in sorted(params.items())]}
            param_bytes = param_bytes or sum(
                t.numel() * t.element_size() for t in tensors)
        self._fn = fn
        self.input_shape = tuple(int(s) for s in input_shape)
        self.dtype = np.dtype(dtype)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("serving: buckets must be positive ints, "
                             "got %r" % (buckets,))
        self.device = resolve_device(device)
        self._watch = watch or (lambda: ())
        self._num_outputs = None
        self._owner = _capture.GraphOwner("BucketExecutorPool", self.device)
        self._lock = threading.Lock()
        self._label = label
        self._structure = structure
        self._param_bytes = int(param_bytes)
        self._compile_cache = bool(compile_cache) or cache is not None
        self._fingerprints = {}   # bucket -> digest
        self._peaks = {}          # bucket -> warm-up peak bytes (card)

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

    def compiled_buckets(self):
        """The buckets built so far, sorted: on the card those whose
        graph is captured, on the CPU those run once (each one's entry
        is its eager call)."""
        if self._owner.cuda:
            return sorted(self._owner.captured_keys())
        return self.warm_buckets()

    def fingerprint(self, bucket):
        """The digest of what ``bucket``'s graph computes, or None for a
        bucket not warmed yet."""
        return self._fingerprints.get(bucket)

    def _digest(self, bucket):
        doc = {"structure": self._structure,
               "input": [[bucket] + list(self.input_shape),
                         self.dtype.name],
               "backend": list(_capture._backend_flags()),
               "kernels": _build.library_names()}
        return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()
                              ).hexdigest()
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
        replay its graph; returns the seconds it took.  On the card each
        bucket's capture resets the process's peak-memory counter
        (``torch.cuda.reset_peak_memory_stats``) to measure its peak."""
        t0 = time.perf_counter()
        cuda = self._owner.cuda
        with self.device_scope(), self._lock:
            for b in self.buckets:
                zeros = torch.zeros((b,) + self.input_shape,
                                    dtype=getattr(torch, self.dtype.name),
                                    device=self.device)
                self._run(b, zeros)
                if cuda:
                    # the capture's peak, after the eager run made the
                    # libraries' one-time workspaces: the bucket's own
                    # working set
                    _capture.synchronize(self.device)
                    torch.cuda.reset_peak_memory_stats(self.device)
                    before = torch.cuda.memory_allocated(self.device)
                    self._run(b, zeros)
                    _capture.synchronize(self.device)
                    self._peaks[b] = self._param_bytes + (
                        torch.cuda.max_memory_allocated(self.device)
                        - before)
                self._fingerprints[b] = self._digest(b)
                if self._compile_cache and _telemetry._ENABLED:
                    _telemetry.hooks.serving_compile_cache(False)
            if cuda:
                _capture.synchronize(self.device)
        dt = time.perf_counter() - t0
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_warmup(self._label, dt,
                                            len(self.buckets))
        return dt

    def warmup_peaks(self):
        """``{bucket: bytes}``: each bucket's measured warm-up peak on
        the card (empty on the CPU)."""
        return dict(self._peaks)

    def hbm_plan(self, device_hbm_bytes=None):
        """Predict each bucket's peak device memory: the two smallest
        buckets' warm-up peaks give a const + per-item line, every
        bucket is extrapolated along it, and ``largest_fit_bucket`` is
        the largest bucket whose prediction fits ``device_hbm_bytes``
        (:func:`mxnet_tpu_torch.analysis.memory.hbm_plan`, the JAX
        package's keys).  Needs a warmed pool on the card."""
        from ..analysis.memory import hbm_plan
        if len(self._peaks) < 1:
            raise MXNetError("hbm_plan: no warm-up peaks measured (the "
                             "pool warms on the card)")
        b0 = self.buckets[0]
        b1 = self.buckets[1] if len(self.buckets) > 1 else b0
        return hbm_plan("serving:%s" % self._label, device_hbm_bytes,
                        buckets=self.buckets, batch_size=b0,
                        peaks={b: self._peaks[b] for b in (b0, b1)})

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
