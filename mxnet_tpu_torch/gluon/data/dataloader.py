"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Port rule: samples and batches are built in host memory -- on
``mx.cpu()``, or ``mx.cpu_pinned()`` with ``pin_memory=True`` -- never
on the default context (the card).  ``num_workers`` threads build
batches ahead of the consumer, in order, at most ``prefetch`` at a time.

Two routes, as in the JAX package:

- the host route: batches are NDArrays on the host, and the training
  loop's ``as_in_context(mx.gpu())`` is the one copy to the card a
  batch, asynchronous from pinned memory;
- the device-feed route, with ``ctx=``: batches stay host numpy in
  their own dtype through batchify (``host_batchify_fn``) and a
  :class:`~...dataio.DeviceFeed` lands them on ``ctx`` behind the
  consumer's compute, optionally expanded there by
  ``device_transform``; iteration yields landed NDArrays (a
  :class:`~...dataio.DeviceBatch` when a batch has several parts).
  ``mesh=`` and ``sharding=`` raise until ROADMAP item 9b ports the
  mesh.

With telemetry on, each wait for a batch records the JAX package's
``data.wait_time`` timer (``hooks.dataloader_wait``).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ... import telemetry as _telemetry
from ...base import MXNetError
from ...ndarray import NDArray
from ...ndarray.ndarray import _host_tensor
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "host_batchify_fn"]


def _stack(data, pin):
    if isinstance(data[0], NDArray):
        t = torch.stack([d._data for d in data])
    elif isinstance(data[0], (tuple, list)):
        return tuple(_stack(list(x), pin) for x in zip(*data))
    else:
        t = _host_tensor(np.asarray(data))
    if pin and torch.cuda.is_available():
        t = t.pin_memory()
    return NDArray(t)


def default_batchify_fn(data):
    """Stack samples into a batch on ``mx.cpu()`` (float64 as float32,
    int64 as int32)."""
    return _stack(data, False)


def _pinned_batchify_fn(data):
    """:func:`default_batchify_fn` into pinned host memory
    (``mx.cpu_pinned()``)."""
    return _stack(data, True)


def host_batchify_fn(data):
    """Stack samples into host numpy arrays in their own dtype (bf16 as
    float32, as ``asnumpy`` gives it)."""
    if isinstance(data[0], NDArray):
        t = torch.stack([d._data.detach() for d in data]).cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(data[0], (tuple, list)):
        return tuple(host_batchify_fn(list(x)) for x in zip(*data))
    arr = np.asarray(data)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, ctx=None, mesh=None,
                 sharding=None, device_transform=None, feed_depth=None):
        self._dataset = dataset
        self._timeout = timeout
        if mesh is not None or sharding is not None:
            from ...dataio.feed import _no_mesh
            _no_mesh("DataLoader")
        self._feed_kw = None
        self._feed = None
        if ctx is not None:
            self._feed_kw = dict(ctx=ctx, transform=device_transform,
                                 depth=feed_depth)
            if batchify_fn is None:
                batchify_fn = host_batchify_fn
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle and sampler are mutually exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or (
            _pinned_batchify_fn if pin_memory else default_batchify_fn)
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        it = self._iter_impl()
        if not _telemetry._ENABLED:
            yield from it
            return
        # starvation probe: the time the consumer waits on each batch
        # (data.wait_time, the goodput ledger's input_wait)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            _telemetry.hooks.dataloader_wait(time.perf_counter() - t0)
            yield batch

    def _iter_impl(self):
        if self._feed_kw is not None:
            yield from self._device_feed_iter()
            return
        yield from self._host_iter()

    def _host_iter(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        yield from self._threaded_iter()

    def _device_feed_iter(self):
        """Stage every host batch through a DeviceFeed (kept as
        ``_feed`` for its ``stats()`` until the next iteration);
        single-component batches unwrap to the bare NDArray, as on the
        host route."""
        from ...dataio import DeviceFeed
        self._feed = feed = DeviceFeed(self._host_iter(), **self._feed_kw)
        try:
            for batch in feed:
                yield batch.data if len(batch) == 1 else batch
        finally:
            feed.close()

    def _threaded_iter(self):
        """Ordered thread-pool pipeline with bounded prefetch."""
        batches = list(self._batch_sampler)
        results = {}
        ready = threading.Condition()
        prefetch = max(self._prefetch, 1)
        work = queue.Queue()
        for i, b in enumerate(batches):
            work.put((i, b))
        stop = threading.Event()
        next_wanted = [0]

        def worker():
            while not stop.is_set():
                try:
                    i, indices = work.get_nowait()
                except queue.Empty:
                    return
                with ready:
                    while not stop.is_set() and \
                            i >= next_wanted[0] + prefetch:
                        ready.wait(0.1)
                if stop.is_set():
                    return
                try:
                    out = self._make_batch(indices)
                except Exception as e:  # handed to the consumer
                    out = e
                with ready:
                    results[i] = out
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                deadline = time.monotonic() + self._timeout \
                    if self._timeout else None
                with ready:
                    next_wanted[0] = i
                    ready.notify_all()
                    while i not in results:
                        remaining = deadline - time.monotonic() \
                            if deadline else None
                        if remaining is not None and remaining <= 0:
                            raise MXNetError(
                                "DataLoader worker timed out after %ss "
                                "waiting for batch %d" % (self._timeout, i))
                        ready.wait(remaining if remaining is not None
                                   else 1.0)
                    out = results.pop(i)
                    ready.notify_all()
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            stop.set()
            with ready:
                ready.notify_all()
            for t in threads:
                t.join(timeout=self._timeout)
