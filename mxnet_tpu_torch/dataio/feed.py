"""Device feed: overlapped host->device staging behind any data source
(counterpart of ``mxnet_tpu/dataio/feed.py``).

A background producer thread pulls host batches from the wrapped source
and lands them on the card while the consumer trains on the previous
one:

- it fills a ring of ``depth + 1`` pinned host slots, allocated once (a
  slot again only when a batch's shape or dtype changes); an
  ``ImageIter`` source assembles its batch straight into the slot
  through ``next_np(out=)``, any other source is copied in;
- the copy to the card is issued from the slot on a side
  ``torch.cuda.Stream`` with ``non_blocking=True``, and a CUDA event is
  recorded after it; a slot is refilled only once its copy's event has
  completed (polled, never a blocking sync, so the producer stays legal
  while a consumer captures or replays a CUDA graph under
  ``torch.cuda.set_sync_debug_mode("error")``);
- the consumer's stream waits on that event in :meth:`DeviceFeed.next`,
  and each landed tensor is marked with ``record_stream`` on the
  consumer's stream, so the caching allocator does not hand its memory
  back to the side stream while the consumer's work still reads it;
- the source runs on the producer thread under ``with mx.cpu():``, so
  a ``DataIter``'s NDArrays are host batches like any other source's;
- batches cross in their compact dtype (uint8 stays uint8) and a
  :class:`~.transforms.DeviceTransform` expands them on the card;
- producer exceptions re-raise at the consumer's next ``next()``;
  ``close()`` joins the thread, ``reset()`` restarts it; the producer
  holds the feed only weakly while it waits, and a ``weakref.finalize``
  stops it when the consumer abandons iteration without ``close()``.

The landing device is ``ctx`` (a context, a ``torch.device`` or its
name), the card by default; without CUDA that default raises
:class:`~..base.MXNetError`.  A feed lands on the host only when
``ctx=mx.cpu()`` asks for it, and then without the ring.  ``mesh=`` and
``sharding=`` raise until ROADMAP item 9b ports the mesh.  With
telemetry on, the feed writes the JAX package's ``feed.*`` instruments
(producer busy and bytes a batch, consumer wait, the epoch's overlap
share), which :meth:`DeviceFeed.stats` and
:meth:`DeviceFeed.overlap_frac` mirror; the ``feed.produce`` chaos point
sits at the top of each production (a sleep rule there starves the
consumer, the goodput ledger's input_wait), and with ``mx.profiling`` on
each staged batch is a ``feed.stage`` span on the step timeline.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref

import numpy as np
import torch

from .. import chaos as _chaos
from .. import env as _env
from .. import profiling as _profiling
from .. import random as _random
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import cpu, resolve_device
from ..ndarray import NDArray
from ..ops.table import torch_dtype

__all__ = ["DeviceBatch", "DeviceFeed"]

_END = object()
_POLL_S = 50e-6


def _feed_depth(depth):
    if depth is not None:
        return max(1, int(depth))
    return max(1, _env.get("MXNET_TPU_FEED_DEPTH"))


def _feed_compact(compact):
    if compact is not None:
        return bool(compact)
    return _env.get("MXNET_TPU_FEED_COMPACT")


def _no_mesh(what):
    raise MXNetError(
        "%s: mesh=/sharding= landing is not ported yet (ROADMAP item 9b, "
        "the mesh and SPMD path); pass ctx= for one device" % what)


class DeviceBatch:
    """One device-resident batch yielded by :class:`DeviceFeed`.

    ``arrays`` are post-transform NDArrays on the landing device;
    ``raw`` keeps the staged (pre-transform, compact-dtype) tensors so
    callers can retain cheap uint8 slabs and expand them again later
    (``DeviceFeed.apply_transform``).  Unpacks like the host loader's
    tuple: ``for x, y in feed`` works.
    """

    __slots__ = ("arrays", "pad", "raw")

    def __init__(self, arrays, pad=0, raw=None):
        self.arrays = tuple(a if isinstance(a, NDArray) else NDArray(a)
                            for a in arrays)
        self.pad = pad
        self.raw = raw

    @property
    def data(self):
        return self.arrays[0]

    @property
    def label(self):
        return self.arrays[1] if len(self.arrays) > 1 else None

    def __iter__(self):
        return iter(self.arrays)

    def __getitem__(self, i):
        return self.arrays[i]

    def __len__(self):
        return len(self.arrays)

    def __repr__(self):
        return "DeviceBatch(%s, pad=%d)" % (
            ", ".join("%sx%s" % (a.shape, a.dtype) for a in self.arrays),
            self.pad)


def _host_tensor(x, precast):
    """A CPU tensor viewing (or, for bf16 and a precast, holding) the
    host leaf ``x``."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.device.type != "cpu":
        t = t.cpu()
    return t.to(precast) if precast is not None else t


class _PinnedRing:
    """``n`` slots of pinned host buffers, one buffer a leaf, and the
    event of each slot's last copy to the card."""

    def __init__(self, n):
        self._bufs = [dict() for _ in range(n)]
        self._events = [None] * n
        self._next = 0

    def acquire(self, stop):
        """The next slot, once its last copy has completed; None when
        ``stop`` was set while waiting."""
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        ev = self._events[k]
        while ev is not None and not ev.query():
            if stop.is_set():
                return None
            time.sleep(_POLL_S)
        self._events[k] = None
        return k

    def buffer(self, k, leaf, shape, dtype):
        """Slot ``k``'s pinned buffer for ``leaf``, (re)allocated when
        the shape or dtype changed."""
        buf = self._bufs[k].get(leaf)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._bufs[k][leaf] = buf
        return buf

    def issued(self, k, event):
        self._events[k] = event


class DeviceFeed:
    """Wrap any batch source into an overlapped device-resident stream.

    ``source`` may be a legacy ``DataIter`` (``.next()`` ->
    ``DataBatch``), an ``ImageIter`` (its ``next_np`` path fills the
    pinned slots in place), a ``gluon.data.DataLoader``, or any
    iterable/iterator of host batches (arrays or tuples of arrays).

    The feed is itself an iterator: ``next()`` blocks on the staging
    queue, makes the consumer's stream wait for the batch's copy,
    applies ``transform`` to the data component, and returns a
    :class:`DeviceBatch`.  ``reset()`` restarts the producer (resetting
    a resettable source) for the next epoch; ``close()`` joins the
    thread.  ``batch_axis`` and ``axis_name`` belong to the mesh route
    and are accepted for the JAX package's signature.
    """

    def __init__(self, source, ctx=None, mesh=None, sharding=None,
                 transform=None, depth=None, compact=None, batch_axis=0,
                 axis_name="dp"):
        if mesh is not None or sharding is not None:
            _no_mesh("DeviceFeed")
        self._source = source
        self._depth = _feed_depth(depth)
        self._compact = _feed_compact(compact)
        self.transform = transform
        self._device = resolve_device(ctx)
        self._cuda = self._device.type == "cuda"
        self._side = torch.cuda.Stream(self._device) if self._cuda else None
        self._ring = _PinnedRing(self._depth + 1) if self._cuda else None
        self._queue = None
        self._thread = None
        self._stop = None
        self._error = None
        self._finalizer = None
        # producer busy / consumer wait / bytes staged / batches, kept
        # always (a few float adds a batch); both threads write them
        self._stats = {"producer_busy": 0.0, "consumer_wait": 0.0,
                       "bytes_staged": 0, "batches": 0}
        self._stats_lock = threading.Lock()
        self._start()

    @property
    def device(self):
        """The ``torch.device`` batches land on."""
        return self._device

    @property
    def _precast(self):
        if self._compact or self.transform is None:
            return None
        return getattr(self.transform, "dtype", None)

    # -- staging -------------------------------------------------------
    def _resident(self, x):
        """``x``'s tensor when it already lies on the landing device."""
        if isinstance(x, NDArray):
            x = x._data
        if isinstance(x, torch.Tensor) and x.device == self._device:
            return x
        return None

    def _stage_host(self, arrays):
        """Land host leaves on the CPU: a copy each (the source may reuse
        its buffers), precast when compact staging is off."""
        staged, nbytes = [], 0
        for a in arrays:
            t = self._resident(a)
            if t is not None:
                staged.append(t)
                continue
            t = _host_tensor(a, self._precast).clone()
            staged.append(t)
            nbytes += t.numel() * t.element_size()
        return staged, nbytes, None

    def _stage_cuda(self, k, filled, arrays):
        """Copy the leaves into ring slot ``k`` (all but those in
        ``filled``, already there) and issue their copies to the card on
        the side stream; returns ``(tensors, bytes, event)``."""
        staged, nbytes = [], 0
        with torch.cuda.device(self._device), torch.cuda.stream(self._side):
            for i, a in enumerate(arrays):
                t = self._resident(a)
                if t is not None:
                    staged.append(t)
                    continue
                buf = filled.get(i)
                if buf is None:
                    host = _host_tensor(a, self._precast)
                    buf = self._ring.buffer(k, i, host.shape, host.dtype)
                    buf.copy_(host)
                dev = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=self._device)
                dev.copy_(buf, non_blocking=True)
                staged.append(dev)
                nbytes += buf.numel() * buf.element_size()
            event = torch.cuda.Event()
            event.record(self._side)
        return staged, nbytes, event

    # -- source normalization ------------------------------------------
    def _make_next_batch(self):
        """One-batch step ``(slot) -> (leaves, pad, filled)`` closing
        over the source and the ring only -- never the feed, which the
        producer holds weakly.  ``filled`` maps a leaf to the pinned
        buffer it was assembled in."""
        src = self._source
        ring = self._ring
        if hasattr(src, "next_np"):          # ImageIter: fill in place
            if ring is not None and self._precast is None:
                shape = (src.batch_size,) + tuple(src.data_shape)
                dtype = torch_dtype(src._batch_dtype)

                def next_batch(k):
                    buf = ring.buffer(k, 0, shape, dtype)
                    data, labels, pad = src.next_np(out=buf.numpy())
                    return (data, labels), pad, {0: buf}
                return next_batch

            def next_batch(k):
                data, labels, pad = src.next_np()
                return (data, labels), pad, {}
        elif hasattr(src, "next") and hasattr(src, "reset"):  # DataIter
            def next_batch(k):
                batch = src.next()
                arrays = tuple(batch.data) + tuple(batch.label or ())
                return arrays, getattr(batch, "pad", 0) or 0, {}
        else:
            it = self._src_iter

            def next_batch(k):
                item = next(it)
                if isinstance(item, (tuple, list)):
                    return tuple(item), 0, {}
                return (item,), 0, {}
        return next_batch

    # -- producer ------------------------------------------------------
    @staticmethod
    def _producer_put(q, stop, item):
        """Blocking put that stays responsive to close()/finalize."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _start(self):
        self._queue = q = queue.Queue(self._depth)
        self._stop = stop = threading.Event()
        self._error = None
        # a plain iterable is consumed through one iterator per epoch
        self._src_iter = iter(self._source) \
            if not (hasattr(self._source, "next_np")
                    or hasattr(self._source, "next")) else None
        next_batch = self._make_next_batch()
        ring = self._ring
        wself = weakref.ref(self)

        def run():
            out = _END
            try:
                while not stop.is_set():
                    # busy window = host batch production (read, decode,
                    # assembly into the slot) + issuing the copy; the
                    # slot wait and the blocking put are backpressure
                    k = ring.acquire(stop) if ring is not None else None
                    if ring is not None and k is None:
                        return
                    # chaos fail point on the input path: a seeded sleep
                    # rule here stalls the producer, so the goodput
                    # ledger's input_wait category must show it
                    _chaos.fail_point("feed.produce")
                    t0 = time.perf_counter()
                    try:
                        # host batches: a DataIter's NDArrays are made
                        # on the CPU, whatever the consumer's context
                        with cpu():
                            arrays, pad, filled = next_batch(k)
                    except StopIteration:
                        break
                    feed = wself()
                    if feed is None:         # consumer GC'd mid-epoch
                        return
                    if ring is None:
                        staged, nbytes, event = feed._stage_host(arrays)
                    else:
                        staged, nbytes, event = feed._stage_cuda(
                            k, filled, arrays)
                        ring.issued(k, event)
                    busy = time.perf_counter() - t0
                    with feed._stats_lock:
                        feed._stats["producer_busy"] += busy
                        feed._stats["bytes_staged"] += nbytes
                        feed._stats["batches"] += 1
                    # drop the strong ref BEFORE the blocking put: while
                    # parked on a full buffer this thread must not be
                    # what keeps the feed alive
                    feed = None
                    if _telemetry._ENABLED:
                        _telemetry.hooks.feed_produce(busy, nbytes)
                    if _profiling._ENABLED:
                        # the host->device staging span on the step
                        # timeline
                        from ..profiling import timeline
                        timeline.record("feed.stage", t0, busy,
                                        {"bytes": nbytes})
                    if not DeviceFeed._producer_put(
                            q, stop, (tuple(staged), pad, event)):
                        return
            except BaseException as e:  # re-raised at consumer next()
                out = e
            DeviceFeed._producer_put(q, stop, out)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mxnet_tpu_torch.DeviceFeed")
        # GC of an abandoned feed wakes the producer out of a full
        # buffer; close() detaches this and does the full join
        self._finalizer = weakref.finalize(self, _release_producer,
                                           q, stop)
        self._thread.start()

    # -- consumer ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def _land(self, staged, event):
        """Order the consumer's stream after the batch's copy and tie
        each landed tensor's memory to that stream."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(event)
        for t in staged:
            if t.device.type == "cuda":
                t.record_stream(cur)

    def next(self):
        if self._error is not None:
            raise self._error
        t0 = time.perf_counter()
        item = self._queue.get()
        wait = time.perf_counter() - t0
        with self._stats_lock:
            self._stats["consumer_wait"] += wait
        if _telemetry._ENABLED:
            _telemetry.hooks.feed_wait(wait)
        if item is _END:
            self._finish_epoch()
            raise StopIteration
        if isinstance(item, BaseException):
            self._error = item
            self._finish_epoch()
            raise item
        staged, pad, event = item
        self._land(staged, event)
        arrays = list(staged)
        if self.transform is not None:
            arrays[0] = self.transform(
                arrays[0], _random.generator(arrays[0].device))
        return DeviceBatch(arrays, pad=pad, raw=staged)

    def _finish_epoch(self):
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=10)
        if _telemetry._ENABLED:
            _telemetry.hooks.feed_overlap(self.overlap_frac())

    def apply_transform(self, staged):
        """Run the transform again on a retained raw (compact) device
        tensor -- lets callers keep uint8 slabs resident and expand them
        per use."""
        if self.transform is None:
            return staged
        t = staged._data if isinstance(staged, NDArray) else staged
        return self.transform(staged, _random.generator(t.device))

    # -- stats ---------------------------------------------------------
    def stats(self):
        """Copy of the feed counters (seconds / bytes / batches)."""
        with self._stats_lock:
            return dict(self._stats)

    def overlap_frac(self):
        """Share of producer (read, decode, assembly and copy issue) time
        hidden behind consumer compute: ``1 - consumer_wait /
        producer_busy``."""
        with self._stats_lock:
            busy = self._stats["producer_busy"]
            wait = self._stats["consumer_wait"]
        if busy <= 0:
            return 0.0
        return max(0.0, 1.0 - wait / busy)

    # -- lifecycle -----------------------------------------------------
    def reset(self):
        """Stop the in-flight epoch (if any), reset a resettable source,
        and restart the producer for the next epoch."""
        self.close()
        if hasattr(self._source, "reset"):
            self._source.reset()
        elif self._src_iter is not None:
            # a bare iterator cannot be rewound; an iterable can
            try:
                iter(self._source)
            except TypeError:
                raise MXNetError(
                    "DeviceFeed.reset: source is not resettable")
        self._start()

    def close(self):
        """Join the producer thread; idempotent, safe mid-epoch."""
        if self._finalizer is not None:
            self._finalizer.detach()
        if self._stop is not None:
            self._stop.set()
        # drain so a producer blocked on put() wakes promptly
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _release_producer(q, stop):
    """``weakref.finalize`` callback shared by the staged-feed classes:
    stop the producer of an iterator its consumer abandoned, and drain
    the buffer so a put() parked on a full queue wakes immediately.
    Deliberately holds NO reference to the feed -- that is the point."""
    stop.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
