"""Dynamic micro-batcher: the request queue between concurrent clients
and the per-bucket executor pool, and the serving error types
(counterpart of ``mxnet_tpu/serving/batcher.py``).

A bounded queue accepts single-sample requests; one worker thread per
servable assembles micro-batches -- it dispatches as soon as the
largest bucket fills or the oldest queued request has waited
``max_wait``; the batch pads to the smallest bucket that fits, runs one
forward, and the responses go back to per-request futures.

Overload behaviour is explicit:

- **load shedding**: a full queue rejects the submit with
  :class:`ServingQueueFull` instead of growing latency without bound;
- **per-request timeout**: a request whose deadline passes while still
  queued completes with :class:`RequestTimeout` and never occupies a
  batch slot (once dispatched, a request always completes);
- **graceful drain**: ``close(drain=True)`` stops intake, the worker
  keeps dispatching until the queue is empty, and every accepted
  request resolves.

The batcher counts what it did (:meth:`DynamicBatcher.stats`); the JAX
package's telemetry spans and chaos points are not ported.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["DynamicBatcher", "ServingQueueFull", "RequestTimeout",
           "ServableClosed"]


class ServingQueueFull(MXNetError):
    """Submit rejected: the bounded request queue is at capacity, or the
    KV cache cannot cover the request (the load-shedding contract --
    back off or scale out)."""


class RequestTimeout(MXNetError):
    """The request's deadline passed while it was still queued."""


class ServableClosed(MXNetError):
    """Submit rejected: the servable is closed or draining."""


class _Request:
    __slots__ = ("x", "future", "t_submit", "deadline")

    def __init__(self, x, timeout):
        self.x = x
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + timeout) if timeout else None


# Worker idle poll: the condition is notified on submit and close, so
# this bound only keeps an idle worker from waiting untimed.
_IDLE_WAIT_S = 0.1


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class DynamicBatcher:
    """One request queue and worker thread over a BucketExecutorPool."""

    def __init__(self, pool, label="servable", max_wait_ms=None,
                 max_queue=None):
        from .. import env as _env
        self._pool = pool
        self._label = label
        if max_wait_ms is None:
            max_wait_ms = _env.get("MXNET_TPU_SERVING_MAX_WAIT_MS")
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue
                             if max_queue is not None
                             else _env.get("MXNET_TPU_SERVING_QUEUE"))
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._closed = False
        self._drain = True
        self._counts = collections.Counter()
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name="mxtt-serving-%s" % label)
        self._thread.start()

    # -- intake ---------------------------------------------------------
    def submit(self, x, timeout=None):
        """Queue one sample; returns a Future resolving to the model's
        output for that sample (a tuple when the model has several
        outputs).  Raises ServingQueueFull / ServableClosed instead of
        blocking."""
        x = np.asarray(x, self._pool.dtype)
        if x.shape != self._pool.input_shape:
            raise MXNetError(
                "serving: request shape %r != input shape %r (requests "
                "carry ONE sample; the batcher builds the batch)"
                % (x.shape, self._pool.input_shape))
        req = _Request(x, timeout)
        with self._cond:
            if self._closed:
                raise ServableClosed("servable %r is closed" % self._label)
            if len(self._queue) >= self.max_queue:
                self._counts["shed"] += 1
                raise ServingQueueFull(
                    "servable %r queue full (%d); request shed"
                    % (self._label, self.max_queue))
            self._queue.append(req)
            self._cond.notify()
        return req.future

    # -- worker ---------------------------------------------------------
    def _collect(self):
        """Assemble one micro-batch: wait for a first request, then
        gather more until the largest bucket fills or the oldest
        request's ``max_wait`` deadline passes.  Returns the popped
        requests, or None when closed and drained."""
        max_n = self._pool.max_bucket
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait(_IDLE_WAIT_S)
            deadline = self._queue[0].t_submit + self.max_wait_s
            while len(self._queue) < max_n and not self._closed:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                self._cond.wait(rem)
            n = min(len(self._queue), max_n)
            return [self._queue.popleft() for _ in range(n)]

    def _worker(self):
        with self._pool.device_scope():
            while True:
                reqs = self._collect()
                if reqs is None:
                    return
                if not self._drain and self._closed:
                    for r in reqs:
                        r.future.set_exception(ServableClosed(
                            "servable %r closed without drain"
                            % self._label))
                    continue
                now = time.perf_counter()
                live = []
                for r in reqs:
                    if r.deadline is not None and now > r.deadline:
                        self._count(timeouts=1)
                        r.future.set_exception(RequestTimeout(
                            "request waited %.1fms > timeout"
                            % (1e3 * (now - r.t_submit))))
                    else:
                        live.append(r)
                if live:
                    self._dispatch(live)

    def _dispatch(self, reqs):
        n = len(reqs)
        bucket = self._pool.bucket_for(n)
        batch = np.zeros((bucket,) + self._pool.input_shape,
                         self._pool.dtype)
        for i, r in enumerate(reqs):
            batch[i] = r.x
        try:
            outs = [_host(o) for o in self._pool.call(bucket, batch)]
        except Exception as e:          # the forward failed: fail the
            self._count(errors=1)           # requests, keep the worker
            for r in reqs:
                r.future.set_exception(e)
            return
        self._count(batches=1, responses=n, **{"bucket_%d" % bucket: 1})
        single = len(outs) == 1
        for i, r in enumerate(reqs):
            r.future.set_result(outs[0][i] if single
                                else tuple(o[i] for o in outs))

    # -- lifecycle ------------------------------------------------------
    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    def _count(self, **counts):
        with self._cond:
            self._counts.update(counts)

    def stats(self):
        """Counts so far: ``batches``, ``responses``, ``timeouts``,
        ``shed``, ``errors`` and ``bucket_<b>`` (batches dispatched at
        bucket ``b``)."""
        with self._cond:
            return dict(self._counts)

    def close(self, drain=True):
        """Stop intake and shut the worker down.  ``drain=True``
        dispatches everything already queued first, so every accepted
        request resolves; ``drain=False`` fails the queued requests with
        ServableClosed (still resolved, never dropped)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._drain = drain
            self._cond.notify_all()
        self._thread.join()

    @property
    def closed(self):
        return self._closed
