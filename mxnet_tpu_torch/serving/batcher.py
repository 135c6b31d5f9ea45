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

The batcher counts what it did (:meth:`DynamicBatcher.stats`), and
with telemetry on records the JAX package's ``serving.*`` instruments
(requests, queue depth, shed, timeouts, errors, batches, occupancy,
dispatch time, per-request latency).  With tracing on, each request's
trace gets ``serving.queue_wait``/``serving.respond`` children and a
``serving.request`` root, and each batch a ``serving.batch`` root that
links the requests it served, with ``serving.batch_assembly``,
``serving.dispatch`` (the pool's call: copy in, launch) and
``serving.device_get`` (the wait for the outputs and their copy to the
host) children.  The chaos fail point ``serving.dispatch`` sits before
the pool's call: a sleep there is the wedged-device weather, a RAISE a
failed call that fails its requests, not the worker.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .. import chaos as _chaos
from .. import obs as _obs
from .. import sync as _sync
from .. import telemetry as _telemetry
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
    __slots__ = ("x", "future", "t_submit", "deadline", "tctx")

    def __init__(self, x, timeout):
        self.x = x
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + timeout) if timeout else None
        # trace context, set at submit when tracing is armed; the
        # worker thread records queue/respond spans against it
        self.tctx = None


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
        self._cond = _sync.Condition(name="serving.batcher")
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
        if _obs._TRACE_ENABLED:
            req.tctx = _obs.trace.fresh_context()
        with self._cond:
            if self._closed:
                raise ServableClosed("servable %r is closed" % self._label)
            if len(self._queue) >= self.max_queue:
                self._counts["shed"] += 1
                if _telemetry._ENABLED:
                    _telemetry.hooks.serving_shed(self._label)
                raise ServingQueueFull(
                    "servable %r queue full (%d); request shed"
                    % (self._label, self.max_queue))
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify()
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_request(self._label, depth)
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
                        if _telemetry._ENABLED:
                            _telemetry.hooks.serving_timeout(self._label)
                        if _obs._TRACE_ENABLED and r.tctx is not None:
                            _obs.record_span(
                                "serving.request", r.tctx,
                                t0=r.t_submit, dur=now - r.t_submit,
                                attrs={"model": self._label,
                                       "timeout": True})
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
        t0 = time.perf_counter()
        try:
            # chaos: a sleep rule here is the wedged-device weather the
            # flood scenario sheds against; a RAISE rule shows a failed
            # dispatch fails its requests, not the worker
            _chaos.fail_point("serving.dispatch", model=self._label,
                              occupancy=n, bucket=bucket)
            outs = self._pool.call(bucket, batch)
            t_call = time.perf_counter()
            outs = [_host(o) for o in outs]
        except Exception as e:          # the forward failed: fail the
            self._count(errors=1)           # requests, keep the worker
            if _telemetry._ENABLED:
                _telemetry.hooks.serving_error(self._label)
            for r in reqs:
                r.future.set_exception(e)
            return
        t_get = time.perf_counter()
        self._count(batches=1, responses=n, **{"bucket_%d" % bucket: 1})
        single = len(outs) == 1
        for i, r in enumerate(reqs):
            r.future.set_result(outs[0][i] if single
                                else tuple(o[i] for o in outs))
        done = time.perf_counter()
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_batch(self._label, n, bucket,
                                           t_get - t0)
            for r in reqs:
                _telemetry.hooks.serving_latency(done - r.t_submit)
        if _obs._TRACE_ENABLED:
            self._record_batch_spans(reqs, t0, t_call, t_get, done, n,
                                     bucket)

    def _record_batch_spans(self, reqs, t0, t_call, t_get, done, n,
                            bucket):
        """Each request's trace gets queue-wait and respond child spans
        plus a ``serving.request`` root; the batch is a fresh trace
        whose root span LINKS every request span it served, with
        ``serving.batch_assembly`` / ``serving.dispatch`` /
        ``serving.device_get`` children.  ``serving.dispatch`` plus
        ``serving.device_get`` is the window ``serving.dispatch_time``
        observed."""
        tr = _obs.trace
        model = self._label
        links = []
        for r in reqs:
            ctx = r.tctx
            if ctx is None:           # accepted before tracing armed
                continue
            links.append(ctx.span_id)
            tr.record_span("serving.queue_wait", ctx.child(),
                           parent_id=ctx.span_id, t0=r.t_submit,
                           dur=t0 - r.t_submit, attrs={"model": model})
            tr.record_span("serving.respond", ctx.child(),
                           parent_id=ctx.span_id, t0=t_get,
                           dur=done - t_get, attrs={"model": model})
            tr.record_span("serving.request", ctx, t0=r.t_submit,
                           dur=done - r.t_submit,
                           attrs={"model": model, "bucket": bucket})
        batch_ctx = tr.TraceContext(tr.new_id(), tr.new_id())
        t_first = min(r.t_submit for r in reqs)
        tr.record_span("serving.batch_assembly", batch_ctx.child(),
                       parent_id=batch_ctx.span_id, t0=t_first,
                       dur=t0 - t_first, attrs={"model": model})
        tr.record_span("serving.dispatch", batch_ctx.child(),
                       parent_id=batch_ctx.span_id, t0=t0,
                       dur=t_call - t0,
                       attrs={"model": model, "bucket": bucket})
        tr.record_span("serving.device_get", batch_ctx.child(),
                       parent_id=batch_ctx.span_id, t0=t_call,
                       dur=t_get - t_call, attrs={"model": model})
        tr.record_span("serving.batch", batch_ctx, t0=t0, dur=done - t0,
                       attrs={"model": model, "occupancy": n,
                              "bucket": bucket}, links=links)

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
