"""Context-propagated trace/span IDs: the Dapper-style causality layer
(counterpart of ``mxnet_tpu/obs/trace.py``).

``mx.telemetry`` answers *how much* (counters, histograms); this module
answers *which request* and *in what order*: every unit of work carries
a ``TraceContext`` (trace id + span id) in a ``contextvars.ContextVar``,
child spans record their parent, and cross-thread fan-in (the serving
batcher assembling many requests into one compiled dispatch) is modeled
as **span links** -- the batch span names every request span it serves,
exactly the Dapper/OpenTelemetry shape.

Two recording surfaces:

- :func:`span` / :func:`trace` -- context managers for code that OWNS
  its scope (user code, tests);
- :func:`begin_span` / :func:`end_span` and :func:`record_span` -- the
  hook surface the instrumented framework paths use, so a disabled
  tracer costs exactly one module-flag check per site
  (``obs._TRACE_ENABLED``, the same zero-overhead contract as
  ``telemetry._ENABLED``).

Every finished span lands in (1) a bounded in-process ring
(:func:`export_chrome_trace` reads it) and (2) the attached telemetry
sinks as a streamed ``{"kind": "span", ...}`` JSONL record, the JAX
package's record; with ``mx.profiling`` enabled each span is also
overlaid on the profiling step timeline.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid

from .. import sync as _sync

__all__ = [
    "TraceContext", "current", "new_id", "trace", "span",
    "begin_span", "end_span", "record_span", "spans", "clear",
    "export_chrome_trace",
]

# bounded span ring: a multi-hour run must not grow host memory
_MAX_SPANS = 16_384

_CTX = contextvars.ContextVar("mxtpu_trace", default=None)
_lock = _sync.Lock(name="obs.spans")
_spans = []
_dropped = 0


class TraceContext:
    """One (trace_id, span_id) position in a trace tree."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self):
        """A fresh span position under the same trace."""
        return TraceContext(self.trace_id, new_id())

    def __repr__(self):
        return "TraceContext(trace=%s, span=%s)" % (self.trace_id,
                                                    self.span_id)


def new_id():
    """16-hex-char random id (uuid4-derived; no global RNG state)."""
    return uuid.uuid4().hex[:16]


def current():
    """The active TraceContext of this thread/task, or None."""
    return _CTX.get()


def fresh_context():
    """Current context if one is active, else a brand-new root trace --
    what a request boundary (serving submit) uses so externally-traced
    and untraced clients both get causality."""
    ctx = _CTX.get()
    if ctx is not None:
        return TraceContext(ctx.trace_id, new_id())
    return TraceContext(new_id(), new_id())


class _OpenSpan:
    __slots__ = ("name", "ctx", "parent_id", "t0", "t_wall", "attrs",
                 "token")

    def __init__(self, name, ctx, parent_id, attrs, token):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t_wall = time.time()
        self.attrs = attrs
        self.token = token


def begin_span(name, **attrs):
    """Open a span as a child of the current context and make it the
    current context.  Returns the open-span token for :func:`end_span`.
    The framework hook surface: call sites guard with
    ``if _obs._TRACE_ENABLED`` so the disabled cost is one flag check."""
    parent = _CTX.get()
    if parent is not None:
        ctx = parent.child()
        parent_id = parent.span_id
    else:
        ctx = TraceContext(new_id(), new_id())
        parent_id = None
    token = _CTX.set(ctx)
    return _OpenSpan(name, ctx, parent_id, attrs or None, token)


def end_span(open_span, **extra_attrs):
    """Close a span opened by :func:`begin_span`: restore the previous
    context and record the finished span."""
    _CTX.reset(open_span.token)
    attrs = open_span.attrs
    if extra_attrs:
        attrs = dict(attrs or {}, **extra_attrs)
    record_span(open_span.name, open_span.ctx,
                parent_id=open_span.parent_id,
                t0=open_span.t0,
                dur=time.perf_counter() - open_span.t0,
                t_wall=open_span.t_wall, attrs=attrs)
    return open_span.ctx


@contextlib.contextmanager
def span(name, **attrs):
    """``with obs.span("phase"): ...`` -- scoped child span."""
    sp = begin_span(name, **attrs)
    try:
        yield sp.ctx
    finally:
        end_span(sp)


@contextlib.contextmanager
def trace(name="trace", trace_id=None, **attrs):
    """Open a new root trace (or adopt ``trace_id``) for the enclosed
    block.  The root span records on exit like any other."""
    ctx = TraceContext(trace_id or new_id(), new_id())
    token = _CTX.set(ctx)
    t0 = time.perf_counter()
    t_wall = time.time()
    try:
        yield ctx
    finally:
        _CTX.reset(token)
        record_span(name, ctx, parent_id=None, t0=t0,
                    dur=time.perf_counter() - t0, t_wall=t_wall,
                    attrs=attrs or None)


def record_span(name, ctx, parent_id=None, t0=None, dur=0.0,
                t_wall=None, attrs=None, links=None):
    """Record one finished span with explicit timing -- the surface for
    cross-thread spans whose begin and end live on different threads
    (queue wait measured by the batcher worker from the submit mark).

    ``t0`` is on the perf_counter clock (Chrome-trace placement);
    ``t_wall`` is wall time (JSONL ``t`` field, cross-process merge).
    ``links`` carries span ids this span serves but is not a child of
    (batcher fan-in).
    """
    global _dropped
    rec = {
        "kind": "span",
        "name": name,
        "trace": ctx.trace_id,
        "span": ctx.span_id,
        "parent": parent_id,
        "t": t_wall if t_wall is not None else time.time(),
        "t0": t0 if t0 is not None else time.perf_counter(),
        "dur": float(dur),
    }
    if attrs:
        rec["attrs"] = attrs
    if links:
        rec["links"] = list(links)
    with _lock:
        if len(_spans) >= _MAX_SPANS:
            del _spans[:_MAX_SPANS // 10]
            _dropped += _MAX_SPANS // 10
        _spans.append(rec)
    # stream to the attached telemetry sinks (the JSONL run log);
    # Registry._stream is sink fan-out only -- it does not require
    # telemetry to be enabled, so tracing stands alone
    from .. import telemetry as _telemetry
    _telemetry.registry()._stream(rec)
    # overlay on the profiling step timeline when cost accounting is on
    from .. import profiling as _profiling
    if _profiling.enabled():
        from ..profiling import timeline as _timeline
        _timeline.record(name, rec["t0"], rec["dur"],
                         args={"trace": ctx.trace_id,
                               "span": ctx.span_id})
    return rec


def spans():
    """Snapshot of the bounded span ring (oldest first)."""
    with _lock:
        return list(_spans)


def dropped():
    return _dropped


def clear():
    global _dropped
    with _lock:
        del _spans[:]
        _dropped = 0


def export_chrome_trace(path=None):
    """Chrome trace-event JSON of the span ring: complete ('X') events
    with trace/span/parent ids in ``args``, loadable in Perfetto or
    chrome://tracing.  Written to ``path`` when given; the dict is
    returned either way."""
    import json
    evs = []
    for rec in spans():
        args = {"trace": rec["trace"], "span": rec["span"]}
        if rec.get("parent"):
            args["parent"] = rec["parent"]
        if rec.get("links"):
            args["links"] = rec["links"]
        if rec.get("attrs"):
            args.update(rec["attrs"])
        evs.append({"name": rec["name"], "ph": "X",
                    "ts": rec["t0"] * 1e6, "dur": rec["dur"] * 1e6,
                    "pid": os.getpid(), "tid": threading.get_ident(),
                    "args": args})
    doc = {"traceEvents": evs, "displayTimeUnit": "ms",
           "otherData": {"producer": "mxnet_tpu_torch.obs.trace",
                         "dropped_spans": _dropped}}
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
