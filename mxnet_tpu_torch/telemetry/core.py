"""Typed runtime instruments and the thread-safe registry behind them
(counterpart of ``mxnet_tpu/telemetry/core.py``).

The always-on, *queryable* layer: named Counters/Gauges/Timers/Events
cheap enough to leave enabled for a whole production run and dump as
data (JSONL / Prometheus text / console table, see ``sinks.py``).

Everything here is host-side Python: creating or mutating an instrument
never touches a device, never syncs, and never allocates on the hot
path beyond a tuple for the streamed record.  The
*enable gate* lives in ``telemetry/__init__.py`` (module flag
``_ENABLED``); instrumented framework modules check that one flag and
skip every call below when it is off.
"""
from __future__ import annotations

import bisect
import time

from .. import sync as _sync

__all__ = ["Counter", "Gauge", "Timer", "Event", "Registry"]

# Ring capacity for per-Event payload history: enough to answer "what
# were the recent retraces" without letting a pathological loop grow
# host memory unboundedly.
_EVENT_RING = 256


class Instrument:
    """Base: a named instrument owned by one Registry."""

    kind = "instrument"

    def __init__(self, name, registry=None):
        self.name = name
        self._registry = registry
        # one role identity for every instrument's lock: the order
        # graph (docs/concurrency.md) reasons about roles, not instances
        self._lock = _sync.Lock(name="telemetry.instrument")

    def _stream(self, record_kind, **fields):
        reg = self._registry
        if reg is not None:
            reg._stream({"kind": record_kind, "name": self.name,
                         "t": time.time(), **fields})

    def snapshot(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class Counter(Instrument):
    """Monotonic-by-convention event count (``inc``); ``set`` exists for
    the mx.profiler compatibility surface, which allows absolute writes."""

    kind = "counter"

    def __init__(self, name, registry=None):
        super().__init__(name, registry)
        self._value = 0

    def inc(self, delta=1):
        with self._lock:
            self._value += delta

    def dec(self, delta=1):
        self.inc(-delta)

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"kind": "counter", "name": self.name, "value": self._value}

    def reset(self):
        with self._lock:
            self._value = 0


class Gauge(Instrument):
    """Last-written value plus running min/max/count, for quantities
    that go up and down (samples/sec, loss scale, queue depth)."""

    kind = "gauge"

    def __init__(self, name, registry=None):
        super().__init__(name, registry)
        self.reset()

    def set(self, value):
        value = float(value)
        with self._lock:
            self._value = value
            self._count += 1
            self._min = value if self._min is None else min(self._min, value)
            self._max = value if self._max is None else max(self._max, value)

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"kind": "gauge", "name": self.name, "value": self._value,
                "count": self._count, "min": self._min, "max": self._max}

    def reset(self):
        with self._lock:
            self._value = None
            self._count = 0
            self._min = None
            self._max = None


# Power-of-2 latency buckets from 1us to ~134s; le-style upper bounds in
# seconds.  Fixed so two runs' histograms merge by index.
_TIMER_BUCKETS = tuple(1e-6 * (2 ** i) for i in range(28))


class Timer(Instrument):
    """Duration histogram: count/sum/min/max plus fixed power-of-2
    buckets.  Each observation also streams to the attached sinks as a
    ``sample`` record -- timers sit on low-frequency paths (steps,
    compiles, collectives, batch waits), so per-observation streaming is
    affordable and gives the JSONL log per-step resolution."""

    kind = "timer"

    def __init__(self, name, registry=None):
        super().__init__(name, registry)
        self.reset()

    def observe(self, seconds, **fields):
        seconds = float(seconds)
        with self._lock:
            self._count += 1
            self._sum += seconds
            self._min = seconds if self._min is None \
                else min(self._min, seconds)
            self._max = seconds if self._max is None \
                else max(self._max, seconds)
            # first bucket whose upper bound holds the observation
            idx = min(bisect.bisect_left(_TIMER_BUCKETS, seconds),
                      len(_TIMER_BUCKETS) - 1)
            self._buckets[idx] += 1
        self._stream("sample", value=seconds, **fields)

    def time(self, **fields):
        """``with timer.time(): ...`` convenience."""
        return _TimerContext(self, fields)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q):
        """Histogram-estimated q-quantile (0 < q <= 1): the upper bound
        of the bucket where the cumulative count crosses ``q * count``,
        clamped into [min, max] so single-observation timers report the
        observation itself rather than a bucket edge."""
        with self._lock:
            count = self._count
            if not count:
                return None
            rank = q * count
            acc = 0
            est = self._max
            for bound, n in zip(_TIMER_BUCKETS, self._buckets):
                acc += n
                if acc >= rank:
                    est = bound
                    break
            return min(max(est, self._min), self._max)

    def _percentiles(self):
        return {"p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}

    def snapshot(self):
        return {"kind": "timer", "name": self.name, "count": self._count,
                "sum": self._sum, "min": self._min, "max": self._max,
                "mean": (self._sum / self._count) if self._count else None,
                **self._percentiles(),
                "buckets": {("%g" % b): n for b, n in
                            zip(_TIMER_BUCKETS, self._buckets) if n}}

    def reset(self):
        with self._lock:
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None
            self._buckets = [0] * len(_TIMER_BUCKETS)


class _TimerContext:
    __slots__ = ("_timer", "_fields", "_t0")

    def __init__(self, timer, fields):
        self._timer = timer
        self._fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.observe(time.perf_counter() - self._t0, **self._fields)


class Event(Instrument):
    """Structured occurrences with a payload dict (retraces, AMP
    overflows, checkpoints).  Keeps a bounded ring of recent payloads
    and streams every emit to the sinks."""

    kind = "event"

    def __init__(self, name, registry=None):
        super().__init__(name, registry)
        self.reset()

    def emit(self, **payload):
        with self._lock:
            self._count += 1
            self._ring.append(payload)
            if len(self._ring) > _EVENT_RING:
                del self._ring[0]
        self._stream("event", payload=payload)

    @property
    def count(self):
        return self._count

    @property
    def recent(self):
        return list(self._ring)

    def snapshot(self):
        return {"kind": "event", "name": self.name, "count": self._count,
                "last_payload": self._ring[-1] if self._ring else None}

    def reset(self):
        with self._lock:
            self._count = 0
            self._ring = []


_KINDS = {"counter": Counter, "gauge": Gauge, "timer": Timer,
          "event": Event}


class Registry:
    """Thread-safe name -> instrument store with attached sinks.

    One process-global instance lives in ``telemetry/__init__.py``;
    tests may build private registries.  Sinks receive streamed records
    (event emits, timer samples) as they happen and the full snapshot at
    ``flush()``.
    """

    def __init__(self):
        self._lock = _sync.Lock(name="telemetry.registry")
        self._instruments = {}
        self._sinks = []

    # -- typed get-or-create ------------------------------------------
    def _get(self, cls, name):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, registry=self)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise ValueError(
                "telemetry instrument %r already exists as %s, not %s"
                % (name, inst.kind, cls.kind))
        return inst

    def counter(self, name) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name) -> Gauge:
        return self._get(Gauge, name)

    def timer(self, name) -> Timer:
        return self._get(Timer, name)

    def event(self, name) -> Event:
        return self._get(Event, name)

    def get(self, name):
        return self._instruments.get(name)

    def names(self):
        return sorted(self._instruments)

    # -- sinks ---------------------------------------------------------
    def attach(self, sink):
        with self._lock:
            self._sinks.append(sink)
        return sink

    def detach(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def _stream(self, record):
        for sink in self._sinks:
            write = getattr(sink, "write", None)
            if write is not None:
                write(record)

    # -- snapshot / lifecycle -----------------------------------------
    def snapshot(self):
        """List of per-instrument snapshot dicts, sorted by name."""
        with self._lock:
            insts = sorted(self._instruments.items())
        return [inst.snapshot() for _name, inst in insts]

    def flush(self):
        """Push the aggregate snapshot through every sink that keeps a
        file (JSONL) and flush it."""
        snap = self.snapshot()
        now = time.time()
        for rec in snap:
            self._stream({"t": now, **rec, "kind": "snapshot."
                          + rec["kind"]})
        for sink in list(self._sinks):
            fl = getattr(sink, "flush", None)
            if fl is not None:
                fl()

    def reset(self, prefix=None):
        """Zero every instrument (or only names under ``prefix``).
        Instruments stay registered so live references keep working."""
        with self._lock:
            insts = list(self._instruments.items())
        for name, inst in insts:
            if prefix is None or name.startswith(prefix):
                inst.reset()

    def clear(self, prefix=None):
        """Drop instruments entirely (tests)."""
        with self._lock:
            if prefix is None:
                self._instruments.clear()
            else:
                for name in [n for n in self._instruments
                             if n.startswith(prefix)]:
                    del self._instruments[name]
