"""The three shipped telemetry sinks (counterpart of
``mxnet_tpu/telemetry/sinks.py``).

- ``JsonlSink``: append-only run log.  Streamed records (event emits,
  timer samples) land as they happen; ``Registry.flush()`` appends the
  aggregate snapshot, so the file is both a timeline and a summary.
- ``prom_text``: Prometheus text exposition of a snapshot -- scrapeable
  or diffable, one metric family per instrument.
- ``summary_table``: human console table (the ``telemetry.summary()``
  surface).

All three consume the same ``Registry.snapshot()`` record shape, and the
records are the JAX package's, so a JSONL file from either package
renders through both.
"""
from __future__ import annotations

import json
import os
import re

from .. import sync as _sync

__all__ = ["JsonlSink", "prom_text", "summary_table"]


def _default_rank():
    """This process's rank per the launcher env (0 single-process) --
    every JSONL record is tagged with it so multi-host runs can be
    merged offline."""
    try:
        return int(os.environ.get("MXNET_TPU_PROC_ID", "0") or 0)
    except ValueError:
        return 0


class JsonlSink:
    """Append telemetry records to ``path`` as one JSON object per line.

    Writes are line-buffered under a lock (instrument hooks may fire
    from DataLoader worker threads); ``flush()`` fsyncs nothing -- a
    telemetry log is advisory, not a WAL.  Every record carries this
    process's ``rank`` (``MXNET_TPU_PROC_ID``), so rank files from one
    multi-host run stay attributable after a merge.
    """

    def __init__(self, path, rank=None):
        self.path = path
        self.rank = _default_rank() if rank is None else int(rank)
        self._lock = _sync.Lock(name="telemetry.jsonl_sink")
        self._f = open(path, "a")

    def write(self, record):
        if "rank" not in record:
            record = dict(record, rank=self.rank)
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


def _json_default(obj):
    """Payloads may carry numpy scalars or dtype objects; degrade to
    strings rather than refuse to log."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    return "mxnet_tpu_" + _PROM_BAD.sub("_", name)


def prom_text(snapshot):
    """Render a ``Registry.snapshot()`` list as Prometheus text
    exposition (counters/gauges verbatim; timers as ``_count``/``_sum``
    summaries plus ``le``-labeled buckets; events as counters)."""
    lines = []
    for rec in snapshot:
        kind = rec["kind"].replace("snapshot.", "")
        base = _prom_name(rec["name"])
        if kind == "counter":
            lines.append("# TYPE %s counter" % base)
            lines.append("%s %s" % (base, rec["value"]))
        elif kind == "gauge":
            if rec.get("value") is None:
                continue
            lines.append("# TYPE %s gauge" % base)
            lines.append("%s %s" % (base, rec["value"]))
        elif kind == "timer":
            lines.append("# TYPE %s histogram" % base)
            lines.append("%s_count %s" % (base, rec["count"]))
            lines.append("%s_sum %s" % (base, rec["sum"]))
            acc = 0
            for le, n in sorted(rec.get("buckets", {}).items(),
                                key=lambda kv: float(kv[0])):
                acc += n
                lines.append('%s_bucket{le="%s"} %d' % (base, le, acc))
            lines.append('%s_bucket{le="+Inf"} %d' % (base, rec["count"]))
            # quantile series off the histogram estimator: scrapers
            # get p50/p95/p99 without replaying the buckets
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = rec.get(key)
                if v is not None:
                    lines.append('%s{quantile="%s"} %s' % (base, q, v))
        elif kind == "event":
            lines.append("# TYPE %s counter" % base)
            lines.append("%s %s" % (base, rec["count"]))
    return "\n".join(lines) + ("\n" if lines else "")


def _fmt_secs(s):
    if s is None:
        return "-"
    if s >= 1.0:
        return "%.3fs" % s
    if s >= 1e-3:
        return "%.2fms" % (s * 1e3)
    return "%.1fus" % (s * 1e6)


def summary_table(snapshot):
    """Console table over a snapshot, grouped by instrument kind."""
    groups = {"counter": [], "gauge": [], "timer": [], "event": []}
    for rec in snapshot:
        kind = rec["kind"].replace("snapshot.", "")
        if kind in groups:
            groups[kind].append(rec)
    out = []

    def header(title, cols):
        out.append(title)
        out.append("  %-44s %s" % cols)
        out.append("  " + "-" * 68)

    if groups["counter"]:
        header("counters", ("name", "value"))
        for r in groups["counter"]:
            out.append("  %-44s %d" % (r["name"], r["value"]))
        out.append("")
    if groups["gauge"]:
        header("gauges", ("name", "last (min/max over n)"))
        for r in groups["gauge"]:
            if r.get("value") is None:
                continue
            out.append("  %-44s %.4g (%.4g/%.4g over %d)"
                       % (r["name"], r["value"], r["min"], r["max"],
                          r["count"]))
        out.append("")
    if groups["timer"]:
        header("timers",
               ("name", "count  mean  p50  p95  p99  min  max  total"))
        for r in groups["timer"]:
            out.append("  %-44s %-6d %s  %s  %s  %s  %s  %s  %s"
                       % (r["name"], r["count"], _fmt_secs(r.get("mean")),
                          _fmt_secs(r.get("p50")), _fmt_secs(r.get("p95")),
                          _fmt_secs(r.get("p99")),
                          _fmt_secs(r.get("min")), _fmt_secs(r.get("max")),
                          _fmt_secs(r.get("sum"))))
        out.append("")
    if groups["event"]:
        header("events", ("name", "count  last payload"))
        for r in groups["event"]:
            payload = r.get("last_payload")
            out.append("  %-44s %-6d %s"
                       % (r["name"], r["count"],
                          json.dumps(payload, default=_json_default)
                          if payload else "-"))
        out.append("")
    return "\n".join(out) if out else "(no telemetry recorded)\n"
