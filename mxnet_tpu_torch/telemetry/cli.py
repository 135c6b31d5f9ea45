"""``python -m mxnet_tpu_torch.telemetry`` (``mxtelemetry``) -- offline
analysis of telemetry JSONL run logs and flight-recorder black boxes
(counterpart of ``mxnet_tpu/telemetry/cli.py``: the same text from the
same files, whichever package wrote them).

Subcommands:

- ``summarize run.jsonl [more_rank_files...]`` -- aggregate one run log
  (steps, compiles, kvstore, feed, serving, spans); given SEVERAL rank
  files from one multi-host run, also emits per-rank step-time skew and
  a straggler flag (max/median mean-step wall past ``--skew-threshold``)
  -- a skew instrument for multi-process runs.
- ``blackbox crash.bbox`` -- render a flight-recorder ring
  (``mx.obs.flight``): the final records before the process died.
- ``fleet <endpoints-dir | url...>`` -- scrape the live fleet
  (``obs.fleet``): the per-replica table, pooled SLO aggregates and the
  alert state, the JAX CLI's text for the same snapshots.

Exit 0 on success with ``--json`` for machine-readable output, exit 1
when the log is missing/empty -- and, for ``fleet``, while ANY alert
fires or no replica answered -- exit 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from .sinks import _fmt_secs, prom_text, summary_table

__all__ = ["main", "summarize_file", "summarize_files"]

# Exact-percentile bound: past this many streamed samples per timer the
# tail is dropped from the percentile pool (count/sum/min/max stay
# exact) -- an offline summarizer must not grow with run length.
_MAX_PCTL_SAMPLES = 200_000


def _exact_percentiles(values):
    """p50/p95/p99 (nearest-rank) from exact sample values."""
    if not values:
        return {}
    values = sorted(values)
    n = len(values)

    def rank(q):
        return values[min(n - 1, max(0, int(round(q * n)) - 1))]

    return {"p50": rank(0.50), "p95": rank(0.95), "p99": rank(0.99)}


def _build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.telemetry",
        description="Summarize a telemetry JSONL run log "
                    "(mx.telemetry).")
    sub = ap.add_subparsers(dest="cmd")
    sm = sub.add_parser("summarize", help="aggregate run.jsonl file(s)")
    sm.add_argument("paths", nargs="+", metavar="path",
                    help="telemetry JSONL file(s) "
                         "(MXNET_TPU_TELEMETRY_JSONL); several files = "
                         "per-rank skew analysis")
    sm.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable aggregate")
    sm.add_argument("--prom", action="store_true",
                    help="Prometheus text exposition instead of the "
                         "console table (single file only)")
    sm.add_argument("--skew-threshold", type=float, default=1.25,
                    help="straggler flag threshold on max/median "
                         "mean-step wall across rank files "
                         "(default 1.25)")
    bb = sub.add_parser("blackbox",
                        help="render a flight-recorder ring "
                             "(mx.obs.flight / MXNET_TPU_OBS_BLACKBOX)")
    bb.add_argument("path", help="flight-recorder file")
    bb.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable record list")
    bb.add_argument("--last", type=int, default=40,
                    help="records to show in the human rendering "
                         "(default 40)")
    fl = sub.add_parser("fleet",
                        help="scrape and render the live fleet "
                             "(mx.obs.fleet / "
                             "MXNET_TPU_OBS_ENDPOINTS_DIR)")
    fl.add_argument("source", nargs="+", metavar="dir-or-url",
                    help="ONE endpoints directory, or one or more "
                         "http:// replica base URLs")
    fl.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable fleet snapshot + alerts")
    fl.add_argument("--rounds", type=int, default=2,
                    help="scrape rounds before rendering (>= 2 so "
                         "rate/ratio deltas exist; default 2)")
    fl.add_argument("--interval-ms", type=float, default=None,
                    help="inter-round interval (default "
                         "MXNET_TPU_OBS_SCRAPE_MS)")
    return ap


def summarize_file(path):
    """Aggregate one JSONL run log into a dict.

    Streamed ``event``/``sample`` records are folded per name; trailing
    ``snapshot.*`` records (written by ``telemetry.flush()``) win over
    the folds for the instruments they cover, since they carry the
    authoritative counts.  Returns the aggregate; raises OSError when
    the file cannot be read.
    """
    counters, gauges, timers, events = {}, {}, {}, {}
    sample_folds = {}
    event_folds = {}
    span_folds = {}
    records = skipped = 0
    rank = None
    goodput_active = None     # last goodput.window payload WITH steps
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                kind = rec["kind"]
                name = rec["name"]
            except (ValueError, KeyError, TypeError):
                skipped += 1
                continue
            records += 1
            if rank is None and isinstance(rec.get("rank"), int):
                rank = rec["rank"]
            if kind == "span":
                agg = span_folds.setdefault(
                    name, {"count": 0, "sum": 0.0, "min": None,
                           "max": None})
                d = float(rec.get("dur", 0.0))
                agg["count"] += 1
                agg["sum"] += d
                agg["min"] = d if agg["min"] is None \
                    else min(agg["min"], d)
                agg["max"] = d if agg["max"] is None \
                    else max(agg["max"], d)
            elif kind == "sample":
                agg = sample_folds.setdefault(
                    name, {"count": 0, "sum": 0.0, "min": None,
                           "max": None, "values": [], "t_first": None,
                           "t_last": None})
                v = float(rec.get("value", 0.0))
                agg["count"] += 1
                agg["sum"] += v
                agg["min"] = v if agg["min"] is None else min(agg["min"], v)
                agg["max"] = v if agg["max"] is None else max(agg["max"], v)
                if len(agg["values"]) < _MAX_PCTL_SAMPLES:
                    agg["values"].append(v)
                t = rec.get("t")
                if isinstance(t, (int, float)):
                    if agg["t_first"] is None:
                        agg["t_first"] = t
                    agg["t_last"] = t
            elif kind == "event":
                agg = event_folds.setdefault(
                    name, {"count": 0, "last_payload": None})
                agg["count"] += 1
                agg["last_payload"] = rec.get("payload")
                # the goodput verdict must come from the last ACTIVE
                # window -- a zero-step tail flush (trainer close,
                # serving-only lull) reads "idle" and must not mask it
                if name == "goodput.window" \
                        and isinstance(rec.get("payload"), dict) \
                        and rec["payload"].get("steps"):
                    goodput_active = rec["payload"]
            elif kind == "snapshot.counter":
                counters[name] = rec.get("value", 0)
            elif kind == "snapshot.gauge":
                if rec.get("value") is not None:
                    gauges[name] = {k: rec.get(k) for k in
                                    ("value", "count", "min", "max")}
            elif kind == "snapshot.timer":
                timers[name] = {k: rec.get(k) for k in
                                ("count", "sum", "min", "max", "mean",
                                 "p50", "p95", "p99")
                                if rec.get(k) is not None}
            elif kind == "snapshot.event":
                events[name] = {"count": rec.get("count", 0),
                                "last_payload": rec.get("last_payload")}
            else:
                skipped += 1
    # streamed folds fill in anything the final snapshot missed (e.g. a
    # run killed before flush) -- and, because they carry the exact
    # sample values, they upgrade every snapshot timer's
    # histogram-estimated percentiles to exact ones
    for name, agg in sample_folds.items():
        pctl = _exact_percentiles(agg.pop("values"))
        span = (agg.pop("t_last") or 0) - (agg.pop("t_first") or 0)
        rate = (agg["count"] - 1) / span \
            if span > 0 and agg["count"] > 1 else None
        if name not in timers:
            timers[name] = {**agg, "mean": (agg["sum"] / agg["count"])
                            if agg["count"] else None}
        timers[name].update(pctl)
        if rate is not None:
            timers[name]["rate_per_sec"] = round(rate, 2)
    for name, agg in event_folds.items():
        if name not in events:
            events[name] = agg

    step = timers.get("trainer.step_time", {})
    spsec = gauges.get("trainer.samples_per_sec", {})
    compile_ev = events.get("compile", {})
    result = {
        "file": path,
        "rank": rank,
        "records": records,
        "skipped": skipped,
        "spans": {name: {**agg,
                         "mean": (agg["sum"] / agg["count"])
                         if agg["count"] else None}
                  for name, agg in sorted(span_folds.items())},
        "counters": counters,
        "gauges": gauges,
        "timers": timers,
        "events": events,
        "steps": {
            "count": step.get("count", 0),
            "total_s": step.get("sum"),
            "mean_s": step.get("mean"),
            "samples": counters.get("trainer.samples", 0),
            "samples_per_sec": spsec.get("value"),
        },
        "compile": {
            "count": counters.get("compile.count",
                                  compile_ev.get("count", 0)),
            "retraces": counters.get("compile.retraces", 0),
            "build_time_s": timers.get("compile.build_time",
                                       {}).get("sum"),
            "last": compile_ev.get("last_payload"),
        },
        "kvstore": {
            "pushpull": counters.get("kvstore.pushpull", 0),
            "push": counters.get("kvstore.push", 0),
            "pull": counters.get("kvstore.pull", 0),
            "bytes": counters.get("kvstore.bytes", 0),
            "time_s": timers.get("kvstore.time", {}).get("sum"),
        },
        "data": {
            "batches": counters.get("data.batches", 0),
            "wait_s": timers.get("data.wait_time", {}).get("sum"),
            "mean_wait_s": timers.get("data.wait_time", {}).get("mean"),
        },
        "feed": {
            "batches": counters.get("feed.batches", 0),
            "bytes_staged": counters.get("feed.bytes_staged", 0),
            "producer_busy_s": timers.get("feed.producer_busy",
                                          {}).get("sum"),
            "consumer_wait_s": timers.get("feed.consumer_wait",
                                          {}).get("sum"),
            "overlap_frac": gauges.get("feed.overlap_frac",
                                       {}).get("value"),
        },
        "serving": _serving_section(counters, timers),
        "goodput": _goodput_section(counters, gauges, timers, events,
                                    goodput_active),
    }
    return result


# the ledger's category order (mirrors obs.goodput.CATEGORIES; literal
# here so offline summarize never imports the obs package)
_GOODPUT_CATEGORIES = ("device_compute", "input_wait", "host_sync",
                       "checkpoint_stall", "recompile", "other")


def _goodput_section(counters, gauges, timers, events,
                     last_active=None):
    """Rollup of the goodput.* instruments (obs.goodput StepLedger):
    per-category attributed seconds (timer sums -- exact across the
    whole run), the latest window's verdict, and the sentinel's
    regression/env-degraded tallies."""
    windows = counters.get("goodput.windows",
                           events.get("goodput.window",
                                      {}).get("count", 0))
    if not windows:
        return {"windows": 0}
    steps = counters.get("goodput.steps", 0)
    cats = {}
    total = 0.0
    for cat in _GOODPUT_CATEGORIES:
        s = timers.get("goodput.%s_s" % cat, {}).get("sum") or 0.0
        cats[cat] = {"total_s": round(s, 6)}
        total += s
    for cat in cats:
        cats[cat]["share"] = round(cats[cat]["total_s"] / total, 4) \
            if total > 0 else None
        cats[cat]["per_step_s"] = round(cats[cat]["total_s"] / steps, 6) \
            if steps else None
    last = last_active \
        or events.get("goodput.window", {}).get("last_payload") or {}
    return {
        "windows": windows,
        "steps": steps,
        "wall_s": round(total, 6),
        "categories": cats,
        "mfu": gauges.get("goodput.mfu", {}).get("value"),
        "verdict": last.get("verdict"),
        "bound": last.get("bound"),
        "reconciliation_error":
        gauges.get("goodput.reconciliation_error", {}).get("value"),
        "regressions": counters.get("goodput.regressions", 0),
        "last_regression": events.get("goodput.regression",
                                      {}).get("last_payload"),
        "env_degraded_windows":
        counters.get("goodput.env_degraded_windows", 0),
    }


def _serving_section(counters, timers):
    """SLO rollup of the serving.* instruments."""
    requests = counters.get("serving.requests", 0)
    batches = counters.get("serving.batches", 0)
    responses = counters.get("serving.responses", 0)
    lat = timers.get("serving.latency", {})
    return {
        "requests": requests,
        "responses": responses,
        "batches": batches,
        "mean_occupancy": round(responses / batches, 3) if batches
        else None,
        "shed": counters.get("serving.shed", 0),
        "timeouts": counters.get("serving.timeouts", 0),
        "qps": lat.get("rate_per_sec"),
        "latency_p50_s": lat.get("p50"),
        "latency_p95_s": lat.get("p95"),
        "latency_p99_s": lat.get("p99"),
        "latency_mean_s": lat.get("mean"),
        "swaps": counters.get("serving.swaps", 0),
        "swap_failures": counters.get("serving.swap_failures", 0),
        "compile_cache_hits": counters.get("serving.compile_cache_hits",
                                           0),
        "compile_cache_misses":
        counters.get("serving.compile_cache_misses", 0),
        "compile_evictions": counters.get("serving.compile_evictions", 0),
    }


def summarize_files(paths, skew_threshold=1.25):
    """Aggregate SEVERAL rank files from one multi-host run: per-rank
    step statistics plus the skew verdict (straggler flag when the
    slowest rank's mean step wall exceeds ``skew_threshold`` x the
    median) -- GSPMD steps are lockstep, so a straggler rank drags
    every rank's wall; this names it."""
    per_rank = []
    records = 0
    for i, path in enumerate(paths):
        agg = summarize_file(path)
        records += agg["records"]
        st = agg["steps"]
        rank = agg["rank"] if agg["rank"] is not None else i
        gp = agg.get("goodput") or {}
        per_rank.append({
            "file": path,
            "rank": rank,
            "records": agg["records"],
            "steps": st["count"],
            "mean_step_s": st["mean_s"],
            "total_step_s": st["total_s"],
            "samples_per_sec": st["samples_per_sec"],
            # per-step goodput category seconds (None without a ledger)
            "goodput": {cat: c["per_step_s"]
                        for cat, c in gp.get("categories", {}).items()}
            if gp.get("windows") else None,
        })
    means = sorted(r["mean_step_s"] for r in per_rank
                   if r["mean_step_s"])
    skew = None
    stragglers = []
    if means:
        # lower-middle for even counts: with 2 ranks the healthy one is
        # the reference, so a straggler pair reads as skewed, not 1.0
        median = means[(len(means) - 1) // 2]
        worst = means[-1]
        skew = (worst / median) if median else None
        if skew is not None:
            stragglers = sorted(
                r["rank"] for r in per_rank
                if r["mean_step_s"]
                and median
                and r["mean_step_s"] / median > skew_threshold)
    return {
        "files": list(paths),
        "records": records,
        "ranks": per_rank,
        "skew": {
            "max_over_median": round(skew, 4) if skew else None,
            "threshold": skew_threshold,
            "straggler": bool(stragglers),
            "straggler_ranks": stragglers,
            # name WHICH goodput category differs
            # on the slow rank, not just that it is slow
            "category_attribution": _straggler_categories(per_rank,
                                                          stragglers),
        },
    }


def _straggler_categories(per_rank, stragglers):
    """For each straggler rank, the goodput category whose per-step
    seconds deviate most from the cross-rank median -- e.g. "rank 2
    input_wait 3.1x median".  Empty when no rank carries ledger data
    (the skew verdict itself still works from step timers alone)."""
    ranks_with = [r for r in per_rank if r.get("goodput")]
    if not stragglers or len(ranks_with) < 2:
        return []
    medians = {}
    for cat in _GOODPUT_CATEGORIES:
        vals = sorted(r["goodput"].get(cat) or 0.0 for r in ranks_with)
        medians[cat] = vals[(len(vals) - 1) // 2]
    out = []
    for r in ranks_with:
        if r["rank"] not in stragglers:
            continue
        best = None
        for cat in _GOODPUT_CATEGORIES:
            if cat == "other":
                continue
            v = r["goodput"].get(cat) or 0.0
            ratio = v / max(medians[cat], 1e-9)
            if v > medians[cat] and (best is None
                                     or ratio > best["ratio"]):
                best = {"rank": r["rank"], "category": cat,
                        "per_step_s": round(v, 6),
                        "median_per_step_s": round(medians[cat], 6),
                        "ratio": round(min(ratio, 999.0), 2)}
        if best is not None:
            out.append(best)
    return out


def _render_ranks(agg):
    lines = ["telemetry rank summary: %d files (%d records)"
             % (len(agg["files"]), agg["records"]), "",
             "  %-6s %-8s %-12s %-12s %s"
             % ("rank", "steps", "mean step", "total", "file"),
             "  " + "-" * 68]
    for r in agg["ranks"]:
        lines.append("  %-6s %-8d %-12s %-12s %s"
                     % (r["rank"], r["steps"],
                        _fmt_secs(r["mean_step_s"]),
                        _fmt_secs(r["total_step_s"]), r["file"]))
    sk = agg["skew"]
    if sk["max_over_median"] is not None:
        lines.append("")
        lines.append(
            "  step-time skew max/median = %.3f (threshold %.2f): %s"
            % (sk["max_over_median"], sk["threshold"],
               "STRAGGLER rank(s) %s" % sk["straggler_ranks"]
               if sk["straggler"] else "balanced"))
        for attr in sk.get("category_attribution") or ():
            lines.append(
                "  rank %s slow: %s %.1fx median "
                "(%.1fms vs %.1fms per step)"
                % (attr["rank"], attr["category"], attr["ratio"],
                   1e3 * attr["per_step_s"],
                   1e3 * attr["median_per_step_s"]))
    return "\n".join(lines)


def _render_blackbox(records, path, last):
    t_end = max((r.get("t") for r in records
                 if isinstance(r.get("t"), (int, float))),
                default=None)
    shown = records[-last:] if last and last > 0 else records
    lines = ["blackbox: %s (%d records, showing last %d)"
             % (path, len(records), len(shown))]
    for r in shown:
        t = r.get("t")
        rel = ("%+.3fs" % (t - t_end)) \
            if t_end is not None and isinstance(t, (int, float)) \
            else "?"
        kind = r.get("kind", "?")
        name = r.get("name", "?")
        if kind == "span":
            detail = "dur=%s trace=%s" % (_fmt_secs(r.get("dur")),
                                          r.get("trace"))
        elif kind == "event":
            detail = json.dumps(r.get("payload"), default=str)[:120]
        elif kind == "sample":
            detail = "value=%s" % _fmt_secs(r.get("value"))
        else:
            detail = json.dumps({k: v for k, v in r.items()
                                 if k not in ("kind", "name", "t")},
                                default=str)[:120]
        lines.append("  %-10s %-8s %-34s %s" % (rel, kind, name,
                                                detail))
    return "\n".join(lines)


def _to_snapshot(agg):
    """Rebuild a Registry.snapshot()-shaped list from an aggregate so
    the offline CLI reuses the live renderers."""
    snap = []
    for name, value in sorted(agg["counters"].items()):
        snap.append({"kind": "counter", "name": name, "value": value})
    for name, g in sorted(agg["gauges"].items()):
        snap.append({"kind": "gauge", "name": name, **g})
    for name, t in sorted(agg["timers"].items()):
        snap.append({"kind": "timer", "name": name, "buckets": {}, **t})
    for name, e in sorted(agg["events"].items()):
        snap.append({"kind": "event", "name": name, **e})
    return snap


def _render_human(agg):
    lines = ["telemetry summary: %s (%d records)"
             % (agg["file"], agg["records"]), ""]
    st = agg["steps"]
    if st["count"]:
        sps = st["samples_per_sec"]
        lines.append(
            "  steps: %d in %.3fs (mean %.1fms)%s"
            % (st["count"], st["total_s"] or 0.0,
               1e3 * (st["mean_s"] or 0.0),
               ", %.1f samples/sec" % sps if sps else ""))
    cp = agg["compile"]
    if cp["count"]:
        lines.append("  compiles: %d (%d retraces, %.3fs building)"
                     % (cp["count"], cp["retraces"],
                        cp["build_time_s"] or 0.0))
    kv = agg["kvstore"]
    if kv["pushpull"] or kv["push"] or kv["pull"]:
        lines.append("  kvstore: %d pushpull / %d push / %d pull, "
                     "%d bytes" % (kv["pushpull"], kv["push"],
                                   kv["pull"], kv["bytes"]))
    da = agg["data"]
    if da["batches"]:
        lines.append("  input: %d batches, %.3fs waiting (mean %.1fms)"
                     % (da["batches"], da["wait_s"] or 0.0,
                        1e3 * (da["mean_wait_s"] or 0.0)))
    sv = agg.get("serving", {})
    if sv.get("requests"):
        occ = sv.get("mean_occupancy")
        lat = [("p%s" % p, sv.get("latency_p%s_s" % p))
               for p in (50, 95, 99)]
        lat_txt = " ".join("%s=%.1fms" % (k, 1e3 * v)
                           for k, v in lat if v is not None)
        lines.append(
            "  serving: %d requests in %d batches%s, %d shed / %d "
            "timed out%s%s"
            % (sv["requests"], sv["batches"],
               " (occupancy %.2f)" % occ if occ is not None else "",
               sv["shed"], sv["timeouts"],
               ", %.1f qps" % sv["qps"] if sv.get("qps") else "",
               (", " + lat_txt) if lat_txt else ""))
    fd = agg.get("feed", {})
    if fd.get("batches"):
        lines.append(
            "  feed: %d batches, %d bytes staged, %.3fs producing / "
            "%.3fs waiting%s"
            % (fd["batches"], fd["bytes_staged"],
               fd["producer_busy_s"] or 0.0, fd["consumer_wait_s"] or 0.0,
               ", overlap %.1f%%" % (100 * fd["overlap_frac"])
               if fd.get("overlap_frac") is not None else ""))
    gp = agg.get("goodput") or {}
    if gp.get("windows"):
        shares = ", ".join(
            "%s %.0f%%" % (cat, 100 * gp["categories"][cat]["share"])
            for cat in _GOODPUT_CATEGORIES
            if gp["categories"][cat]["share"])
        lines.append(
            "  goodput: %d windows / %d steps%s%s%s"
            % (gp["windows"], gp["steps"],
               " (%s)" % shares if shares else "",
               ", mfu %.3f" % gp["mfu"] if gp.get("mfu") is not None
               else "",
               ", %d regressions" % gp["regressions"]
               if gp.get("regressions") else ""))
        if gp.get("verdict"):
            # THE bottleneck verdict line, e.g. "input-bound: feed
            # supplies 54% of device demand"
            lines.append("  bottleneck: %s%s"
                         % (gp["verdict"],
                            " [env degraded: %d windows]"
                            % gp["env_degraded_windows"]
                            if gp.get("env_degraded_windows") else ""))
    spn = agg.get("spans") or {}
    if spn:
        lines.append("  spans: %d recorded over %d names (top: %s)"
                     % (sum(v["count"] for v in spn.values()), len(spn),
                        ", ".join(sorted(
                            spn, key=lambda n: -spn[n]["count"])[:4])))
    lines.append("")
    lines.append(summary_table(_to_snapshot(agg)))
    return "\n".join(lines)


def _main_blackbox(args):
    from ..obs import flight
    from ..base import MXNetError
    try:
        records = flight.read(args.path)
    except OSError as e:
        print("cannot read %s: %s" % (args.path, e), file=sys.stderr)
        return 1
    except MXNetError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not records:
        print("no records in %s" % args.path, file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(records, indent=2, default=str))
    else:
        print(_render_blackbox(records, args.path, args.last))
    return 0


def _main_fleet(args):
    """``mxtelemetry fleet``: poll the fleet ``--rounds`` times and
    render the table + alerts.  Exit 0 healthy, 1 while ANY alert
    fires (the pageable condition) or when nothing was scrapeable, 2 on
    usage errors."""
    import os as _os
    import time as _time
    from ..obs.fleet import FleetMonitor
    dirs = [s for s in args.source if not s.startswith("http")]
    urls = [s for s in args.source if s.startswith("http")]
    if dirs and urls:
        print("fleet: mixing an endpoints dir and URLs is ambiguous; "
              "pass one or the other", file=sys.stderr)
        return 2
    if len(dirs) > 1:
        print("fleet: exactly one endpoints directory", file=sys.stderr)
        return 2
    if dirs and not _os.path.isdir(dirs[0]):
        print("fleet: %s is not a directory" % dirs[0], file=sys.stderr)
        return 2
    mon = FleetMonitor(dirs[0] if dirs else urls,
                       scrape_ms=args.interval_ms)
    try:
        rounds = max(int(args.rounds), 1)
        for i in range(rounds):
            if i:
                _time.sleep(mon.scrape_s)
            snap = mon.poll_once()
        if args.as_json:
            print(json.dumps({"fleet": snap,
                              "alerts": mon.engine.alertz()},
                             indent=2, sort_keys=True, default=str))
        else:
            print(mon.table())
        if mon.engine.firing():
            return 1
        if not any(r["state"] in ("ok", "init")
                   for r in snap["replicas"]):
            print("fleet: no scrapeable replica in %s"
                  % " ".join(args.source), file=sys.stderr)
            return 1
        return 0
    finally:
        mon.close()


def main(argv=None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "blackbox":
        return _main_blackbox(args)
    if args.cmd == "fleet":
        return _main_fleet(args)
    if args.cmd != "summarize":
        ap.print_usage()
        return 2
    multi = len(args.paths) > 1
    try:
        agg = summarize_files(args.paths, args.skew_threshold) \
            if multi else summarize_file(args.paths[0])
    except OSError as e:
        print("cannot read: %s" % e, file=sys.stderr)
        return 1
    if not agg["records"]:
        print("no telemetry records in %s" % " ".join(args.paths),
              file=sys.stderr)
        return 1
    try:
        if args.as_json:
            print(json.dumps(agg, indent=2, sort_keys=True))
        elif multi:
            print(_render_ranks(agg))
        elif args.prom:
            print(prom_text(_to_snapshot(agg)), end="")
        else:
            print(_render_human(agg))
    except BrokenPipeError:
        # downstream pager/head closed early: that's a success, not a
        # stack trace.  Point stdout at devnull so interpreter teardown
        # doesn't re-raise on the final flush.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
