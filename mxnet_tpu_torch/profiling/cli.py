"""``mxprof`` -- render and diff step cost reports (counterpart of
``mxnet_tpu/profiling/cli.py``; reports of either package render and
diff alike).

Contract mirrors mxlint/mxtelemetry: exit 0 on success, 1 when the
gate fails (no reports found; drift detected by ``diff``), 2 on usage
or unreadable-input errors.  ``--json`` keeps every mode
machine-readable.

::

    mxprof report --dir mxprof_reports            # human tables
    mxprof report --dir mxprof_reports --json     # combined dict
    mxprof diff old/report.json new/report.json   # exit 1 + named
                                                  # categories on drift
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .aten import CATEGORIES
from .store import COMBINED_NAME, COMBINED_SCHEMA
from .cost import SCHEMA as REPORT_SCHEMA

__all__ = ["main", "load_report", "diff_reports"]

# fields compared per category and per report by ``diff``
_DIFF_TOL_DEFAULT = 0.02


def _fmt_flops(v):
    for unit, div in (("PFLOP", 1e15), ("TFLOP", 1e12), ("GFLOP", 1e9),
                      ("MFLOP", 1e6), ("kFLOP", 1e3)):
        if v >= div:
            return "%.2f %s" % (v / div, unit)
    return "%.0f FLOP" % v


def _fmt_bytes(v):
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if v >= div:
            return "%.2f %s" % (v / div, unit)
    return "%d B" % v


def load_report(path):
    """Load a combined report or a single CostReport; both normalize
    to the combined shape so ``report``/``diff`` handle either."""
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") == COMBINED_SCHEMA:
        return data
    if data.get("schema") == REPORT_SCHEMA:
        return {
            "schema": COMBINED_SCHEMA,
            "steps": ({data["label"]: data["step"]} if data.get("step")
                      else {}),
            "executables": [data],
            "totals": {"flops": data["totals"]["flops"],
                       "bytes_accessed": data["totals"]["bytes_accessed"],
                       "peak_hbm_bytes": data["memory"]["peak_hbm_bytes"]},
            "categories": {c: {"flops": v["flops"], "bytes": v["bytes"],
                               "instructions": v["instructions"]}
                           for c, v in data["categories"].items()},
        }
    raise ValueError("%s: unrecognized schema %r"
                     % (path, data.get("schema")))


def _collect(paths, dirpath):
    """Resolve report sources into one combined dict."""
    if paths:
        reps = [load_report(p) for p in paths]
        if len(reps) == 1:
            return reps[0]
        merged = {"schema": COMBINED_SCHEMA, "steps": {},
                  "executables": [], "totals": {"flops": 0.0,
                                                "bytes_accessed": 0.0,
                                                "peak_hbm_bytes": 0},
                  "categories": {}}
        for r in reps:
            merged["steps"].update(r["steps"])
            merged["executables"].extend(r["executables"])
            merged["totals"]["flops"] += r["totals"]["flops"]
            merged["totals"]["bytes_accessed"] += \
                r["totals"]["bytes_accessed"]
            # peak memory merges as MAX, not sum: reports come from
            # separate dispatches whose live sets never coexist, so the
            # combined peak is the worst single program's peak (the
            # same convention as store.combined())
            merged["totals"]["peak_hbm_bytes"] = max(
                merged["totals"]["peak_hbm_bytes"],
                r["totals"]["peak_hbm_bytes"])
            for c, v in r["categories"].items():
                agg = merged["categories"].setdefault(
                    c, {"flops": 0, "bytes": 0, "instructions": 0})
                for k in agg:
                    agg[k] += v.get(k, 0)
        return merged
    comb = os.path.join(dirpath, COMBINED_NAME)
    if os.path.isfile(comb):
        return load_report(comb)
    singles = sorted(glob.glob(os.path.join(dirpath, "*.cost.json")))
    if singles:
        return _collect(singles, dirpath)
    return None


def _render_report(comb):
    lines = ["mxprof report: %d executable(s), %d step label(s)"
             % (len(comb["executables"]), len(comb["steps"]))]
    if comb["steps"]:
        lines.append("")
        lines.append("steps:")
        for label, st in sorted(comb["steps"].items()):
            if not st or not st.get("count"):
                continue
            lines.append("  %-36s count %-5d mean %8.2fms  "
                         "min %.2fms max %.2fms"
                         % (label, st["count"],
                            1e3 * st["total_s"] / st["count"],
                            1e3 * (st["min_s"] or 0),
                            1e3 * (st["max_s"] or 0)))
    lines.append("")
    lines.append("executables:")
    lines.append("  %-36s %-16s %12s %12s %12s  %s"
                 % ("label", "fingerprint", "flops", "bytes",
                    "peak HBM", "top category"))
    for rep in comb["executables"]:
        top = max(rep["categories"],
                  key=lambda c: rep["categories"][c]["flops"])
        bound = ""
        rl = rep.get("roofline")
        if rl and top in rl["categories"]:
            bound = " (%s-bound%s)" % (
                rl["categories"][top]["bound"],
                ", peaks assumed" if rl["peaks_assumed"] else "")
        lines.append("  %-36s %-16s %12s %12s %12s  %s%s"
                     % (rep["label"][:36], rep["fingerprint"],
                        _fmt_flops(rep["totals"]["flops"]),
                        _fmt_bytes(rep["totals"]["bytes_accessed"]),
                        _fmt_bytes(rep["memory"]["peak_hbm_bytes"]),
                        top, bound))
        if rl:
            lines.append("    roofline: mfu %.3f, bw util %.3f, "
                         "floor %.2fms vs measured %.2fms"
                         % (rl["mfu"], rl["bandwidth_util"],
                            1e3 * rl["floor_step_s"],
                            1e3 * rl["step_time_s"]))
            for cat in CATEGORIES:
                cv = rl["categories"].get(cat)
                if cv:
                    lines.append("      %-20s %7s-bound  "
                                 "time share %5.1f%%"
                                 % (cat, cv["bound"],
                                    100 * cv["time_share"]))
    lines.append("")
    lines.append("totals: flops %s  bytes %s  peak HBM %s (max over "
                 "executables; peaks of separate dispatches never add)"
                 % (_fmt_flops(comb["totals"]["flops"]),
                    _fmt_bytes(comb["totals"]["bytes_accessed"]),
                    _fmt_bytes(comb["totals"]["peak_hbm_bytes"])))
    if comb["categories"]:
        tf = max(comb["totals"]["flops"], 1.0)
        tb = max(comb["totals"]["bytes_accessed"], 1.0)
        lines.append("")
        lines.append("categories (rollup over executables):")
        for cat in CATEGORIES:
            v = comb["categories"].get(cat)
            if not v:
                continue
            lines.append("  %-20s flops %12s (%5.1f%%)  "
                         "bytes %12s (%5.1f%%)  %d instr"
                         % (cat, _fmt_flops(v["flops"]),
                            100 * v["flops"] / tf,
                            _fmt_bytes(v["bytes"]),
                            100 * v["bytes"] / tb,
                            v["instructions"]))
    return "\n".join(lines)


def _rel(old, new):
    return abs(new - old) / max(abs(old), 1.0)


def diff_reports(old, new, tol=_DIFF_TOL_DEFAULT):
    """Compare two combined reports.  Returns a list of drift dicts
    ``{"scope", "category"/"field", "old", "new", "rel"}`` -- empty
    when nothing moved beyond ``tol`` (relative)."""
    drifts = []

    def check(scope, field, o, n):
        r = _rel(o, n)
        if r > tol:
            drifts.append({"scope": scope, "field": field,
                           "old": o, "new": n, "rel": round(r, 4)})

    for cat in CATEGORIES:
        ov = old["categories"].get(cat, {"flops": 0, "bytes": 0})
        nv = new["categories"].get(cat, {"flops": 0, "bytes": 0})
        check("category:" + cat, "flops", ov["flops"], nv["flops"])
        check("category:" + cat, "bytes", ov["bytes"], nv["bytes"])
    check("totals", "flops", old["totals"]["flops"],
          new["totals"]["flops"])
    check("totals", "bytes_accessed", old["totals"]["bytes_accessed"],
          new["totals"]["bytes_accessed"])
    check("totals", "peak_hbm_bytes", old["totals"]["peak_hbm_bytes"],
          new["totals"]["peak_hbm_bytes"])
    # per-label peak HBM: the "one executable regressed" case the
    # rollup can mask when another shrank.  Labels repeat (two Dense
    # layers are two `eager:FullyConnected` programs), so pair by
    # position WITHIN each label group -- a report diffed against
    # itself must always align every executable with itself.
    def by_label(reps):
        groups = {}
        for r in reps:
            groups.setdefault(r["label"], []).append(r)
        return groups
    old_groups = by_label(old["executables"])
    for label, news in by_label(new["executables"]).items():
        for i, rep in enumerate(news):
            olds = old_groups.get(label, [])
            if i >= len(olds):
                continue
            check("executable:" + label, "peak_hbm_bytes",
                  olds[i]["memory"]["peak_hbm_bytes"],
                  rep["memory"]["peak_hbm_bytes"])
    return drifts


def _render_diff(drifts, old_path, new_path, tol):
    if not drifts:
        return "mxprof diff: no drift beyond %.1f%% between %s and %s" \
            % (100 * tol, old_path, new_path)
    lines = ["mxprof diff: %d drift(s) beyond %.1f%% (%s -> %s)"
             % (len(drifts), 100 * tol, old_path, new_path)]
    cats = sorted({d["scope"].split(":", 1)[1] for d in drifts
                   if d["scope"].startswith("category:")})
    if cats:
        lines.append("  drifted categories: %s" % ", ".join(cats))
    for d in drifts:
        lines.append("  %-28s %-16s %15.4g -> %-15.4g (%+.1f%%)"
                     % (d["scope"], d["field"], d["old"], d["new"],
                        100 * (d["new"] - d["old"])
                        / max(abs(d["old"]), 1.0)))
    return "\n".join(lines)


def _build_parser():
    ap = argparse.ArgumentParser(
        prog="mxprof",
        description="Step cost accounting (mx.profiling).")
    sub = ap.add_subparsers(dest="cmd")
    rp = sub.add_parser("report", help="render cost-report artifacts")
    rp.add_argument("paths", nargs="*",
                    help="report.json / *.cost.json files (default: "
                         "--dir discovery)")
    rp.add_argument("--dir", default=None,
                    help="report directory (default: "
                         "$MXNET_TPU_PROFILING_DIR or mxprof_reports)")
    rp.add_argument("--json", dest="as_json", action="store_true")
    dp = sub.add_parser("diff", help="compare two report artifacts; "
                                     "exit 1 naming drifted categories")
    dp.add_argument("old")
    dp.add_argument("new")
    dp.add_argument("--tol", type=float, default=_DIFF_TOL_DEFAULT,
                    help="relative drift tolerance (default %g)"
                         % _DIFF_TOL_DEFAULT)
    dp.add_argument("--json", dest="as_json", action="store_true")
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # downstream pager/head closed early: success, not a stack
        # trace (same contract as mxtelemetry); devnull-dup so the
        # interpreter's final stdout flush cannot re-raise
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


def _main(argv=None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "report":
        dirpath = args.dir
        if dirpath is None:
            from . import report_dir
            dirpath = report_dir() or "mxprof_reports"
        try:
            comb = _collect(args.paths, dirpath)
        except (OSError, ValueError, KeyError) as e:
            print("mxprof report: cannot load reports: %s" % e,
                  file=sys.stderr)
            return 2
        if comb is None or not comb["executables"]:
            print("mxprof report: no cost reports under %r (run with "
                  "MXNET_TPU_PROFILING=1 and save_reports())"
                  % dirpath, file=sys.stderr)
            return 1
        print(json.dumps(comb, indent=1, sort_keys=True)
              if args.as_json else _render_report(comb))
        return 0
    if args.cmd == "diff":
        try:
            old = load_report(args.old)
            new = load_report(args.new)
        except (OSError, ValueError, KeyError) as e:
            print("mxprof diff: cannot load reports: %s" % e,
                  file=sys.stderr)
            return 2
        drifts = diff_reports(old, new, tol=args.tol)
        if args.as_json:
            print(json.dumps({"tol": args.tol, "drifts": drifts},
                             indent=1, sort_keys=True))
        else:
            print(_render_diff(drifts, args.old, args.new, args.tol))
        return 1 if drifts else 0
    ap.print_usage()
    return 2


if __name__ == "__main__":
    sys.exit(main())
