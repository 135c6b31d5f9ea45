"""In-process CostReport store: reports, step times, persistence
(counterpart of ``mxnet_tpu/profiling/store.py``).

The JAX package registers a compiled callable and analyzes it lazily;
the port's report is the walk of a key's warm-up run, which happens
once, on the path (:func:`~mxnet_tpu_torch.profiling.capture_jit`), so
:func:`register` stores a finished report.  A report of a captured key
refers to its graph owner weakly: the owner's pool bytes enter the
report's peak when the report is read.

Step wall times recorded via :func:`record_step` attach per-label step
stats and a roofline section to the matching reports.
"""
from __future__ import annotations

import json
import os
import weakref

from .. import sync as _sync
from . import roofline

COMBINED_SCHEMA = "mxprof.report.v1"
COMBINED_NAME = "report.json"

_lock = _sync.Lock(name="profiling.store")
_reports = {}      # key -> CostReport dict
_owners = {}       # key -> weakref of the report's GraphOwner
_audits = {}       # key -> the walk's audit counters (profiling.aten)
_steps = {}        # label -> {"count","total_s","min_s","max_s","items"}


def register(key, report, owner=None, audit=None):
    """Store ``report`` under ``key`` (the first report of a key wins),
    with the walk's ``audit`` counters beside it."""
    with _lock:
        if key in _reports:
            return False
        _reports[key] = report
        if owner is not None:
            _owners[key] = weakref.ref(owner)
        if audit is not None:
            _audits[key] = audit
    return True


def has(key):
    with _lock:
        return key in _reports


def record_step(label, seconds, items=None):
    seconds = float(seconds)
    with _lock:
        st = _steps.setdefault(label, {"count": 0, "total_s": 0.0,
                                       "min_s": None, "max_s": None,
                                       "items": 0})
        st["count"] += 1
        st["total_s"] += seconds
        st["min_s"] = seconds if st["min_s"] is None \
            else min(st["min_s"], seconds)
        st["max_s"] = seconds if st["max_s"] is None \
            else max(st["max_s"], seconds)
        if items:
            st["items"] += int(items)
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.profiling_step(label, seconds)


def step_stats(label=None):
    with _lock:
        if label is not None:
            return dict(_steps.get(label, {}))
        return {k: dict(v) for k, v in _steps.items()}


def _with_pool(rep, owner_ref):
    """The report with its owner's graph pool bytes in its memory
    section: the peak is at least the arguments plus the pool."""
    owner = owner_ref() if owner_ref is not None else None
    if owner is None or not owner.pool_bytes:
        return rep
    rep = dict(rep)
    mem = dict(rep["memory"])
    mem["graph_pool_bytes"] = int(owner.pool_bytes)
    mem["peak_hbm_bytes"] = max(mem["peak_hbm_bytes"],
                                mem["argument_bytes"] + owner.pool_bytes)
    rep["memory"] = mem
    return rep


def _annotate(rep):
    """Attach step stats + roofline when step times exist for the
    report's label."""
    st = _steps.get(rep["label"])
    if not st or not st["count"]:
        return rep
    mean = st["total_s"] / st["count"]
    rep = dict(rep)
    rep["step"] = {"count": st["count"], "mean_s": mean,
                   "min_s": st["min_s"], "max_s": st["max_s"],
                   "total_s": st["total_s"]}
    items = (st["items"] / st["count"]) if st.get("items") else None
    rep["roofline"] = roofline.build(rep, mean, items_per_step=items)
    return rep


def reports():
    """All CostReports, annotated, insertion-ordered."""
    with _lock:
        reps = [_with_pool(r, _owners.get(k)) for k, r in _reports.items()]
        steps_snapshot = bool(_steps)
    return [(_annotate(r) if steps_snapshot else r) for r in reps]


def audited():
    """``(key, report, audit counters or None)`` of every stored report,
    annotated and insertion-ordered: what the analysis audits read."""
    with _lock:
        items = [(k, _with_pool(r, _owners.get(k)), _audits.get(k))
                 for k, r in _reports.items()]
        steps_snapshot = bool(_steps)
    return [(k, _annotate(r) if steps_snapshot else r, a)
            for k, r, a in items]


def report(key):
    """The annotated report stored under ``key``, or None."""
    with _lock:
        rep = _reports.get(key)
        if rep is None:
            return None
        rep = _with_pool(rep, _owners.get(key))
        steps_snapshot = bool(_steps)
    return _annotate(rep) if steps_snapshot else rep


def flops_per_step(label=None):
    """FLOPs of ONE dispatch of the labeled report (``label=None``
    picks the first ``train_step``-kind report) -- the goodput ledger's
    window-flops source; None when nothing matches."""
    for rep in reports():
        if (rep["label"] == label
                or (label is None and rep.get("kind") == "train_step")):
            return rep["totals"]["flops"]
    return None


def combined():
    """The combined artifact ``mxprof report`` / ``diff`` consume."""
    reps = reports()
    rollup = {}
    tot_f = tot_b = 0.0
    peak_hbm = 0
    for r in reps:
        tot_f += r["totals"]["flops"]
        tot_b += r["totals"]["bytes_accessed"]
        peak_hbm = max(peak_hbm, r["memory"]["peak_hbm_bytes"])
        for c, v in r["categories"].items():
            agg = rollup.setdefault(c, {"flops": 0, "bytes": 0,
                                        "instructions": 0})
            agg["flops"] += v["flops"]
            agg["bytes"] += v["bytes"]
            agg["instructions"] += v["instructions"]
    return {
        "schema": COMBINED_SCHEMA,
        "steps": step_stats(),
        "executables": reps,
        "totals": {"flops": tot_f, "bytes_accessed": tot_b,
                   "peak_hbm_bytes": peak_hbm},
        "categories": rollup,
    }


def _safe_name(label):
    return "".join(ch if ch.isalnum() or ch in "._-" else "_"
                   for ch in label) or "report"


def save(dirpath=None):
    """Write per-report ``<label>.cost.json`` files and the combined
    ``report.json``; returns the combined path."""
    from . import report_dir
    dirpath = dirpath or report_dir() or "mxprof_reports"
    os.makedirs(dirpath, exist_ok=True)
    comb = combined()
    for rep in comb["executables"]:
        path = os.path.join(dirpath,
                            _safe_name(rep["label"]) + ".cost.json")
        with open(path, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
    out = os.path.join(dirpath, COMBINED_NAME)
    with open(out, "w") as f:
        json.dump(comb, f, indent=1, sort_keys=True)
    return out


def clear():
    with _lock:
        _reports.clear()
        _owners.clear()
        _audits.clear()
        _steps.clear()
