"""Goodput ledger: online step-time attribution, a rolling MFU gauge
and a regression sentinel (counterpart of ``mxnet_tpu/obs/goodput.py``).

Per rolling window of training steps, :class:`StepLedger` splits the
window's wall clock into named categories from telemetry instrument
deltas:

============================  =======================================
category                      source (telemetry instrument deltas)
============================  =======================================
``device_compute``            ``profiling.step_time`` (TrainStep
                              dispatch walls) + ``trainer.step_time``
                              (eager Trainer.step; the two never cover
                              the same step -- a TrainStep folds the
                              update into its graph)
``input_wait``                ``feed.consumer_wait`` +
                              ``data.wait_time``
``host_sync``                 ``dispatch.host_sync_time`` (asnumpy /
                              wait_to_read / waitall walls)
``checkpoint_stall``          ``checkpoint.save_time`` +
                              ``checkpoint.async_wait``
``recompile``                 ``compile.build_time`` (a key's eager
                              warm-up and CUDA-graph capture)
``other``                     the un-attributed remainder
============================  =======================================

A graph replay returns before the card finishes: ``device_compute`` is
the dispatch wall, and the wait for the card lands where the host reads
a result (``host_sync``), so a window never counts one second twice.

**Reconciliation contract**: every window's categories sum to the
window wall within ``tol`` -- ``other`` absorbs un-instrumented time,
so the only way the contract can fail is *overshoot* (attributed time
exceeding wall: double counting or a cross-thread overlap).

**MFU gauge**: given flops-per-step (``TrainStep.cost_analysis()
["flops"]`` or ``profiling.flops_per_step()``), each window publishes
``window_flops / wall / device_peak`` as the ``goodput.mfu`` gauge
(the card's peak from ``profiling.roofline.device_peaks``).

**Regression sentinel**: per category, an EWMA baseline of per-step
seconds plus an EWMA of absolute deviation (a MAD analog).  A window
whose per-step category time exceeds ``mean + mad_k * dev`` (and moves
at least 5% of the window wall) emits a ``goodput.regression`` event
naming the category.  Two guards:

- the **env guard**: when ``env.dispatch_roundtrip_us`` says the
  environment is degraded (past :data:`DEGRADED_RTT_US`), the window is
  reported as ``goodput.env_degraded`` and not as a regression, and
  the baseline is not updated;
- the **publish guard**: a window spanning a checkpoint publish
  (``note_publish``) expects a ``checkpoint_stall`` spike -- expected
  work, not a regression.

Gate: ``MXNET_TPU_OBS_GOODPUT=1`` / ``obs.enable_goodput()`` arms the
loop hooks (ContinuousTrainer steps the process ledger); disabled, the
instrumented sites pay one module-flag check.  The ledger reads
telemetry instruments, so ``MXNET_TPU_TELEMETRY=1`` must also be on for
non-empty categories.
"""
from __future__ import annotations

import os
import time

__all__ = ["CATEGORIES", "DEGRADED_RTT_US", "StepLedger", "ledger",
           "reset", "env_degraded", "line_summary"]

# attribution categories, in report order ("other" is the remainder)
CATEGORIES = ("device_compute", "input_wait", "host_sync",
              "checkpoint_stall", "recompile", "other")

# timer instruments whose .sum deltas feed each named category
_CATEGORY_TIMERS = {
    "device_compute": ("profiling.step_time", "trainer.step_time"),
    "input_wait": ("feed.consumer_wait", "data.wait_time"),
    "host_sync": ("dispatch.host_sync_time",),
    "checkpoint_stall": ("checkpoint.save_time", "checkpoint.async_wait"),
    "recompile": ("compile.build_time",),
}

# the degraded-environment threshold (the JAX package's): dispatch round
# trips slower than this mean the environment, not the model
DEGRADED_RTT_US = 10000.0

# a category must move at least this share of the window wall before
# the sentinel may call it a regression (absolute significance floor)
_MIN_MOVE_FRAC = 0.05


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_degraded(rtt_us=None):
    """The sentinel's env guard: True when the dispatch round trip says
    the environment, not the workload, is slow.  With no argument,
    reads the live ``env.dispatch_roundtrip_us`` gauge (set through
    ``hooks.env_health``); unknown (gauge never set) reads healthy."""
    if rtt_us is None:
        from .. import telemetry as _telemetry
        g = _telemetry.registry().get("env.dispatch_roundtrip_us")
        rtt_us = g.value if g is not None else None
    return bool(rtt_us is not None and rtt_us > DEGRADED_RTT_US)


def line_summary(window):
    """The compact breakdown of one window: shares + verdict + MFU, no
    baselines or raw deltas."""
    if window is None:
        return None
    return {
        "steps": window["steps"],
        "wall_s": round(window["wall_s"], 4),
        "mfu": window["mfu"],
        "shares": {cat: round(c["share"], 4)
                   for cat, c in window["categories"].items()},
        "verdict": window["verdict"]["detail"],
        "bound": window["verdict"]["bound"],
        "reconciled": window["reconciliation"]["ok"],
        "env_degraded": window["env_degraded"],
    }


class StepLedger:
    """Online per-window wall-time attribution over the telemetry
    instruments.

    ::

        ledger = StepLedger(window_steps=20)
        for batch in feed:
            train(batch)
            ledger.step()          # closes a window every 20 steps
        last = ledger.flush()      # close the partial tail window

    The ledger never touches a device and never blocks: ``step()`` is
    a counter bump until a window boundary, where closing a window is
    a handful of instrument reads.  Windows land in a bounded local
    ring (:meth:`windows`) and -- when telemetry is enabled -- publish
    as ``goodput.*`` gauges/timers/events so Prometheus, /statusz, and
    the summarize CLI all see them.
    """

    def __init__(self, window_steps=None, tol=None, mad_k=None,
                 ewma_alpha=0.3, min_baseline=3, history=64,
                 flops_per_step=None, registry=None):
        from .. import sync as _sync
        self.window_steps = int(window_steps if window_steps is not None
                                else _env_float(
                                    "MXNET_TPU_OBS_GOODPUT_WINDOW", 20))
        if self.window_steps < 1:
            self.window_steps = 1
        self.tol = float(tol if tol is not None else _env_float(
            "MXNET_TPU_OBS_GOODPUT_TOL", 0.25))
        self.mad_k = float(mad_k if mad_k is not None else _env_float(
            "MXNET_TPU_OBS_GOODPUT_MAD_K", 4.0))
        self.ewma_alpha = float(ewma_alpha)
        self.min_baseline = int(min_baseline)
        self.flops_per_step = flops_per_step
        self._registry = registry
        self._history = int(history)
        self._windows = []
        self._index = 0
        self._baseline = {}     # category -> {"mean", "dev", "n"}
        self._lock = _sync.Lock(name="obs.goodput")
        with self._lock:
            self._open_window()

    # -- instrument reads ----------------------------------------------
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from .. import telemetry as _telemetry
        return _telemetry.registry()

    def _timer_sums(self):
        reg = self._reg()
        sums = {}
        for names in _CATEGORY_TIMERS.values():
            for name in names:
                t = reg.get(name)
                sums[name] = float(t.sum) if t is not None else 0.0
        return sums

    # -- window lifecycle ----------------------------------------------
    def _open_window(self):
        # under self._lock
        self._t0 = time.perf_counter()
        self._sums0 = self._timer_sums()
        self._steps = 0
        self._publishes = 0

    def step(self, n=1):
        """Record ``n`` completed training steps; closes (and returns)
        a window at every ``window_steps`` boundary, else None."""
        with self._lock:
            self._steps += int(n)
            if self._steps < self.window_steps:
                return None
            return self._close("steps")

    def note_publish(self):
        """Mark that the current window spans a checkpoint publish --
        its ``checkpoint_stall`` spike is expected work, and the
        sentinel must not read it as a regression."""
        with self._lock:
            self._publishes += 1

    def flush(self, reason="flush"):
        """Close the current window regardless of step count (the
        serving-only / end-of-run surface; a zero-step window
        reports ``idle`` and runs no sentinel)."""
        with self._lock:
            return self._close(reason)

    def windows(self):
        """Recent window reports, oldest first (bounded ring)."""
        with self._lock:
            return list(self._windows)

    def last(self):
        with self._lock:
            return self._windows[-1] if self._windows else None

    # -- the close: attribution, reconciliation, MFU, sentinel ---------
    def _close(self, reason):
        # under self._lock
        wall = max(time.perf_counter() - self._t0, 0.0)
        sums1 = self._timer_sums()
        steps, publishes = self._steps, self._publishes
        seconds = {}
        for cat, names in _CATEGORY_TIMERS.items():
            seconds[cat] = sum(
                max(sums1[n] - self._sums0.get(n, 0.0), 0.0)
                for n in names)
        known = sum(seconds.values())
        seconds["other"] = max(wall - known, 0.0)
        total = known + seconds["other"]
        err = ((total - wall) / wall) if wall > 0 else 0.0
        categories = {}
        for cat in CATEGORIES:
            s = seconds[cat]
            categories[cat] = {
                "seconds": round(s, 6),
                "share": (s / wall) if wall > 0 else 0.0,
                "per_step_s": (s / steps) if steps else None,
            }
        g = self._reg().get("env.dispatch_roundtrip_us")
        rtt_us = g.value if g is not None else None
        report = {
            "index": self._index,
            "reason": reason,
            "steps": steps,
            "publishes": publishes,
            "wall_s": wall,
            "categories": categories,
            "reconciliation": {"sum_s": round(total, 6),
                               "wall_s": round(wall, 6),
                               "error": round(err, 6), "tol": self.tol,
                               "ok": err <= self.tol},
            "mfu": None,
            "flops": None,
            "verdict": _verdict(categories, steps, wall),
            "regressions": [],
            "env_degraded": bool(rtt_us is not None
                                 and rtt_us > DEGRADED_RTT_US),
            "dispatch_roundtrip_us": rtt_us,
        }
        self._attach_mfu(report)
        self._sentinel(report)
        self._index += 1
        self._windows.append(report)
        if len(self._windows) > self._history:
            del self._windows[0]
        self._publish(report)
        self._open_window()
        return report

    def _attach_mfu(self, report):
        fps = self.flops_per_step
        if callable(fps):
            fps = fps()
        steps, wall = report["steps"], report["wall_s"]
        if not fps or not steps or wall <= 0:
            return
        from ..profiling import roofline
        peak, _bw, assumed = roofline.device_peaks()
        flops = float(fps) * steps
        report["flops"] = flops
        report["mfu"] = round(flops / wall / peak, 4)
        report["peaks_assumed"] = assumed

    def _sentinel(self, report):
        steps, wall = report["steps"], report["wall_s"]
        if not steps or wall <= 0:
            return                    # idle window: nothing to judge
        if report["env_degraded"]:
            # a degraded environment is not a model regression --
            # report it as such and keep the baseline clean of degraded
            # samples
            return
        floor = _MIN_MOVE_FRAC * wall / steps
        for cat in CATEGORIES:
            if cat == "other":
                continue
            x = report["categories"][cat]["per_step_s"]
            base = self._baseline.get(cat)
            if base is not None and base["n"] >= self.min_baseline:
                thresh = base["mean"] + self.mad_k * max(
                    base["dev"], 0.1 * base["mean"], 1e-6)
                moved = x - base["mean"]
                if x > thresh and moved >= floor and not (
                        cat == "checkpoint_stall"
                        and report["publishes"]):
                    report["regressions"].append({
                        "category": cat,
                        "per_step_s": round(x, 6),
                        "baseline_per_step_s": round(base["mean"], 6),
                        "ratio": round(x / base["mean"], 2)
                        if base["mean"] > 0 else None,
                    })
            # EWMA baseline update (mean + absolute-deviation MAD
            # analog); regressed windows update too -- a sustained
            # shift becomes the new normal instead of alerting forever.
            # Publish windows keep their EXPECTED checkpoint_stall
            # spike out of the baseline (it would mask a real stall).
            if cat == "checkpoint_stall" and report["publishes"]:
                continue
            if base is None:
                self._baseline[cat] = {"mean": x, "dev": 0.0, "n": 1}
            else:
                a = self.ewma_alpha
                base["dev"] = (1 - a) * base["dev"] \
                    + a * abs(x - base["mean"])
                base["mean"] = (1 - a) * base["mean"] + a * x
                base["n"] += 1

    def _publish(self, report):
        from .. import telemetry as _telemetry
        if not _telemetry._ENABLED:
            return
        _telemetry.hooks.goodput_window(report)
        if report["env_degraded"] and report["steps"]:
            _telemetry.hooks.goodput_env_degraded(
                report["index"], report["dispatch_roundtrip_us"])
        for r in report["regressions"]:
            _telemetry.hooks.goodput_regression(
                r["category"], r["per_step_s"],
                r["baseline_per_step_s"], r["ratio"], report["index"])

    def baseline(self):
        """Copy of the sentinel's per-category EWMA state (tests)."""
        with self._lock:
            return {k: dict(v) for k, v in self._baseline.items()}


def _verdict(categories, steps, wall):
    """The bottleneck verdict: one operator-readable sentence per
    window (the summarize CLI's headline line)."""
    if not steps or wall <= 0:
        return {"bound": "idle",
                "detail": "idle: no training steps in window"}
    sec = {c: categories[c]["seconds"] for c in CATEGORIES}
    share = {c: categories[c]["share"] for c in CATEGORIES}
    dc, iw = sec["device_compute"], sec["input_wait"]
    if iw > 0 and iw >= 0.5 * dc and share["input_wait"] >= 0.15:
        # "the feed supplies N% of device demand": of the time the
        # device could have been computing, how much it actually was
        supply = dc / (dc + iw) if (dc + iw) > 0 else 0.0
        return {"bound": "input",
                "detail": "input-bound: feed supplies %d%% of device "
                          "demand" % int(round(100 * supply))}
    for cat, bound in (("recompile", "recompile"),
                       ("checkpoint_stall", "checkpoint"),
                       ("host_sync", "host-sync")):
        if share[cat] >= 0.2:
            return {"bound": bound,
                    "detail": "%s-bound: %s takes %d%% of window wall"
                              % (bound, cat,
                                 int(round(100 * share[cat])))}
    if share["device_compute"] >= 0.5:
        return {"bound": "compute",
                "detail": "compute-bound: device busy %d%% of wall"
                          % int(round(100 * share["device_compute"]))}
    top = max((c for c in CATEGORIES if c != "other"),
              key=lambda c: sec[c])
    return {"bound": "mixed",
            "detail": "mixed: top category %s at %d%% of wall "
                      "(other %d%%)"
                      % (top, int(round(100 * share[top])),
                         int(round(100 * share["other"])))}


# -- the process ledger (what the ContinuousTrainer hooks drive) -------
_LEDGER = None


def ledger(**kwargs):
    """Get-or-create the process StepLedger (registered on the status
    board so /statusz carries the latest window)."""
    global _LEDGER
    if _LEDGER is None:
        _LEDGER = StepLedger(**kwargs)
        from . import status
        status.register_ledger(_LEDGER)
    return _LEDGER


def reset():
    """Drop the process ledger (tests)."""
    global _LEDGER
    _LEDGER = None
