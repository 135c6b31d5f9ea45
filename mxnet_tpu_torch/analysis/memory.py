"""The live-memory leak sentinel: the runtime half of
``mxnet_tpu/analysis/memory.py``.

Behind ``MXNET_TPU_MEMORY_WATCH=1`` (one module-flag check when off),
``ContinuousTrainer`` ticks a :class:`LeakSentinel` per step, which
takes a census (:func:`live_census`) at every goodput-window boundary
and flags monotonic live-bytes growth (EWMA+MAD, the goodput ledger's
machinery) naming the top-growing shape/dtype bucket -- publish-guard
aware, so a checkpoint snapshot spike never flags.

Torch has no ``live_arrays()``.  The census total on the card is the
caching allocator's (``torch.cuda.memory_stats``: allocated bytes and
active blocks, CUDA-graph pools included), one call and no walk; the
live tensors are walked for the shape/dtype buckets only when a window
flags, never every window (a heap-wide walk stalls every other thread
of a serving process).  On the CPU the census walks the live tensors.

The ``memory.leak`` chaos fail point (action :func:`pin_action`) pins
tensors in a hidden list so the sentinel, not the injector, must catch
the growth.  The static lints and the compiled audits of the JAX
module wait for the analysis slice.
"""
from __future__ import annotations

import gc
import os
import warnings
from typing import Dict, List, Optional

import torch

__all__ = ["watch_enabled", "live_census", "walk_buckets", "LeakSentinel",
           "sentinel", "reset_watch", "pin_action", "pinned_count",
           "unpin_all", "status_row"]

# THE flag the hot paths check: one module-attribute read when off.
_WATCH = os.environ.get("MXNET_TPU_MEMORY_WATCH", "0") != "0"

# sentinel state the /statusz row reads
_STATE = {"censuses": 0, "live_bytes": None, "live_arrays": None,
          "leaks": 0, "last_leak": None}

# the memory.leak chaos action pins tensors here: hidden from the code
# under test, visible to the census -- the sentinel, not the injector,
# must catch the growth
_PINNED: List[object] = []


def watch_enabled() -> bool:
    """Is the live-memory watch armed (``MXNET_TPU_MEMORY_WATCH``)?"""
    return _WATCH


def _set_watch(flag):
    """Test/scenario hook: flip the watch without re-importing."""
    global _WATCH
    prev = _WATCH
    _WATCH = bool(flag)
    return prev


def _census_device():
    """The card the census reads, or None on a host without one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def walk_buckets(device_type=None) -> Dict:
    """The live tensors (on ``device_type``, default every device),
    bucketed by shape/dtype: ``{"bytes_total", "arrays", "buckets":
    {key: {"count", "bytes"}}}``.  Each live tensor object counts its
    own elements (a view as well as its base)."""
    buckets: Dict[str, Dict] = {}
    total = count = 0
    seen = set()
    with warnings.catch_warnings():
        # isinstance() on every heap object touches deprecated module
        # attributes, whose access warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        if obj.is_meta:
            continue
        if device_type is not None and obj.device.type != device_type:
            continue
        ident = id(obj)
        if ident in seen:
            continue
        seen.add(ident)
        nbytes = obj.numel() * obj.element_size()
        key = "%s/%s" % (tuple(obj.shape), str(obj.dtype).replace(
            "torch.", ""))
        b = buckets.setdefault(key, {"count": 0, "bytes": 0})
        b["count"] += 1
        b["bytes"] += nbytes
        total += nbytes
        count += 1
    return {"bytes_total": total, "arrays": count, "buckets": buckets}


def live_census() -> Dict:
    """One census: ``{"bytes_total", "arrays", "buckets"}``.  On the
    card the allocator's allocated bytes and active blocks, with
    ``buckets`` None (walked only when a window flags); on the CPU the
    live tensors, bucketed.  Publishes the ``memory.live_bytes`` /
    ``memory.live_arrays`` gauges and the /statusz counters."""
    dev = _census_device()
    if dev is not None:
        stats = torch.cuda.memory_stats(dev)
        census = {"bytes_total": int(stats.get(
                      "allocated_bytes.all.current", 0)),
                  "arrays": int(stats.get("active.all.current", 0)),
                  "buckets": None}
    else:
        census = walk_buckets("cpu")
    total, count = census["bytes_total"], census["arrays"]
    _STATE["censuses"] += 1
    _STATE["live_bytes"] = total
    _STATE["live_arrays"] = count
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.memory_census(total, count)
    return census


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class LeakSentinel:
    """Live-bytes leak detection across goodput windows.

    ``step()`` once per training step; every ``window_steps`` the
    sentinel takes a census and judges the total against its EWMA
    baseline: a flag needs (a) a warm baseline (``min_baseline``
    windows), (b) live bytes beyond mean + ``mad_k`` deviations, AND
    (c) a monotonic growth streak of at least ``growth_windows``
    censuses -- a one-window allocation burst never flags, a steady
    leak always does.  ``note_publish()`` marks the window
    publish-guarded: a checkpoint snapshot legitimately spikes live
    bytes, so guarded windows neither judge nor teach the baseline.
    The rules and state are the JAX package's, window for window."""

    def __init__(self, window_steps=None, mad_k=None, ewma_alpha=0.3,
                 min_baseline=3, growth_windows=2,
                 min_growth_frac=0.02):
        self.window_steps = window_steps if window_steps is not None \
            else _env_int("MXNET_TPU_OBS_GOODPUT_WINDOW", 20)
        self.mad_k = mad_k if mad_k is not None \
            else _env_float("MXNET_TPU_OBS_GOODPUT_MAD_K", 4.0)
        self.ewma_alpha = ewma_alpha
        self.min_baseline = min_baseline
        self.growth_windows = growth_windows
        self.min_growth_frac = min_growth_frac
        self._steps = 0
        self._publishes = 0
        self._index = 0
        self._mean = 0.0
        self._dev = 0.0
        self._n = 0
        self._streak = 0
        self._prev = None          # previous census (bucket growth)
        self._walked = None        # buckets of the previous flag's walk
        self._last = None          # last window report (statusz/tests)

    def step(self):
        """One training-step tick; closes a window at the boundary."""
        self._steps += 1
        if self._steps >= self.window_steps:
            self.flush()

    def note_publish(self):
        """Mark this window publish-guarded (a checkpoint snapshot's
        live-bytes spike is expected work, not a leak)."""
        self._publishes += 1

    def flush(self) -> Optional[Dict]:
        """Close the current window now (the trainer's close() tail);
        returns the window report, or None on an empty window."""
        if not self._steps:
            return None
        steps, self._steps = self._steps, 0
        publishes, self._publishes = self._publishes, 0
        index = self._index
        self._index += 1
        census = live_census()
        x = float(census["bytes_total"])
        prev, self._prev = self._prev, census
        report = {"index": index, "steps": steps,
                  "publishes": publishes, "live_bytes": int(x),
                  "live_arrays": census["arrays"], "leak": None}
        if publishes:
            # publish guard: judge nothing, teach nothing
            self._last = report
            return report
        grew = prev is not None and x > prev["bytes_total"]
        self._streak = self._streak + 1 if grew else 0
        if self._n >= self.min_baseline:
            thresh = self._mean + self.mad_k * max(
                self._dev, 0.05 * self._mean, 1.0)
            moved = x - self._mean
            if x > thresh and self._streak >= self.growth_windows \
                    and moved >= self.min_growth_frac * max(
                        self._mean, 1.0):
                bucket, growth = self._top_growing(prev, census)
                report["leak"] = {
                    "live_bytes": int(x),
                    "baseline_bytes": int(self._mean),
                    "growth_bytes": int(growth),
                    "bucket": bucket,
                    "streak": self._streak,
                }
                _STATE["leaks"] += 1
                _STATE["last_leak"] = dict(report["leak"],
                                           window=index)
                from .. import telemetry as _telemetry
                if _telemetry._ENABLED:
                    _telemetry.hooks.memory_leak(
                        bucket, int(growth), int(x), index)
        # EWMA update (mean + absolute-deviation MAD analog); flagged
        # windows update too -- a sustained shift becomes the new
        # normal instead of alerting forever (the goodput contract)
        if self._n == 0:
            self._mean, self._dev, self._n = x, 0.0, 1
        else:
            a = self.ewma_alpha
            self._dev = (1 - a) * self._dev + a * abs(x - self._mean)
            self._mean = (1 - a) * self._mean + a * x
            self._n += 1
        self._last = report
        return report

    def _top_growing(self, prev, census):
        """The shape bucket that grew the most vs the previous census
        -- what the leak report NAMES.  A census without buckets (the
        card's) walks the live tensors now, and diffs against the
        previous flag's walk (none at the first flag: the largest
        bucket)."""
        if census["buckets"] is None:
            dev = _census_device()
            walked = walk_buckets(dev.type if dev is not None else None)
            buckets = walked["buckets"]
            prev_buckets, self._walked = self._walked or {}, buckets
        else:
            buckets = census["buckets"]
            prev_buckets = (prev or {}).get("buckets") or {}
        best, best_growth = None, 0
        for key, b in buckets.items():
            growth = b["bytes"] - prev_buckets.get(
                key, {"bytes": 0})["bytes"]
            if growth > best_growth:
                best, best_growth = key, growth
        return best or "<none>", best_growth

    def last(self) -> Optional[Dict]:
        return self._last

    def baseline(self) -> Dict:
        """EWMA state (tests)."""
        return {"mean": self._mean, "dev": self._dev, "n": self._n}


_SENTINEL: Optional[LeakSentinel] = None


def sentinel(**kwargs) -> LeakSentinel:
    """Get-or-create the process LeakSentinel (what ContinuousTrainer
    ticks when ``MXNET_TPU_MEMORY_WATCH=1``)."""
    global _SENTINEL
    if _SENTINEL is None:
        _SENTINEL = LeakSentinel(**kwargs)
    return _SENTINEL


def reset_watch():
    """Drop the sentinel, pins, and /statusz counters (tests)."""
    global _SENTINEL
    _SENTINEL = None
    _PINNED.clear()
    _STATE.update({"censuses": 0, "live_bytes": None,
                   "live_arrays": None, "leaks": 0, "last_leak": None})


# -- chaos integration -------------------------------------------------

def pin_action(ctx):
    """The ``memory.leak`` chaos action: allocate a tensor (on the card
    when there is one in use, else on the host) and pin it in a hidden
    module list, so live bytes grow monotonically and the SENTINEL (not
    the injector) must catch the leak.  Arm with::

        chaos.on("memory.leak", memory.pin_action)

    ``ctx`` may carry ``nbytes`` (default 1 MiB per fire)."""
    nbytes = int(ctx.get("nbytes", 1 << 20))
    dev = _census_device()
    _PINNED.append(torch.zeros((max(1, nbytes // 4),), dtype=torch.float32,
                               device=dev if dev is not None else "cpu"))


def pinned_count() -> int:
    return len(_PINNED)


def unpin_all() -> int:
    """Release every chaos-pinned tensor; returns how many."""
    n = len(_PINNED)
    _PINNED.clear()
    return n


def status_row() -> Dict:
    """The ``/statusz`` memory row: watch arm state, censuses run,
    latest live totals, leaks flagged, and the last leak's
    attribution."""
    return {"armed": _WATCH, "censuses": _STATE["censuses"],
            "live_bytes": _STATE["live_bytes"],
            "live_arrays": _STATE["live_arrays"],
            "leaks": _STATE["leaks"], "last_leak": _STATE["last_leak"],
            "pinned": len(_PINNED)}
