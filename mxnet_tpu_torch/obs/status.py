"""Process status board: what ``/healthz`` and ``/statusz`` read
(counterpart of ``mxnet_tpu/obs/status.py``).

Long-lived components register themselves (weakly -- the board never
extends a lifetime): serving registries, registry watchers, continuous
trainers.  The board derives **readiness** the way a load balancer or
pod manager needs it:

- a :class:`~mxnet_tpu_torch.serving.loop.RegistryWatcher` that
  exhausted its swap failure budget (suspended) means the process is
  serving a stale model and flapping stopped -- NOT_READY until an
  operator intervenes;
- a failed async checkpoint write (``checkpoint.write_failures``) means
  published state is behind training -- NOT_READY;
- a servable whose bounded queue sits at capacity is shedding load --
  NOT_READY (scale out / back off);
- a restart supervisor whose generation is down (a worker died and the
  relaunch has not landed) or whose restart budget is spent --
  NOT_READY until the workers are back or an operator intervenes.

:func:`statusz` adds the operator narrative: served vs published step,
recent swap history (the ``serving.swap`` event ring), bucket
occupancy, and per-rank last heartbeat (the ContinuousTrainer loop
beats once per step; a stale heartbeat is a wedged trainer even when
every thread is alive), the newest goodput window (:mod:`.goodput`),
the numerics and leak sentinels' rows, the supervisors, and -- when a
:class:`~mxnet_tpu_torch.obs.fleet.FleetMonitor` runs in the process
(:func:`register_fleet`) -- its replicas up/down and firing alerts.
The snapshot has the JAX package's schema.  :mod:`.server` serves it
over HTTP.
"""
from __future__ import annotations

import os
import time
import weakref

__all__ = ["register_watcher", "register_registry", "register_trainer",
           "register_ledger", "register_supervisor", "register_fleet",
           "fleet_monitor", "heartbeat", "health", "statusz", "reset",
           "STATUSZ_SCHEMA"]

# the /statusz contract version, the JAX package's
STATUSZ_SCHEMA = "mxstatusz.v1"

_watchers = weakref.WeakSet()
_registries = weakref.WeakSet()
_trainers = weakref.WeakSet()
_ledgers = weakref.WeakSet()    # goodput StepLedgers (obs.goodput)
_supervisors = weakref.WeakSet()   # restart supervisors
_fleet = weakref.WeakSet()      # FleetMonitors (obs.fleet)
_heartbeats = {}                # rank -> wall time of last beat


def _env_int(name):
    try:
        return int(os.environ.get(name, "0") or 0)
    except ValueError:
        return 0


def register_watcher(watcher):
    _watchers.add(watcher)


def register_registry(registry):
    _registries.add(registry)


def register_trainer(trainer):
    _trainers.add(trainer)


def register_ledger(ledger):
    _ledgers.add(ledger)


def register_supervisor(supervisor):
    _supervisors.add(supervisor)


def register_fleet(monitor):
    _fleet.add(monitor)


def fleet_monitor():
    """The newest registered FleetMonitor (``/alertz`` reads it), or
    None when this process runs no fleet plane."""
    best = None
    for m in list(_fleet):
        best = m
    return best


def heartbeat(rank=None):
    """One liveness beat (the trainer loop calls this every step)."""
    _heartbeats[_env_int("MXNET_TPU_PROC_ID") if rank is None
                else int(rank)] = time.time()


def reset():
    """Drop every registration (tests)."""
    _watchers.clear()
    _registries.clear()
    _trainers.clear()
    _ledgers.clear()
    _supervisors.clear()
    _fleet.clear()
    _heartbeats.clear()


def _counter_value(name):
    from .. import telemetry as _telemetry
    inst = _telemetry.registry().get(name)
    return inst.value if inst is not None else 0


def _servables():
    """``(name, servable)`` of every registered registry's servables;
    a registry or servable closing meanwhile is skipped."""
    out = []
    for reg in list(_registries):
        try:
            names = reg.names()
        except Exception:       # noqa: BLE001 -- a board never raises
            continue
        for name in names:
            try:
                out.append((name, reg.servable(name)))
            except Exception:   # noqa: BLE001 -- unregistered meanwhile
                continue
    return out


def health():
    """``(ready, reasons)``: ready is True iff reasons is empty."""
    reasons = []
    for w in list(_watchers):
        if w.suspended:
            reasons.append("watcher_suspended:%s" % w.name)
    failures = _counter_value("checkpoint.write_failures")
    if failures:
        reasons.append("checkpoint_write_failures:%d" % failures)
    for s in list(_supervisors):
        if s.exhausted:
            reasons.append("restart_budget_exhausted:%d" % s.generation)
        elif s.generation_down:
            reasons.append("generation_down:%d" % s.generation)
    for name, s in _servables():
        if s.queue_depth() >= s.queue_capacity:
            reasons.append("queue_saturated:%s" % name)
    return (not reasons), reasons


def statusz():
    """The full operator snapshot (JSON-ready)."""
    from .. import telemetry as _telemetry
    from ..analysis import memory as _memory
    from ..analysis import numerics as _numerics
    reg = _telemetry.registry()
    watchers = [{"name": w.name, "served_step": w.served_step,
                 "suspended": w.suspended, "bad_steps": w.bad_steps()}
                for w in list(_watchers)]
    trainers = [{"step": t.step, "published_step": t.published_step}
                for t in list(_trainers)]
    servables = [{"name": name, "queue_depth": s.queue_depth(),
                  "queue_capacity": s.queue_capacity,
                  "buckets": list(s.buckets)}
                 for name, s in _servables()]
    supervisors = [{"generation": s.generation, "restarts": s.restarts,
                    "down": s.generation_down, "exhausted": s.exhausted}
                   for s in list(_supervisors)]
    goodput = None
    for led in list(_ledgers):
        win = led.last()
        if win is not None:
            goodput = win       # the newest registered ledger wins
    swap_ev = reg.get("serving.swap")
    occupancy = reg.get("serving.batch_occupancy")
    fleet_row = None
    mon = fleet_monitor()
    if mon is not None:
        try:
            fleet_row = mon.fleet_row()
        except Exception:       # noqa: BLE001 -- a board never raises
            fleet_row = None
    served = reg.get("serving.served_step")
    published = reg.get("train_loop.published_step")
    ready, reasons = health()
    return {
        "schema": STATUSZ_SCHEMA,
        "pid": os.getpid(),
        "rank": _env_int("MXNET_TPU_PROC_ID"),
        "generation": _env_int("MXNET_TPU_GENERATION"),
        "time": time.time(),
        "ready": ready,
        "not_ready_reasons": reasons,
        "served_step": served.value if served is not None else None,
        "published_step": (published.value if published is not None
                           else None),
        "watchers": watchers,
        "trainers": trainers,
        "servables": servables,
        "supervisors": supervisors,
        "swap_history": swap_ev.recent if swap_ev is not None else [],
        "bucket_occupancy": (occupancy.snapshot()
                             if occupancy is not None else None),
        "goodput": goodput,
        "numerics": _numerics.status_row(),
        "memory": _memory.status_row(),
        "heartbeats": dict(_heartbeats),
        "fleet": fleet_row,
    }
