"""Deterministic fault injection: fail points, rules, actions
(counterpart of ``mxnet_tpu/chaos/core.py``).

A **fail point** is a named hook compiled into a subsystem's dangerous
spot -- checkpoint commit, the serving dispatch path, the hot-swap
install, the preemption signal handler::

    from .. import chaos as _chaos
    ...
    _chaos.fail_point("checkpoint.commit.pre_manifest", step=step)

Disarmed (the default and the production state), every fail point is a
single module-flag check -- the same zero-overhead contract as
``telemetry._ENABLED``.  Armed (``chaos.arm(seed)`` or a
``chaos.scenario(seed=...)`` block), each hit consults the injection
**rules** registered with :func:`on` and fires the rule's **action**:

- ``chaos.RAISE`` -- raise :class:`ChaosInjected` at the fail point
  (a crashing writer, a failing compiled call);
- ``chaos.KILL`` -- ``os._exit(137)``, the SIGKILL-shaped death that
  leaves whatever bytes happen to be on disk (no atexit, no flush);
- ``chaos.sleep(s)`` -- stall the hitting thread (a slow device, a
  wedged dispatch -- how the flood scenario holds the batcher worker);
- ``chaos.truncate(fname, keep=n)`` -- tear a file named in the fail
  point's context directory (the on-disk state a non-atomic writer or
  bit-rot leaves);
- any callable ``action(ctx)`` -- ``ctx`` carries the fail point's
  keyword context plus ``point``.

Determinism: rules fire on exact hit counts (``nth=3``, ``nth=(1, 2)``)
or on a per-rule ``random.Random`` seeded from ``(seed, point, index)``
(``prob=0.3``) -- a scenario replays identically for a fixed seed, so a
chaos failure in CI is reproducible at the shell.

Every fire is counted (``chaos.injected`` / ``chaos.injected.<point>``
plus a ``chaos.inject`` event) and every *tolerated* fault -- injected
or real weather -- is recorded by the recovery paths themselves via
:func:`survived` (``chaos.survived.<point>``): the quarantine of a torn
checkpoint, a retried async write, a hot-swap rollback, a suppressed
re-entrant SIGTERM.  ``chaos.stats()`` mirrors both locally so tests
can assert without telemetry armed.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import time

from .. import sync as _sync
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = [
    "ChaosInjected", "arm", "disarm", "armed", "reset", "on",
    "fail_point", "survived", "stats", "scenario",
    "arm_from_spec", "make_spec",
    "RAISE", "KILL", "sleep", "truncate",
]

# THE flag every fail point checks (one module-attribute read).  Armed
# only by arm()/scenario() -- never by env var alone, so production
# processes cannot be chaos'd by a stray environment.
_ARMED = False

RAISE = "raise"
KILL = "kill"


class ChaosInjected(MXNetError):
    """The fault a ``chaos.RAISE`` rule injects at a fail point
    (``point`` names it, so recovery paths can pair their survival
    count with the exact site that made the weather)."""

    def __init__(self, msg, point=None):
        super().__init__(msg)
        self.point = point


def sleep(seconds):
    """Action: stall the thread hitting the fail point."""
    def _sleep(ctx):
        time.sleep(seconds)
    _sleep.chaos_label = "sleep(%gs)" % seconds
    return _sleep


def truncate(fname, keep=8):
    """Action: tear ``fname`` inside the fail point's context ``path``
    (a directory) down to ``keep`` bytes -- the torn-write state the
    manifest verification exists to catch."""
    def _truncate(ctx):
        path = ctx.get("path")
        if path is None:
            raise MXNetError("chaos.truncate needs a fail point that "
                             "passes path= context (got %r)" % (ctx,))
        target = os.path.join(path, fname) if os.path.isdir(path) else path
        with open(target, "r+b") as f:
            f.truncate(keep)
    _truncate.chaos_label = "truncate(%s)" % fname
    return _truncate


class _Rule:
    __slots__ = ("point", "action", "nth", "prob", "times",
                 "hits", "fired", "rng")

    def __init__(self, point, action, nth, prob, times, seed, index):
        self.point = point
        self.action = action
        self.nth = (frozenset((nth,)) if isinstance(nth, int)
                    else frozenset(nth) if nth is not None else None)
        self.prob = prob
        self.times = times
        self.hits = 0
        self.fired = 0
        # per-rule independent stream: deterministic for a fixed seed
        # regardless of what other rules (or the global RNG) consume
        self.rng = random.Random("%s:%s:%d" % (seed, point, index))

    def should_fire(self):
        """Called under the registry lock with ``hits`` already
        incremented for this visit."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None:
            return self.hits in self.nth
        if self.prob is not None:
            return self.rng.random() < self.prob
        return True

    def label(self):
        a = self.action
        if isinstance(a, str):
            return a
        return getattr(a, "chaos_label", getattr(a, "__name__", "call"))


_lock = _sync.Lock(name="chaos.rules")
_rules = {}        # point -> [_Rule]
_hits = {}         # point -> hit count (armed only)
_injected = {}     # point -> fire count
_survived = {}     # point -> survive count
_seed = None


def arm(seed=None):
    """Arm the fail points.  ``seed`` defaults to
    ``MXNET_TPU_CHAOS_SEED``; rules registered after ``arm`` draw their
    probability streams from it."""
    global _ARMED, _seed
    if seed is None:
        from .. import env as _env
        seed = _env.get("MXNET_TPU_CHAOS_SEED")
    with _lock:
        _seed = seed
    _ARMED = True


def disarm():
    """Disarm every fail point (rules and stats are kept for
    post-mortem assertions until :func:`reset`)."""
    global _ARMED
    _ARMED = False


def armed():
    return _ARMED


def reset():
    """Drop all rules and stats (does not change the armed flag)."""
    with _lock:
        _rules.clear()
        _hits.clear()
        _injected.clear()
        _survived.clear()


def on(point, action=RAISE, nth=None, prob=None, times=None):
    """Register an injection rule for ``point``.

    - ``nth``: fire on exactly these 1-based hit counts (int or
      iterable of ints);
    - ``prob``: fire on each hit with this probability (seeded,
      deterministic per rule);
    - ``times``: cap the number of fires (None = bounded only by
      ``nth``/``prob``);
    - neither ``nth`` nor ``prob``: fire on every hit (up to
      ``times``).
    """
    if nth is not None and prob is not None:
        raise MXNetError("chaos.on: nth= and prob= are exclusive")
    with _lock:
        seed = _seed if _seed is not None else 0
        rule = _Rule(point, action, nth, prob, times, seed,
                     len(_rules.get(point, ())))
        _rules.setdefault(point, []).append(rule)
    return rule


def fail_point(name, **ctx):
    """The hook a subsystem compiles into its dangerous spot.  Disarmed
    (default): one flag check, nothing else.  Armed: consult the rules
    for ``name`` and perform the matched action."""
    if not _ARMED:
        return
    _visit(name, ctx)


def _visit(name, ctx):
    fire = None
    with _lock:
        _hits[name] = _hits.get(name, 0) + 1
        for rule in _rules.get(name, ()):
            rule.hits += 1
            if fire is None and rule.should_fire():
                rule.fired += 1
                fire = rule
        if fire is not None:
            _injected[name] = _injected.get(name, 0) + 1
    if fire is None:
        return
    label = fire.label()
    if _telemetry._ENABLED:
        _telemetry.hooks.chaos_inject(name, label)
    action = fire.action
    if action == RAISE:
        raise ChaosInjected("chaos: injected fault at %r (hit %d)"
                            % (name, fire.hits), point=name)
    if action == KILL:
        # last act before the SIGKILL-shaped death: mark the flight
        # recorder (injected point + in-flight trace) and msync -- the
        # postmortem the blackbox CLI renders.  os._exit skips atexit
        # and every buffered sink; the mmap ring is all that survives.
        from .. import obs as _obs
        _obs.flight.emergency_dump("chaos.kill", point=name,
                                   hit=fire.hits)
        os._exit(137)           # SIGKILL-shaped: no atexit, no flush
    action(dict(ctx, point=name))


def survived(point, how=None):
    """Record a tolerated fault at ``point`` -- called by the recovery
    paths themselves (quarantine, write retry, swap rollback, re-entrant
    signal suppression), so survival is counted whether the fault was
    injected or real weather."""
    with _lock:
        _survived[point] = _survived.get(point, 0) + 1
    if _telemetry._ENABLED:
        _telemetry.hooks.chaos_survive(point, how)


def stats():
    """Local mirror of the chaos counters:
    ``{"hits": {...}, "injected": {...}, "survived": {...}}``."""
    with _lock:
        return {"hits": dict(_hits), "injected": dict(_injected),
                "survived": dict(_survived)}


@contextlib.contextmanager
def scenario(seed=0):
    """One deterministic chaos scenario: clears previous rules, arms
    with ``seed``, disarms on exit (stats survive until the next
    scenario/reset, so assertions can run after the block)."""
    reset()
    arm(seed)
    try:
        yield
    finally:
        disarm()


# ----------------------------------------------------------------------
# Cross-process chaos: a scenario serialized for launched ranks.  The launcher (a test, CI's chaos_dist stage) builds a spec
# with make_spec() and ships it in MXNET_TPU_CHAOS_SPEC; each worker
# replays it with arm_from_spec() -- an EXPLICIT harness call, so a
# production process with the variable in its environment stays inert
# (the same env-inert contract as arm()).  Rules can be scoped to one
# launcher rank and one supervisor generation, so "KILL rank 1 between
# the written and committed barriers, generation 0 only" is one JSON
# line replayed identically by every rank of every relaunch.
# ----------------------------------------------------------------------

def make_spec(seed=0, rules=()):
    """Serialize a chaos scenario for cross-process replay.  Each rule
    is a dict: ``point`` (required), ``action`` (``"raise"`` (default),
    ``"kill"``, ``{"sleep": seconds}``, or ``{"truncate": {"fname": f,
    "keep": n}}``), ``nth``/``prob``/``times`` as in :func:`on`, plus
    ``rank`` / ``generation`` scoping (omit = every rank / every
    generation)."""
    spec = {"seed": seed, "rules": [dict(r) for r in rules]}
    for rule in spec["rules"]:
        _spec_action(rule.get("action", RAISE))   # validate early
        if "point" not in rule:
            raise MXNetError("chaos spec rule without a point: %r"
                             % (rule,))
    return json.dumps(spec, sort_keys=True)


def _spec_action(action):
    """Deserialize one spec action into what :func:`on` takes."""
    if action in (RAISE, KILL):
        return action
    if isinstance(action, dict) and len(action) == 1:
        if "sleep" in action:
            return sleep(float(action["sleep"]))
        if "truncate" in action:
            t = action["truncate"]
            if isinstance(t, str):
                return truncate(t)
            return truncate(t["fname"], keep=int(t.get("keep", 8)))
    raise MXNetError("chaos spec: unknown action %r (want 'raise', "
                     "'kill', {'sleep': s} or {'truncate': ...})"
                     % (action,))


def arm_from_spec(spec=None, rank=None, generation=None):
    """Arm this process from a serialized rule spec -- the multi-rank
    test harness's EXPLICIT opt-in.  ``spec`` defaults to the
    ``MXNET_TPU_CHAOS_SPEC`` environment variable; absent/empty returns
    False without arming anything.  ``rank`` defaults to
    ``MXNET_TPU_PROC_ID`` and ``generation`` to
    ``MXNET_TPU_GENERATION``; rules scoped to another rank/generation
    are skipped, so one spec drives a whole launched world across
    supervisor relaunches.  Clears previous rules, then arms with the
    spec's seed (rules replay deterministically per rank)."""
    if spec is None:
        spec = os.environ.get("MXNET_TPU_CHAOS_SPEC", "")
    if isinstance(spec, (bytes, str)):
        if not spec.strip():
            return False
        spec = json.loads(spec)
    if rank is None:
        rank = _env_int("MXNET_TPU_PROC_ID")
    if generation is None:
        generation = _env_int("MXNET_TPU_GENERATION")
    reset()
    arm(spec.get("seed", 0))
    for rule in spec.get("rules", ()):
        if rule.get("rank") is not None and int(rule["rank"]) != rank:
            continue
        if rule.get("generation") is not None \
                and int(rule["generation"]) != generation:
            continue
        nth = rule.get("nth")
        if isinstance(nth, list):
            nth = tuple(nth)
        on(rule["point"], action=_spec_action(rule.get("action", RAISE)),
           nth=nth, prob=rule.get("prob"), times=rule.get("times"))
    return True


def _env_int(name):
    try:
        return int(os.environ.get(name, "0") or 0)
    except ValueError:
        return 0
