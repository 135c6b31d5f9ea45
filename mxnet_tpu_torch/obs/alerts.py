"""Declarative SLO alerting for the fleet plane (counterpart of
``mxnet_tpu/obs/alerts.py``).

A :class:`Rule` names a fleet metric (``p99_latency_ms``,
``shed_ratio``, ``error_ratio``, ``replica_down``), a threshold, and
TWO burn-rate windows -- the multi-window discipline SRE paging uses:
the **fast** window makes the alert responsive, the **slow** window
makes it credible, and only when BOTH burn does the alert fire, so a
single slow round trip can never page.  Each alert is a typed state
machine::

    ok -> pending   (fast window burning)
       -> firing    (fast AND slow windows burning; reason names the
                     replica/rank/generation that caused it)
       -> resolved  (no breach for resolve_s -- sustained recovery,
                     not one lucky sample)
       -> ok        (after holddown_s, bounding flap frequency)

``replica_down`` uses zero-length windows by design: a dead replica is
not a statistical claim, so it fires within one scrape round and
resolves the moment the rank is healthy again (the supervisor-relaunch
contract).

Resolved alerts land in a bounded history ring; the engine publishes
``fleet.alerts_firing`` + a ``fleet.alert`` event per transition when
telemetry is enabled, and ``/alertz`` (obs.server) renders the whole
thing.  Rules are overridable per deployment via
``MXNET_TPU_OBS_ALERT_RULES`` (JSON list of rule dicts, merged onto
the defaults by name).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque

from .. import sync as _sync
from ..base import MXNetError

__all__ = ["Rule", "Alert", "AlertEngine", "default_rules",
           "parse_rules", "METRICS"]

# The metrics the engine knows how to judge.  ``replica_down`` is a
# count (breach when > threshold); the ratios/latency are floats.
METRICS = ("p99_latency_ms", "shed_ratio", "error_ratio",
           "replica_down")

_HISTORY = 256          # bounded ring of resolved/cancelled alerts


class Rule:
    """One declarative SLO rule.  ``metric`` defaults to ``name`` so
    the four stock rules read naturally; a tuned deployment may carry
    several rules over one metric under distinct names."""

    __slots__ = ("name", "metric", "threshold", "fast_s", "slow_s",
                 "fast_burn", "slow_burn", "resolve_s", "holddown_s")

    def __init__(self, name, threshold, metric=None, fast_s=30.0,
                 slow_s=300.0, fast_burn=0.5, slow_burn=0.5,
                 resolve_s=60.0, holddown_s=60.0):
        metric = name if metric is None else metric
        if metric not in METRICS:
            raise MXNetError(
                "alert rule %r: unknown metric %r (known: %s)"
                % (name, metric, ", ".join(METRICS)))
        if fast_s > slow_s:
            raise MXNetError(
                "alert rule %r: fast window (%gs) must not exceed the "
                "slow window (%gs)" % (name, fast_s, slow_s))
        self.name = name
        self.metric = metric
        self.threshold = float(threshold)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.resolve_s = float(resolve_s)
        self.holddown_s = float(holddown_s)

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return ("Rule(%s: %s > %g, fast %gs@%.0f%%, slow %gs@%.0f%%)"
                % (self.name, self.metric, self.threshold, self.fast_s,
                   100 * self.fast_burn, self.slow_s,
                   100 * self.slow_burn))


def default_rules():
    """The stock rule set (thresholds are deliberately conservative;
    tune per deployment via MXNET_TPU_OBS_ALERT_RULES)."""
    return [
        Rule("p99_latency_ms", threshold=500.0),
        Rule("shed_ratio", threshold=0.05),
        Rule("error_ratio", threshold=0.02),
        # a dead replica is a fact, not a trend: zero-length windows
        # fire within one scrape round; resolve_s=0 resolves on the
        # first healthy round after the relaunch lands
        Rule("replica_down", threshold=0.0, fast_s=0.0, slow_s=0.0,
             resolve_s=0.0, holddown_s=0.0),
    ]


def parse_rules(spec=None):
    """Rules from a JSON spec (``MXNET_TPU_OBS_ALERT_RULES`` when
    ``spec`` is None): a list of rule dicts merged ONTO the defaults by
    name -- override a stock threshold/window, or add a new named rule
    over a known metric.  Empty/unset spec returns the defaults; an
    unparseable spec raises loudly (a silently-ignored alert config is
    the worst possible failure mode for an alerting plane)."""
    if spec is None:
        spec = os.environ.get("MXNET_TPU_OBS_ALERT_RULES", "")
    rules = {r.name: r for r in default_rules()}
    if not spec or not str(spec).strip():
        return list(rules.values())
    try:
        overrides = json.loads(spec) if isinstance(spec, str) else spec
    except ValueError as e:
        raise MXNetError("MXNET_TPU_OBS_ALERT_RULES is not valid "
                         "JSON: %s" % e) from e
    if not isinstance(overrides, list):
        raise MXNetError("MXNET_TPU_OBS_ALERT_RULES must be a JSON "
                         "list of rule dicts, got %r" % type(overrides))
    for d in overrides:
        if not isinstance(d, dict) or "name" not in d:
            raise MXNetError("alert rule spec needs a 'name': %r" % (d,))
        name = d["name"]
        base = rules.get(name)
        merged = base.as_dict() if base is not None else {}
        unknown = set(d) - set(Rule.__slots__)
        if unknown:
            raise MXNetError("alert rule %r: unknown field(s) %s"
                             % (name, ", ".join(sorted(unknown))))
        merged.update(d)
        if "threshold" not in merged:
            raise MXNetError("alert rule %r needs a threshold" % name)
        rules[name] = Rule(**merged)
    return list(rules.values())


class Alert:
    """One alert instance walking pending -> firing -> resolved."""

    __slots__ = ("rule", "metric", "state", "reason", "value",
                 "threshold", "pending_since", "fired_at",
                 "resolved_at")

    def __init__(self, rule, value, reason, now):
        self.rule = rule.name
        self.metric = rule.metric
        self.threshold = rule.threshold
        self.state = "pending"
        self.value = value
        self.reason = reason
        self.pending_since = now
        self.fired_at = None
        self.resolved_at = None

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return "Alert(%s %s: %s)" % (self.rule, self.state, self.reason)


class AlertEngine:
    """Evaluate a rule set over a stream of fleet metric samples.

    ``observe(values, detail=None, now=None)`` takes one scrape round's
    metric values (``{metric: float-or-None}``; None = no data this
    round, which contributes NO observation -- silence is not health)
    plus optional per-metric detail strings that land in the alert
    reason (``replica_down`` detail names rank/generation/pid).
    Thread-safe; the FleetMonitor calls it from its poll thread and
    ``/alertz`` reads it from HTTP handler threads.
    """

    def __init__(self, rules=None, history=_HISTORY):
        self.rules = list(rules) if rules is not None else parse_rules()
        self._lock = _sync.Lock(name="obs.alert_engine")
        self._obs = {r.name: deque() for r in self.rules}
        self._active = {}           # rule name -> Alert (pending|firing)
        self._holddown = {}         # rule name -> ok-again time
        self._history = deque(maxlen=int(history))
        self._transitions = 0

    # -- evaluation ----------------------------------------------------
    def observe(self, values, detail=None, now=None):
        """Fold one round of metric values; returns the list of alerts
        that TRANSITIONED this round (new pending, fired, resolved)."""
        now = time.time() if now is None else float(now)
        detail = detail or {}
        changed = []
        with self._lock:
            for rule in self.rules:
                value = values.get(rule.metric)
                if value is None:
                    continue
                ring = self._obs[rule.name]
                breach = float(value) > rule.threshold
                ring.append((now, breach))
                horizon = now - max(rule.slow_s, rule.resolve_s) - 1.0
                while ring and ring[0][0] < horizon:
                    ring.popleft()
                changed.extend(
                    self._step_rule(rule, value, breach,
                                    detail.get(rule.metric), now))
        for alert in changed:
            self._publish(alert)
        return changed

    def _burn(self, rule, window_s, now):
        """Breach fraction over the trailing window (None = no
        observations in the window).  A zero-length window judges only
        observations from this instant -- the replica_down case."""
        ring = self._obs[rule.name]
        if window_s <= 0:
            obs = [b for (t, b) in ring if t >= now]
        else:
            obs = [b for (t, b) in ring if t >= now - window_s]
        if not obs:
            return None
        return sum(1 for b in obs if b) / len(obs)

    def _step_rule(self, rule, value, breach, detail, now):
        # under self._lock
        changed = []
        alert = self._active.get(rule.name)
        fast = self._burn(rule, rule.fast_s, now)
        slow = self._burn(rule, rule.slow_s, now)
        if alert is None:
            if now < self._holddown.get(rule.name, 0.0):
                return changed
            if breach and fast is not None and fast >= rule.fast_burn:
                alert = Alert(rule, value,
                              self._reason(rule, value, detail), now)
                self._active[rule.name] = alert
                changed.append(alert)
        if alert is None:
            return changed
        if alert.state == "pending":
            if fast is not None and fast >= rule.fast_burn \
                    and slow is not None and slow >= rule.slow_burn:
                # BOTH windows burn: the multi-window page condition
                alert.state = "firing"
                alert.fired_at = now
                alert.value = value
                alert.reason = self._reason(rule, value, detail)
                if alert not in changed:
                    changed.append(alert)
            elif fast is not None and fast < rule.fast_burn:
                # the blip passed before the slow window agreed:
                # cancel without ever paging
                alert.state = "cancelled"
                alert.resolved_at = now
                del self._active[rule.name]
                self._history.append(alert.as_dict())
                changed.append(alert)
        elif alert.state == "firing":
            if breach:
                alert.value = value
                alert.reason = self._reason(rule, value, detail)
            else:
                last_breach = max((t for (t, b) in self._obs[rule.name]
                                   if b), default=None)
                clean_for = now - last_breach \
                    if last_breach is not None else float("inf")
                if clean_for >= rule.resolve_s:
                    alert.state = "resolved"
                    alert.resolved_at = now
                    alert.reason += " | recovered%s" % (
                        " (%s)" % detail if detail else "")
                    del self._active[rule.name]
                    self._history.append(alert.as_dict())
                    self._holddown[rule.name] = now + rule.holddown_s
                    changed.append(alert)
        return changed

    @staticmethod
    def _reason(rule, value, detail):
        head = "%s %.4g > %.4g" % (rule.metric, float(value),
                                   rule.threshold)
        return "%s: %s" % (head, detail) if detail else head

    def _publish(self, alert):
        from .. import telemetry as _telemetry
        if not _telemetry._ENABLED:
            return
        _telemetry.hooks.fleet_alert(alert.rule, alert.state,
                                     alert.reason, alert.value)
        _telemetry.hooks.fleet_alerts_firing(len(self.firing()))

    # -- read side -----------------------------------------------------
    def firing(self):
        with self._lock:
            return [a for a in self._active.values()
                    if a.state == "firing"]

    def active(self):
        """Pending + firing alerts."""
        with self._lock:
            return list(self._active.values())

    def history(self):
        """Resolved/cancelled alerts, oldest first (bounded ring)."""
        with self._lock:
            return list(self._history)

    def alertz(self):
        """The ``/alertz`` payload."""
        with self._lock:
            return {
                "schema": "mxalertz.v1",
                "firing": [a.as_dict() for a in self._active.values()
                           if a.state == "firing"],
                "pending": [a.as_dict() for a in self._active.values()
                            if a.state == "pending"],
                "history": list(self._history),
                "rules": [r.as_dict() for r in self.rules],
            }
