"""Fleet observability plane (counterpart of ``mxnet_tpu/obs/fleet.py``):
endpoint discovery, the scrape client + FleetMonitor, and fleet-level
aggregation.  Files, payloads, aggregates and the rendered table are the
JAX package's, so either package's monitor watches the other's workers.

Three contracts, each mirroring a discipline the repo already proved
single-process:

- **Endpoint discovery** -- every obs server publishes
  ``{pid, rank, generation, port, started_at}`` to
  ``MXNET_TPU_OBS_ENDPOINTS_DIR`` as ``r<rank>.<pid>.json`` through the
  checkpoint-core atomic commit (torn registrations cannot exist), and
  every publish sweeps sibling files whose writer pid is dead -- the
  checkpoint core's stale-tmp discipline applied to registrations.  The
  supervisor threads the directory into every launched world, so a
  relaunched generation re-registers under the same rank with a new
  pid/generation automatically.
- **Scrape + typed snapshots** -- :func:`scrape` polls one replica's
  ``/healthz`` + ``/statusz`` + ``/metrics`` into a
  :class:`ReplicaSnapshot`; ``/statusz`` replies carrying an unknown
  ``schema`` are rejected LOUDLY (:class:`SchemaMismatch`) -- the
  cross-process contract a silent parse-anyway would rot.  The
  :class:`FleetMonitor` polls every discovered endpoint with
  per-replica timeout/retry/backoff; a replica that stops answering is
  *sick*, and stale-past-TTL (or a provably dead pid) flips it to
  *presumed down* -- the liveness-lease discipline.
- **Aggregation** -- per round the monitor pools each replica's DELTAS
  (never lifetime totals) into fleet QPS, summed queue depth, shed and
  error ratios, and latency percentiles computed by MERGING the Timer
  histogram buckets across replicas (:class:`MergedHistogram`; the
  fixed power-of-2 bucket grid makes cross-process merge exact) --
  averaging per-replica p99s is statistically meaningless and a test
  proves it wrong.  Served-step and goodput-category skew generalize
  the goodput ledger's straggler attribution across processes.

The :class:`~mxnet_tpu_torch.obs.alerts.AlertEngine` rides every round;
``/alertz`` (obs.server) and ``mxtelemetry fleet`` render the result.
"""
from __future__ import annotations

import http.client
import json
import os
import re
import socket
import time
import urllib.error
import urllib.request

from .. import sync as _sync
from ..base import MXNetError
from . import alerts as _alerts

__all__ = [
    "Endpoint", "ReplicaSnapshot", "FleetMonitor", "MergedHistogram",
    "ScrapeError", "SchemaMismatch", "STATUSZ_SCHEMA",
    "publish_endpoint", "remove_endpoint", "sweep_endpoints",
    "discover", "scrape", "active",
]

# The /statusz contract version this scrape client speaks.  Bump it
# when the statusz shape changes incompatibly; the client REFUSES
# unknown schemas instead of guessing.
STATUSZ_SCHEMA = "mxstatusz.v1"

_ENDPOINT_RE = re.compile(r"^r(\d+)\.(\d+)\.json$")

# Published endpoint paths owned by THIS process (removed on
# server.stop()); monitors running in this process.
_published = []
_monitors = []


class ScrapeError(MXNetError):
    """A replica scrape failed (refused/timed out/garbage payload)."""


class SchemaMismatch(ScrapeError):
    """A replica answered /statusz with a schema this client does not
    speak -- a version-skewed or foreign process; never parse it."""


# ----------------------------------------------------------------------
# endpoint discovery contract
# ----------------------------------------------------------------------

def _endpoints_dir(dirpath=None):
    if dirpath is None:
        dirpath = os.environ.get("MXNET_TPU_OBS_ENDPOINTS_DIR", "")
    return dirpath or None


def _rank():
    try:
        return int(os.environ.get("MXNET_TPU_PROC_ID", "0") or 0)
    except ValueError:
        return 0


def _generation():
    try:
        return int(os.environ.get("MXNET_TPU_GENERATION", "0") or 0)
    except ValueError:
        return 0


class Endpoint:
    """One discovered obs-server registration."""

    __slots__ = ("pid", "rank", "generation", "port", "started_at",
                 "path")

    def __init__(self, pid, rank, generation, port, started_at,
                 path=None):
        self.pid = int(pid)
        self.rank = int(rank)
        self.generation = int(generation)
        self.port = int(port)
        self.started_at = float(started_at)
        self.path = path

    @property
    def url(self):
        return "http://127.0.0.1:%d" % self.port

    def as_dict(self):
        return {"pid": self.pid, "rank": self.rank,
                "generation": self.generation, "port": self.port,
                "started_at": self.started_at}

    def __repr__(self):
        return ("Endpoint(rank=%d gen=%d pid=%d port=%d)"
                % (self.rank, self.generation, self.pid, self.port))


def sweep_endpoints(dirpath):
    """Remove endpoint files whose writer pid is dead -- the
    stale-tmp sweep applied to registrations.  Live pids (including
    ours) are left alone.  Returns the removed paths."""
    from ..checkpoint.core import _pid_alive
    removed = []
    try:
        entries = os.listdir(dirpath)
    except OSError:
        return removed
    for name in entries:
        m = _ENDPOINT_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(2))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(dirpath, name)
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def publish_endpoint(port, dirpath=None, rank=None, generation=None):
    """Atomically publish this process's obs endpoint to the discovery
    directory (``MXNET_TPU_OBS_ENDPOINTS_DIR`` when ``dirpath`` is
    None; unset = no-op returning None).  Uses the checkpoint-core
    atomic commit, so a reader can never observe a torn registration,
    and sweeps dead-pid siblings first so a crashed generation's
    residue never outlives its relaunch."""
    from ..checkpoint.core import atomic_write_bytes
    dirpath = _endpoints_dir(dirpath)
    if dirpath is None:
        return None
    rank = _rank() if rank is None else int(rank)
    generation = _generation() if generation is None else int(generation)
    os.makedirs(dirpath, exist_ok=True)
    sweep_endpoints(dirpath)
    ep = Endpoint(os.getpid(), rank, generation, port, time.time())
    path = os.path.join(dirpath, "r%d.%d.json" % (rank, os.getpid()))
    atomic_write_bytes(path, json.dumps(ep.as_dict(),
                                        sort_keys=True).encode())
    ep.path = path
    _published.append(path)
    return path


def remove_endpoint(path=None):
    """Withdraw this process's registration(s) -- the clean-departure
    path (obs.server.stop()); a dead-pid sweep covers the crash path."""
    paths = [path] if path is not None else list(_published)
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass
        if p in _published:
            _published.remove(p)


def discover(dirpath):
    """Parse every endpoint file in ``dirpath`` into Endpoints, newest
    generation winning per rank.  Unparseable files are skipped (the
    atomic publish makes torn files impossible; garbage means a foreign
    writer, and discovery must not die on it)."""
    by_rank = {}
    try:
        entries = os.listdir(dirpath)
    except OSError:
        return []
    for name in sorted(entries):
        if _ENDPOINT_RE.match(name) is None:
            continue
        path = os.path.join(dirpath, name)
        try:
            with open(path) as f:
                d = json.load(f)
            ep = Endpoint(d["pid"], d["rank"], d["generation"],
                          d["port"], d.get("started_at", 0.0),
                          path=path)
        except (OSError, ValueError, KeyError, TypeError):
            continue
        old = by_rank.get(ep.rank)
        if old is None or (ep.generation, ep.started_at) \
                >= (old.generation, old.started_at):
            by_rank[ep.rank] = ep
    return [by_rank[r] for r in sorted(by_rank)]


def active():
    """Whether this process participates in the fleet plane (publishes
    an endpoint or runs a monitor)."""
    return bool(_endpoints_dir() or _published or _monitors)


# ----------------------------------------------------------------------
# scrape client
# ----------------------------------------------------------------------

def _http_json(url, timeout_s):
    """GET ``url`` -> parsed JSON; 503 bodies parse too (NOT_READY is
    an answer, not a failure)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            body = r.read()
    except urllib.error.HTTPError as e:
        if e.code != 503:
            raise ScrapeError("GET %s -> HTTP %d" % (url, e.code)) from e
        body = e.read()
    except (urllib.error.URLError, socket.timeout, OSError,
            http.client.HTTPException) as e:
        # URLError: refused/unreachable; timeout: a hung replica;
        # HTTPException incl. IncompleteRead: a replica that died
        # mid-response -- every one is "this scrape failed", typed
        raise ScrapeError("GET %s failed: %s" % (url, e)) from e
    try:
        return json.loads(body)
    except ValueError as e:
        raise ScrapeError("GET %s returned unparseable JSON (%d bytes)"
                          % (url, len(body))) from e


def _http_text(url, timeout_s):
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return r.read().decode("utf-8", "replace")
    except (urllib.error.URLError, socket.timeout, OSError,
            http.client.HTTPException) as e:
        raise ScrapeError("GET %s failed: %s" % (url, e)) from e


_PROM_LINE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')
_PROM_LE = re.compile(r'le="([^"]+)"')


def _parse_prom(text):
    """Prometheus text exposition -> ``(values, buckets)``:
    ``values[name]`` = plain sample (counters/gauges/_count/_sum),
    ``buckets[base]`` = cumulative ``{le_seconds: count}`` per
    histogram (``+Inf`` folded in as ``inf``)."""
    values, buckets = {}, {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            continue
        name, labels, raw = m.group("name", "labels", "value")
        try:
            value = float(raw)
        except ValueError:
            continue
        if labels and name.endswith("_bucket"):
            le = _PROM_LE.search(labels)
            if le is None:
                continue
            bound = float("inf") if le.group(1) == "+Inf" \
                else float(le.group(1))
            buckets.setdefault(name[:-len("_bucket")], {})[bound] = value
        elif not labels:
            values[name] = value
    return values, buckets


class ReplicaSnapshot:
    """One successful scrape of one replica, typed."""

    __slots__ = ("url", "t", "ready", "reasons", "rank", "generation",
                 "pid", "served_step", "published_step", "queue_depth",
                 "counters", "latency", "goodput", "statusz")

    def __init__(self, url, t, ready, reasons, statusz, counters,
                 latency):
        self.url = url
        self.t = t
        self.ready = bool(ready)
        self.reasons = list(reasons or ())
        self.statusz = statusz
        self.rank = statusz.get("rank")
        self.generation = statusz.get("generation")
        self.pid = statusz.get("pid")
        self.served_step = statusz.get("served_step")
        self.published_step = statusz.get("published_step")
        self.queue_depth = sum(s.get("queue_depth") or 0
                               for s in statusz.get("servables", ()))
        self.counters = counters        # requests/responses/shed/...
        self.latency = latency          # cumulative {le_s: count}
        self.goodput = statusz.get("goodput")

    def __repr__(self):
        return ("ReplicaSnapshot(rank=%s gen=%s ready=%s reqs=%s)"
                % (self.rank, self.generation, self.ready,
                   self.counters.get("requests")))


def _prom(name):
    from ..telemetry.sinks import _prom_name
    return _prom_name(name)


# the serving counters a fleet aggregate is built from, by their
# dotted instrument names (mangled to prom names at parse time)
_SCRAPED_COUNTERS = {
    "requests": "serving.requests",
    "responses": "serving.responses",
    "shed": "serving.shed",
    "timeouts": "serving.timeouts",
    "errors": "serving.errors",
}


def scrape(url, timeout_s=1.0):
    """Poll one replica's three endpoints into a ReplicaSnapshot.
    Raises :class:`ScrapeError` on any transport/parse failure and
    :class:`SchemaMismatch` on an unknown /statusz schema."""
    url = url.rstrip("/")
    health = _http_json(url + "/healthz", timeout_s)
    statusz = _http_json(url + "/statusz", timeout_s)
    if not isinstance(statusz, dict):
        raise ScrapeError("%s/statusz is not a JSON object" % url)
    schema = statusz.get("schema")
    if schema != STATUSZ_SCHEMA:
        raise SchemaMismatch(
            "%s/statusz speaks schema %r, this client speaks %r -- "
            "refusing to parse a version-skewed replica"
            % (url, schema, STATUSZ_SCHEMA))
    values, buckets = _parse_prom(_http_text(url + "/metrics",
                                             timeout_s))
    counters = {key: values.get(_prom(name), 0.0)
                for key, name in _SCRAPED_COUNTERS.items()}
    latency = dict(buckets.get(_prom("serving.latency"), {}))
    return ReplicaSnapshot(
        url, time.time(),
        ready=health.get("status") == "READY",
        reasons=health.get("reasons"),
        statusz=statusz, counters=counters, latency=latency)


# ----------------------------------------------------------------------
# histogram merge -- NEVER average percentiles
# ----------------------------------------------------------------------

def _per_bucket(cum):
    """Cumulative ``{le: count}`` -> per-bucket increments (the +Inf
    entry absorbs anything past the last finite bound)."""
    out = {}
    prev = 0.0
    for le in sorted(cum):
        n = cum[le] - prev
        prev = cum[le]
        if n > 0:
            out[le] = out.get(le, 0.0) + n
    return out


class MergedHistogram:
    """Bucket-wise sum of Timer histograms across replicas/rounds.

    Because every Timer shares the fixed power-of-2 bucket grid
    (telemetry.core._TIMER_BUCKETS), cross-process merge is an exact
    per-bucket addition, and a percentile of the merged histogram is
    the same estimator a single pooled Timer would have produced --
    correct within one bucket (a factor of 2).  The mean of
    per-replica p99s has NO such guarantee: a quiet replica's p99
    counts as much as a busy one's, and a test pins a
    case where the average is off by an order of magnitude."""

    __slots__ = ("_buckets",)

    def __init__(self):
        self._buckets = {}      # le upper bound (s) -> count in bucket

    def add_buckets(self, per_bucket):
        """Fold per-bucket (non-cumulative) ``{le: n}`` counts in."""
        for le, n in per_bucket.items():
            if n:
                self._buckets[float(le)] = \
                    self._buckets.get(float(le), 0.0) + n

    def add_cumulative(self, cum):
        """Fold a prom-style cumulative ``{le: count}`` histogram in."""
        self.add_buckets(_per_bucket(cum))

    def merge(self, other):
        self.add_buckets(other._buckets)
        return self

    @property
    def count(self):
        return sum(self._buckets.values())

    def percentile(self, q):
        """Histogram-estimated q-quantile: the upper bound of the
        bucket where the cumulative count crosses ``q * count`` (the
        Timer.percentile algorithm over the merged buckets)."""
        total = self.count
        if not total:
            return None
        rank = q * total
        acc = 0.0
        est = None
        for le in sorted(self._buckets):
            acc += self._buckets[le]
            est = le
            if acc >= rank:
                break
        return est

    def snapshot(self):
        return dict(self._buckets)


def _delta_hist(cur, prev):
    """Per-bucket delta between two cumulative histograms (a fresh
    replica's first scrape has no previous -> empty delta; lifetime
    history must not pollute a live SLO window)."""
    a, b = _per_bucket(cur), _per_bucket(prev)
    out = {}
    for le, n in a.items():
        d = n - b.get(le, 0.0)
        if d > 0:
            out[le] = d
    return out


# ----------------------------------------------------------------------
# the monitor
# ----------------------------------------------------------------------

class _Replica:
    """Per-endpoint scrape state (keyed by rank in directory mode, by
    URL in explicit-URL mode)."""

    __slots__ = ("key", "url", "endpoint", "snapshot", "prev",
                 "last_ok_t", "failures", "last_error", "down_since",
                 "file_gone")

    def __init__(self, key, url, endpoint=None):
        self.key = key
        self.url = url
        self.endpoint = endpoint
        self.snapshot = None        # last good ReplicaSnapshot
        self.prev = None            # the one before (delta basis)
        self.last_ok_t = None
        self.failures = 0
        self.last_error = None
        self.down_since = None
        self.file_gone = False

    @property
    def rank(self):
        if self.snapshot is not None and self.snapshot.rank is not None:
            return self.snapshot.rank
        return self.endpoint.rank if self.endpoint is not None else None

    @property
    def generation(self):
        if self.snapshot is not None \
                and self.snapshot.generation is not None:
            return self.snapshot.generation
        return self.endpoint.generation if self.endpoint is not None \
            else None

    @property
    def pid(self):
        if self.endpoint is not None:
            return self.endpoint.pid
        return self.snapshot.pid if self.snapshot is not None else None

    def state(self, now, ttl_s):
        if self.down_since is not None:
            return "down"
        if self.failures == 0 and self.snapshot is None:
            return "init"
        if self.failures == 0:
            return "ok"
        if self.last_ok_t is not None and now - self.last_ok_t <= ttl_s:
            return "sick"
        if self.last_ok_t is None and self.snapshot is None \
                and not self._pid_dead() and not self.file_gone:
            # never answered yet and not provably dead: still starting
            return "sick"
        return "down"

    def _pid_dead(self):
        from ..checkpoint.core import _pid_alive
        pid = self.pid
        return pid is not None and not _pid_alive(pid)


class FleetMonitor:
    """Background poller over the discovered fleet.

    ``source`` is either the endpoints directory (discovery mode: the
    replica set follows the directory, keyed by rank so a relaunched
    generation REPLACES its predecessor) or an explicit list of base
    URLs.  ``poll_once()`` runs one scrape round synchronously and
    returns the fleet snapshot; ``start()`` runs rounds on a daemon
    thread every ``scrape_ms``.

    The monitor must never crash or wedge on a sick replica: every
    scrape is bounded by ``timeout_s``, retried ``retries`` times with
    doubling backoff from ``backoff_s``, and any failure only updates
    that replica's state.  A replica is *presumed down* when its data
    is stale past ``ttl_s`` (default 3 scrape intervals), when its
    registered pid is provably dead, or when its endpoint file vanished
    while it was failing -- the liveness-lease discipline.
    """

    def __init__(self, source, scrape_ms=None, ttl_s=None,
                 timeout_s=None, retries=1, backoff_s=0.05,
                 rules=None, window_s=None):
        if scrape_ms is None:
            from .. import env as _env
            scrape_ms = _env.get("MXNET_TPU_OBS_SCRAPE_MS")
        self.scrape_s = max(float(scrape_ms) / 1e3, 1e-3)
        self.ttl_s = float(ttl_s) if ttl_s is not None \
            else 3.0 * self.scrape_s
        self.timeout_s = float(timeout_s) if timeout_s is not None \
            else max(min(1.0, self.scrape_s), 0.05)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.window_s = float(window_s) if window_s is not None \
            else max(60.0, 3.0 * self.scrape_s)
        if isinstance(source, str):
            self.endpoints_dir = source
            self.urls = None
        else:
            self.endpoints_dir = None
            self.urls = [u.rstrip("/") for u in source]
        self.engine = _alerts.AlertEngine(rules=rules)
        self._replicas = {}
        self._window = []           # (t, delta record) rolling ring
        self._lock = _sync.Lock(name="obs.fleet_monitor")
        self._stop = _sync.Event(name="obs.fleet_monitor_stop")
        self._thread = None
        self.last = None            # newest fleet snapshot dict
        self.rounds = 0
        _monitors.append(self)
        from . import status as _status
        _status.register_fleet(self)

    # -- discovery -----------------------------------------------------
    def _refresh_targets(self):
        if self.urls is not None:
            for url in self.urls:
                if url not in self._replicas:
                    self._replicas[url] = _Replica(url, url)
            return
        seen = set()
        for ep in discover(self.endpoints_dir):
            seen.add(ep.rank)
            rep = self._replicas.get(ep.rank)
            if rep is None or rep.endpoint is None \
                    or rep.endpoint.pid != ep.pid \
                    or rep.endpoint.generation != ep.generation:
                # new rank, or a relaunch: fresh state (the old
                # generation's lifetime counters must not delta
                # against the new one's)
                self._replicas[ep.rank] = _Replica(ep.rank, ep.url, ep)
            else:
                rep.endpoint = ep
                rep.file_gone = False
        for rank, rep in list(self._replicas.items()):
            if rank in seen:
                continue
            if rep.snapshot is not None and rep.failures == 0:
                # healthy and cleanly deregistered: departed, drop
                del self._replicas[rank]
            else:
                rep.file_gone = True

    # -- one scrape round ----------------------------------------------
    def _scrape_one(self, rep, now):
        last_err = None
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(min(self.backoff_s * (2 ** (attempt - 1)),
                               self.scrape_s))
            try:
                snap = scrape(rep.url, timeout_s=self.timeout_s)
            except ScrapeError as e:
                last_err = e
                continue
            except Exception as e:      # a sick replica must never
                last_err = e            # crash the monitor
                continue
            rep.prev, rep.snapshot = rep.snapshot, snap
            rep.last_ok_t = snap.t
            rep.failures = 0
            rep.last_error = None
            rep.down_since = None
            self._hook(lambda h: h.fleet_scrape(True))
            return True
        rep.failures += 1
        rep.last_error = str(last_err)
        self._hook(lambda h: h.fleet_scrape(False))
        return False

    @staticmethod
    def _hook(fn):
        from .. import telemetry as _telemetry
        if _telemetry._ENABLED:
            fn(_telemetry.hooks)

    def poll_once(self, now=None):
        """One synchronous round: refresh targets, scrape every
        replica, aggregate, evaluate alerts.  Returns (and stores as
        ``self.last``) the fleet snapshot dict."""
        with self._lock:
            return self._poll_locked(now)

    def _poll_locked(self, now):
        self._refresh_targets()
        for rep in self._replicas.values():
            self._scrape_one(rep, now)
        now = time.time() if now is None else float(now)
        # lease discipline: stale-past-TTL / dead pid => presumed down
        down = []
        rows = []
        for key in sorted(self._replicas,
                          key=lambda k: (str(type(k)), k)):
            rep = self._replicas[key]
            if rep.failures and rep._pid_dead():
                rep.last_ok_t = None        # dead is dead: no TTL grace
            state = rep.state(now, self.ttl_s)
            if state == "down":
                if rep.down_since is None:
                    rep.down_since = now
                    self._hook(lambda h, r=rep: h.fleet_replica_down(
                        r.rank, r.generation, r.last_error))
                down.append(rep)
            rows.append(self._row(rep, state))
        agg = self._aggregate(now, down)
        changed = self.engine.observe(
            {"p99_latency_ms": agg["latency_ms"]["p99"],
             "shed_ratio": agg["shed_ratio"],
             "error_ratio": agg["error_ratio"],
             "replica_down": float(len(down))},
            detail={"replica_down": "; ".join(
                "rank %s generation %s (pid %s) %s"
                % (r.rank, r.generation, r.pid,
                   r.last_error or "stale past TTL") for r in down)},
            now=now)
        snap = {
            "t": now,
            "replicas": rows,
            "aggregate": agg,
            "alerts": {
                "firing": [a.as_dict() for a in self.engine.firing()],
                "pending": [a.as_dict() for a in self.engine.active()
                            if a.state == "pending"],
                "transitions": [a.as_dict() for a in changed],
            },
        }
        self.last = snap
        self.rounds += 1
        self._publish(agg, down)
        return snap

    def _row(self, rep, state):
        s = rep.snapshot
        row = {"key": rep.key, "url": rep.url, "state": state,
               "rank": rep.rank, "generation": rep.generation,
               "pid": rep.pid, "failures": rep.failures,
               "last_error": rep.last_error}
        if s is not None:
            hist = MergedHistogram()
            hist.add_cumulative(s.latency)
            row.update({
                "ready": s.ready, "reasons": s.reasons,
                "served_step": s.served_step,
                "published_step": s.published_step,
                "queue_depth": s.queue_depth,
                "requests": s.counters.get("requests"),
                "shed": s.counters.get("shed"),
                "errors": (s.counters.get("errors", 0)
                           + s.counters.get("timeouts", 0)),
                "latency_p99_ms": _ms(hist.percentile(0.99)),
            })
        return row

    # -- aggregation ---------------------------------------------------
    def _round_deltas(self, now):
        """Pool each replica's counter/histogram deltas since its
        previous good scrape into one per-round record."""
        rec = {"t": now, "hist": MergedHistogram(), "requests": 0.0,
               "responses": 0.0, "shed": 0.0, "errors": 0.0,
               "span_s": 0.0}
        for rep in self._replicas.values():
            cur, prev = rep.snapshot, rep.prev
            if cur is None or prev is None or cur is prev:
                continue
            if cur.t <= prev.t:
                continue
            rec["hist"].add_buckets(_delta_hist(cur.latency,
                                                prev.latency))
            for k in ("requests", "responses", "shed"):
                rec[k] += max(cur.counters.get(k, 0.0)
                              - prev.counters.get(k, 0.0), 0.0)
            rec["errors"] += max(
                (cur.counters.get("errors", 0.0)
                 + cur.counters.get("timeouts", 0.0))
                - (prev.counters.get("errors", 0.0)
                   + prev.counters.get("timeouts", 0.0)), 0.0)
            rec["span_s"] = max(rec["span_s"], cur.t - prev.t)
        return rec

    def _aggregate(self, now, down):
        rec = self._round_deltas(now)
        self._window.append(rec)
        horizon = now - self.window_s
        self._window = [r for r in self._window if r["t"] >= horizon]
        hist = MergedHistogram()
        reqs = resp = shed = errs = span = 0.0
        for r in self._window:
            hist.merge(r["hist"])
            reqs += r["requests"]
            resp += r["responses"]
            shed += r["shed"]
            errs += r["errors"]
            span += r["span_s"]
        ups = [rep for rep in self._replicas.values()
               if rep.snapshot is not None and rep.down_since is None]
        served = [rep.snapshot.served_step for rep in ups
                  if rep.snapshot.served_step is not None]
        accepted = reqs + shed
        return {
            "replicas": len(self._replicas),
            "up": len(ups),
            "down": len(down),
            "qps": (reqs / span) if span > 0 else None,
            "queue_depth": sum(rep.snapshot.queue_depth
                               for rep in ups),
            "shed_ratio": (shed / accepted) if accepted else None,
            "error_ratio": (errs / (resp + errs))
            if (resp + errs) else None,
            "latency_ms": {
                "p50": _ms(hist.percentile(0.50)),
                "p95": _ms(hist.percentile(0.95)),
                "p99": _ms(hist.percentile(0.99)),
                "samples": hist.count,
            },
            "served_step": {
                "min": min(served) if served else None,
                "max": max(served) if served else None,
                "skew": (max(served) - min(served)) if served else None,
            },
            "goodput_skew": _goodput_skew(ups),
        }

    def _publish(self, agg, down):
        def emit(h):
            h.fleet_round(agg)
            h.fleet_alerts_firing(len(self.engine.firing()))
        self._hook(emit)

    # -- background loop ----------------------------------------------
    def start(self):
        """Run rounds on a daemon thread every ``scrape_ms``
        (idempotent)."""
        import threading
        if self._thread is not None:
            return self
        self._stop.clear()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="mxtpu-fleet-monitor")
        t.start()
        self._thread = t
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:       # the monitor never dies; a broken
                pass                # round just skips to the next one
            self._stop.wait(self.scrape_s)

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        if self in _monitors:
            _monitors.remove(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- rendering -----------------------------------------------------
    def fleet_row(self):
        """The compact /statusz row (obs.status)."""
        agg = (self.last or {}).get("aggregate") or {}
        return {"replicas": agg.get("replicas", 0),
                "up": agg.get("up", 0),
                "down": agg.get("down", 0),
                "alerts_firing": len(self.engine.firing())}

    def table(self):
        """The human fleet table + alert lines the CLI renders."""
        snap = self.last or {}
        lines = ["fleet: %d replica(s), %d up / %d down"
                 % tuple((snap.get("aggregate") or {}).get(k, 0)
                         for k in ("replicas", "up", "down"))]
        lines.append("  %-5s %-4s %-7s %-6s %-7s %-9s %-9s %s"
                     % ("rank", "gen", "state", "ready", "queue",
                        "requests", "p99", "url"))
        lines.append("  " + "-" * 70)
        for r in snap.get("replicas", ()):
            p99 = r.get("latency_p99_ms")
            lines.append(
                "  %-5s %-4s %-7s %-6s %-7s %-9s %-9s %s"
                % (r.get("rank", "?"), r.get("generation", "?"),
                   r["state"],
                   {True: "yes", False: "NO"}.get(r.get("ready"), "-"),
                   r.get("queue_depth", "-"),
                   ("%d" % r["requests"])
                   if r.get("requests") is not None else "-",
                   ("%.1fms" % p99) if p99 is not None else "-",
                   r["url"]))
        agg = snap.get("aggregate") or {}
        lat = agg.get("latency_ms") or {}
        if agg:
            lines.append("")
            lines.append(
                "  fleet: qps=%s queue=%s shed=%s err=%s "
                "p50/p95/p99=%s/%s/%s ms step_skew=%s"
                % (_fmt(agg.get("qps")), agg.get("queue_depth"),
                   _fmt(agg.get("shed_ratio")),
                   _fmt(agg.get("error_ratio")),
                   _fmt(lat.get("p50")), _fmt(lat.get("p95")),
                   _fmt(lat.get("p99")),
                   (agg.get("served_step") or {}).get("skew")))
        firing = self.engine.firing()
        pending = [a for a in self.engine.active()
                   if a.state == "pending"]
        lines.append("")
        lines.append("alerts: %d firing, %d pending"
                     % (len(firing), len(pending)))
        for a in firing + pending:
            lines.append("  [%-7s] %s: %s" % (a.state, a.rule,
                                              a.reason))
        hist = self.engine.history()
        if hist:
            lines.append("history (last %d):" % min(len(hist), 10))
            for d in hist[-10:]:
                lines.append("  [%-9s] %s: %s"
                             % (d["state"], d["rule"], d["reason"]))
        return "\n".join(lines)


def _ms(seconds):
    return round(1e3 * seconds, 3) if seconds is not None else None


def _fmt(v):
    return ("%.3g" % v) if v is not None else "-"


def _goodput_skew(ups, threshold=1.25):
    """The goodput ledger's straggler attribution generalized across
    processes:
    per-replica goodput windows (scraped off /statusz) -> wall-per-step
    skew, and for each straggler the category whose per-step seconds
    deviate most from the cross-replica median."""
    rows = []
    for rep in ups:
        gp = rep.snapshot.goodput
        if not isinstance(gp, dict) or not gp.get("steps"):
            continue
        cats = {cat: (c.get("per_step_s") or 0.0)
                for cat, c in (gp.get("categories") or {}).items()}
        rows.append({"rank": rep.rank,
                     "per_step_s": gp["wall_s"] / gp["steps"],
                     "categories": cats})
    if len(rows) < 2:
        return None
    walls = sorted(r["per_step_s"] for r in rows)
    median = walls[(len(walls) - 1) // 2]
    skew = (walls[-1] / median) if median else None
    stragglers = [r for r in rows
                  if median and r["per_step_s"] / median > threshold]
    attribution = []
    cat_names = set()
    for r in rows:
        cat_names.update(r["categories"])
    medians = {}
    for cat in cat_names:
        vals = sorted(r["categories"].get(cat, 0.0) for r in rows)
        medians[cat] = vals[(len(vals) - 1) // 2]
    for r in stragglers:
        best = None
        for cat, v in r["categories"].items():
            if cat == "other":
                continue
            ratio = v / max(medians[cat], 1e-9)
            if v > medians[cat] and (best is None
                                     or ratio > best["ratio"]):
                best = {"rank": r["rank"], "category": cat,
                        "per_step_s": round(v, 6),
                        "median_per_step_s": round(medians[cat], 6),
                        "ratio": round(min(ratio, 999.0), 2)}
        if best is not None:
            attribution.append(best)
    return {"max_over_median": round(skew, 4) if skew else None,
            "straggler_ranks": sorted(r["rank"] for r in stragglers),
            "attribution": attribution}


def alertz():
    """The ``/alertz`` payload: the newest registered monitor's engine
    state, or an empty shell when no monitor runs in this process."""
    from . import status as _status
    mon = _status.fleet_monitor()
    if mon is None:
        return {"schema": "mxalertz.v1", "monitors": 0, "firing": [],
                "pending": [], "history": [], "rules": []}
    payload = mon.engine.alertz()
    payload["monitors"] = 1
    payload["fleet"] = mon.fleet_row()
    return payload
