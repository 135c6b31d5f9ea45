"""The port's fleet plane (``obs.fleet``, ``obs.alerts``, ``mxtelemetry
fleet``) against the JAX package's, mirroring ``tests/test_fleet.py``:
endpoint files published by either package and discovered and swept
by the other; ``_parse_prom``, ``MergedHistogram``, ``_delta_hist`` and
``_goodput_skew`` giving equal results on the same inputs; the
``AlertEngine`` giving the same transitions for the same value series
and ``parse_rules`` spec; each package's ``scrape()`` reading the other
package's obs server with no ``SchemaMismatch``; a ``FleetMonitor`` over
two worker processes, one killed and relaunched in a new generation,
with ``replica_down`` firing and resolving; ``/alertz`` and the statusz
fleet row with a monitor registered; and ``mxtelemetry fleet`` printing
the JAX CLI's text for one snapshot."""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.obs import alerts as jalerts
from mxnet_tpu.obs import fleet as jfleet
from mxnet_tpu.telemetry import cli as jcli
from test_fleet import _FakeReplica, _bucketize, _drain

from mxnet_tpu_torch import MXNetError, obs, telemetry
from mxnet_tpu_torch.obs import alerts, fleet
from mxnet_tpu_torch.telemetry import cli as pcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both packages' fleet state is process-global (published
    endpoints, live monitors, the obs server): start and end clean."""
    monkeypatch.delenv("MXNET_TPU_OBS_ENDPOINTS_DIR", raising=False)
    for tel, o, fl in ((telemetry, obs, fleet),
                       (jtelemetry, jobs, jfleet)):
        tel.disable()
        tel.registry().clear()
        o.status.reset()
        fl._published.clear()
        for m in list(fl._monitors):
            m.close()
    yield
    for tel, o, fl in ((telemetry, obs, fleet),
                       (jtelemetry, jobs, jfleet)):
        for m in list(fl._monitors):
            m.close()
        fl._published.clear()
        o.server.stop()
        o.status.reset()
        tel.disable()
        tel.registry().clear()


PKGS = [("port", fleet, "jax", jfleet), ("jax", jfleet, "port", fleet)]


# ---------------------------------------------------------------------
# endpoint files
# ---------------------------------------------------------------------

@pytest.mark.parametrize("writer,wmod,reader,rmod", PKGS)
def test_endpoints_published_by_one_package_discovered_by_the_other(
        tmp_path, writer, wmod, reader, rmod):
    d = str(tmp_path)
    p0 = wmod.publish_endpoint(4100, dirpath=d, rank=0, generation=0)
    p1 = wmod.publish_endpoint(4101, dirpath=d, rank=1, generation=0)
    # a dead writer's file: swept by the other package
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    stale = os.path.join(d, "r2.%d.json" % proc.pid)
    with open(stale, "w") as f:
        json.dump({"pid": proc.pid, "rank": 2, "generation": 0,
                   "port": 4102, "started_at": 0.0}, f)
    (tmp_path / "garbage.json").write_text("{nope")
    eps = rmod.discover(d)
    assert [(e.rank, e.port, e.generation) for e in eps] == \
        [(0, 4100, 0), (1, 4101, 0), (2, 4102, 0)]
    assert rmod.sweep_endpoints(d) == [stale]
    assert [e.as_dict() for e in rmod.discover(d)] == \
        [e.as_dict() for e in wmod.discover(d)]
    # a newer generation of a rank wins its slot
    rmod.publish_endpoint(4200, dirpath=d, rank=1, generation=1)
    assert [(e.rank, e.port) for e in wmod.discover(d)] == \
        [(0, 4100), (1, 4200)]
    wmod.remove_endpoint(p0)
    wmod.remove_endpoint(p1)
    assert not os.path.exists(p0) and not os.path.exists(p1)


# ---------------------------------------------------------------------
# the pure pieces: prom parsing, histogram merge, skew, rules
# ---------------------------------------------------------------------

def test_parse_prom_equals_the_jax_parser():
    telemetry.enable()
    telemetry.counter("serving.requests").inc(12)
    telemetry.counter("serving.shed").inc(2)
    telemetry.gauge("serving.queue_depth").set(3)
    for s in (0.0007, 0.004, 0.004, 0.3, 2.5):
        telemetry.timer("serving.latency").observe(s)
    text = telemetry.prom_dump()
    assert fleet._parse_prom(text) == jfleet._parse_prom(text)
    values, buckets = fleet._parse_prom(text)
    assert values[fleet._prom("serving.requests")] == 12
    assert sum(fleet._per_bucket(
        buckets[fleet._prom("serving.latency")]).values()) == 5


def test_merged_histogram_percentiles_equal_jax():
    a = [0.001 * (1 + 0.3 * ((i * 7) % 10) / 10.0) for i in range(1000)]
    b = [1.0 * (1 + 0.1 * ((i * 3) % 10) / 10.0) for i in range(20)]
    hists = []
    for mod in (fleet, jfleet):
        h = mod.MergedHistogram()
        h.add_buckets(_bucketize(a))
        h.add_buckets(_bucketize(b))
        other = mod.MergedHistogram()
        other.add_cumulative({0.001: 5, 0.002: 9, float("inf"): 10})
        h.merge(other)
        hists.append(h)
    ph, jh = hists
    assert ph.count == jh.count == 1030
    assert ph.snapshot() == jh.snapshot()
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ph.percentile(q) == jh.percentile(q), q
    cum = {0.001: 5, 0.002: 9, float("inf"): 10}
    later = {0.001: 7, 0.002: 12, float("inf"): 14}
    assert fleet._per_bucket(cum) == jfleet._per_bucket(cum)
    assert fleet._delta_hist(later, cum) == jfleet._delta_hist(later, cum)
    assert fleet.MergedHistogram().percentile(0.5) is None


class _Up:
    """What ``_goodput_skew`` reads of an up replica."""

    class _Snap:
        def __init__(self, goodput):
            self.goodput = goodput

    def __init__(self, rank, goodput):
        self.rank = rank
        self.snapshot = self._Snap(goodput)


def test_goodput_skew_equals_jax():
    def gp(steps, wall, compute, wait):
        return {"steps": steps, "wall_s": wall, "categories": {
            "device_compute": {"per_step_s": compute},
            "input_wait": {"per_step_s": wait},
            "other": {"per_step_s": 0.5}}}
    ups = [_Up(0, gp(10, 1.0, 0.08, 0.01)), _Up(1, gp(10, 3.0, 0.08, 0.21)),
           _Up(2, gp(10, 1.1, 0.09, 0.01)), _Up(3, None)]
    got, want = fleet._goodput_skew(ups), jfleet._goodput_skew(ups)
    assert got == want
    assert got["straggler_ranks"] == [1]
    assert got["attribution"][0]["category"] == "input_wait"
    assert fleet._goodput_skew(ups[:1]) is None


SPEC = ('[{"name": "p99_latency_ms", "threshold": 100, "fast_s": 30, '
        '"slow_s": 300, "resolve_s": 60, "holddown_s": 120}, '
        '{"name": "shed_ratio", "threshold": 0.1}]')


def test_parse_rules_equal_jax_and_fail_loudly(monkeypatch):
    for spec in ("", SPEC):
        assert [r.as_dict() for r in alerts.parse_rules(spec)] == \
            [r.as_dict() for r in jalerts.parse_rules(spec)]
    for bad in ("{not json", '{"name": "x"}', '[{"threshold": 1}]',
                '[{"name": "p99_latency_ms", "bogus": 1}]',
                '[{"name": "brand_new"}]'):
        with pytest.raises(MXNetError):
            alerts.parse_rules(bad)
    monkeypatch.setenv("MXNET_TPU_OBS_ALERT_RULES", SPEC)
    assert {r.name: r.threshold for r in alerts.parse_rules()} == \
        {r.name: r.threshold for r in jalerts.parse_rules()}
    with pytest.raises(MXNetError):
        alerts.Rule("x", threshold=1.0, metric="not_a_metric")


def test_alert_engine_gives_the_jax_sequence():
    """One value series through both engines, rules from the same
    spec: every round's transitions and the final history equal."""
    series = []
    t = 1000.0
    for i in range(40):            # slow breach: pending, then firing
        series.append((t + 10 * i, {"p99_latency_ms": 250.0,
                                    "shed_ratio": 0.0,
                                    "replica_down": 0.0}))
    t += 400
    for i in range(3):             # a replica dies, then returns
        series.append((t + i, {"p99_latency_ms": 250.0,
                               "replica_down": 1.0 if i < 2 else 0.0,
                               "shed_ratio": None}))
    t += 10
    for i in range(20):            # sustained recovery, then a blip
        series.append((t + 10 * i, {"p99_latency_ms": 20.0,
                                    "shed_ratio": 0.5 if i == 15
                                    else 0.0, "replica_down": 0.0}))
    engines = [mod.AlertEngine(rules=mod.parse_rules(SPEC))
               for mod in (alerts, jalerts)]
    seen = [[], []]
    for now, values in series:
        for k, eng in enumerate(engines):
            changed = eng.observe(values, detail={
                "replica_down": "rank 1 generation 0 (pid 7) gone"},
                now=now)
            seen[k].append([a.as_dict() for a in changed])
    assert seen[0] == seen[1]
    fired = {(a["rule"], a["state"]) for rnd in seen[0] for a in rnd}
    assert {("p99_latency_ms", "firing"), ("p99_latency_ms", "resolved"),
            ("replica_down", "firing"),
            ("replica_down", "resolved")} <= fired
    assert engines[0].history() == engines[1].history()
    assert engines[0].alertz() == engines[1].alertz()


# ---------------------------------------------------------------------
# scrape across packages
# ---------------------------------------------------------------------

@pytest.mark.parametrize("server", ["port", "jax"])
def test_scrape_reads_the_other_packages_obs_server(server, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PROC_ID", "3")
    monkeypatch.setenv("MXNET_TPU_GENERATION", "2")
    served, tel, client = (obs, telemetry, jfleet) if server == "port" \
        else (jobs, jtelemetry, fleet)
    tel.enable()
    tel.counter("serving.requests").inc(5)
    tel.timer("serving.latency").observe(0.004)
    port = served.serve(0)
    snap = client.scrape("http://127.0.0.1:%d" % port, timeout_s=5.0)
    assert snap.ready is True
    assert (snap.rank, snap.generation, snap.pid) == (3, 2, os.getpid())
    assert snap.counters["requests"] == 5
    assert sum(client._per_bucket(snap.latency).values()) == 1
    assert snap.statusz["schema"] == client.STATUSZ_SCHEMA


def test_scrape_refuses_an_unknown_schema():
    rep = _FakeReplica(rank=0)
    rep.mode = "wrong_schema"
    try:
        with pytest.raises(fleet.SchemaMismatch):
            fleet.scrape(rep.url, timeout_s=2.0)
        rep.mode = "garbage"
        with pytest.raises(fleet.ScrapeError):
            fleet.scrape(rep.url, timeout_s=2.0)
    finally:
        rep.close()


def _agg(snap):
    agg = dict(snap["aggregate"])
    agg.pop("qps")
    return agg, [{k: v for k, v in r.items() if k not in ("key", "url")}
                 for r in snap["replicas"]]


def test_monitor_aggregates_like_the_jax_monitor():
    r0 = _FakeReplica(rank=0, generation=0)
    r1 = _FakeReplica(rank=1, generation=0)
    mons = [mod.FleetMonitor([r0.url, r1.url], scrape_ms=50, retries=0)
            for mod in (fleet, jfleet)]
    try:
        r0.served_step, r1.served_step = 10, 4
        for m in mons:
            m.poll_once()
        _drain(r0, n_req=80, shed=20, latency=[0.001] * 50)
        _drain(r1, n_req=100, errors=10, latency=[1.0] * 10)
        time.sleep(0.02)
        snaps = [m.poll_once() for m in mons]
        assert _agg(snaps[0]) == _agg(snaps[1])
        agg = snaps[0]["aggregate"]
        assert agg["shed_ratio"] == pytest.approx(0.1)
        assert agg["latency_ms"]["p99"] >= 1000.0
        assert mons[0].fleet_row() == mons[1].fleet_row()
    finally:
        for m in mons:
            m.close()
        r0.close()
        r1.close()


# ---------------------------------------------------------------------
# a monitor over worker processes: a kill and a relaunch
# ---------------------------------------------------------------------

_WORKER = r"""
import sys, time
from mxnet_tpu_torch import obs
obs.serve(0)
print("UP", flush=True)
time.sleep(120)
"""


def _spawn(d, rank, gen):
    env = dict(os.environ, MXNET_TPU_OBS_ENDPOINTS_DIR=d,
               MXNET_TPU_PROC_ID=str(rank), MXNET_TPU_GENERATION=str(gen),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    p = subprocess.Popen([sys.executable, "-u", "-c", _WORKER], env=env,
                         stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "UP"
    return p


def _poll_until(mon, pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = mon.poll_once()
        if pred(snap):
            return snap
        time.sleep(0.05)
    raise AssertionError("fleet never reached the state: %s"
                         % json.dumps(mon.last)[:2000])


def _states(snap):
    return {r["rank"]: (r["state"], r["generation"], r["pid"])
            for r in snap["replicas"]}


def test_monitor_over_two_workers_kill_and_relaunch(tmp_path):
    d = str(tmp_path)
    procs = [_spawn(d, r, 0) for r in range(2)]
    telemetry.enable()
    mon = fleet.FleetMonitor(d, scrape_ms=50, retries=0, timeout_s=2.0)
    try:
        snap = _poll_until(mon, lambda s: [st[0] for st in
                                           _states(s).values()]
                           == ["ok", "ok"])
        assert {st[1] for st in _states(snap).values()} == {0}
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(30)
        snap = _poll_until(mon, lambda s: _states(s)[1][0] == "down")
        firing = mon.engine.firing()
        assert [a.rule for a in firing] == ["replica_down"]
        assert "rank 1 generation 0" in firing[0].reason
        procs[1] = _spawn(d, 1, 1)
        snap = _poll_until(mon, lambda s: _states(s)[1][:2] == ("ok", 1))
        assert _states(snap)[1][2] == procs[1].pid
        assert mon.engine.firing() == []
        assert mon.engine.history()[-1]["state"] == "resolved"
        assert telemetry.counter("fleet.replica_downs").value == 1
        assert "2 replica(s), 2 up / 0 down" in mon.table()
    finally:
        mon.close()
        for p in procs:
            p.kill()
            p.wait(30)


def test_alertz_and_statusz_fleet_row_with_a_monitor(tmp_path):
    port = obs.serve(0)
    base = "http://127.0.0.1:%d" % port
    az = json.load(urllib.request.urlopen(base + "/alertz"))
    assert az == jfleet.alertz() and az["monitors"] == 0
    rep = _FakeReplica(rank=0)
    mon = fleet.FleetMonitor([rep.url], scrape_ms=50, retries=0)
    jmon = jfleet.FleetMonitor([rep.url], scrape_ms=50, retries=0)
    try:
        mon.poll_once()
        jmon.poll_once()
        az = json.load(urllib.request.urlopen(base + "/alertz"))
        assert az["monitors"] == 1 and az["fleet"] == {
            "replicas": 1, "up": 1, "down": 0, "alerts_firing": 0}
        want = jfleet.alertz()
        assert sorted(az) == sorted(want)
        assert az["rules"] == want["rules"]
        sz = json.load(urllib.request.urlopen(base + "/statusz"))
        assert sz["fleet"] == mon.fleet_row() == jmon.fleet_row()
    finally:
        mon.close()
        jmon.close()
        rep.close()


# ---------------------------------------------------------------------
# mxtelemetry fleet
# ---------------------------------------------------------------------

def test_cli_fleet_prints_the_jax_text_for_one_snapshot(capsys):
    r0 = _FakeReplica(rank=0, generation=1)
    r1 = _FakeReplica(rank=1, generation=1)
    r0.served_step = r1.served_step = 8
    r0.requests = 40
    r0.add_latency(0.004, n=40)
    try:
        for extra in ([], ["--json"]):
            argv = ["fleet", r0.url, r1.url, "--rounds", "1"] + extra
            prc = pcli.main(argv)
            pout = capsys.readouterr().out
            jrc = jcli.main(argv)
            jout = capsys.readouterr().out
            assert prc == jrc == 0
            if extra:
                pj, jj = json.loads(pout), json.loads(jout)
                for side in (pj, jj):
                    side["fleet"].pop("t")
                    for r in side["fleet"]["replicas"]:
                        r.pop("key")
                assert pj == jj
            else:
                assert pout == jout
                assert "2 replica(s), 2 up / 0 down" in pout
        assert pcli.main(["fleet", str(r0.url), "/no/such/dir"]) == 2
    finally:
        r0.close()
        r1.close()
