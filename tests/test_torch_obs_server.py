"""The port's introspection server against the JAX package's: for the
same status board (a trainer, a supervisor down and then exhausted, a
goodput window) and the same telemetry, ``/healthz``, ``/metrics``,
``/statusz`` and ``/alertz`` answer the same status codes and bodies,
pids and times normalised; and the endpoint file is published through
the atomic commit and withdrawn on stop, as the JAX package's."""
import json
import os
import urllib.error
import urllib.request

import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.analysis import memory as jmemory
from mxnet_tpu.analysis import numerics as jnumerics
from mxnet_tpu.obs import fleet as jfleet

from mxnet_tpu_torch import obs, telemetry
from mxnet_tpu_torch.analysis import memory as pmemory
from mxnet_tpu_torch.analysis import numerics as pnumerics
from mxnet_tpu_torch.obs import fleet

TIMEOUT_S = 10


class _Trainer:
    step = 24
    published_step = 16


class _Supervisor:
    generation = 2
    restarts = 2
    generation_down = True
    exhausted = False


class _Ledger:
    def __init__(self, window):
        self.window = window

    def last(self):
        return self.window


WINDOW = {"index": 3, "steps": 10, "wall_s": 1.25, "mfu": 0.31,
          "verdict": {"bound": "compute", "detail": "compute-bound"}}


def _get(port, path):
    url = "http://127.0.0.1:%d%s" % (port, path)
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _normalised(path, body):
    if path == "/metrics":
        return body
    doc = json.loads(body)
    if path == "/statusz":
        for key in ("pid", "time"):
            doc[key] = None
        doc["heartbeats"] = sorted(doc["heartbeats"])
    return doc


@pytest.fixture
def boards(monkeypatch):
    """Both packages' boards and registries, filled alike; both servers
    started on ephemeral ports and stopped after."""
    keep = [_Trainer(), _Supervisor(), _Ledger(WINDOW)]
    # the sentinels' rows start from the same state in both packages
    for numerics in (jnumerics, pnumerics):
        monkeypatch.setitem(numerics._STATE, "checks", 3)
        monkeypatch.setitem(numerics._STATE, "nonfinite", 1)
        monkeypatch.setitem(numerics._STATE, "last", None)
    for memory in (jmemory, pmemory):
        memory.reset_watch()
    for o, t in ((jobs, jtelemetry), (obs, telemetry)):
        o.status.reset()
        t.disable()
        t.registry().clear()
        t.enable()
        t.hooks.train_publish(16, 0.25)
        t.hooks.serving_latency(0.004)
        t.hooks.checkpoint("save", nbytes=1024, seconds=0.5, step=16)
        o.status.register_trainer(keep[0])
        o.status.register_supervisor(keep[1])
        o.status.register_ledger(keep[2])
        o.status.heartbeat()
    ports = (jobs.serve(0), obs.serve(0))
    try:
        yield ports, keep
    finally:
        jobs.server.stop()
        obs.server.stop()
        for o, t in ((jobs, jtelemetry), (obs, telemetry)):
            o.status.reset()
            t.disable()
            t.registry().clear()


def test_four_endpoints_answer_alike(boards):
    (jport, pport), keep = boards
    for path in ("/healthz", "/metrics", "/statusz", "/alertz", "/nope"):
        jcode, jbody = _get(jport, path)
        pcode, pbody = _get(pport, path)
        assert pcode == jcode, path
        if path == "/nope":
            assert json.loads(pbody)["paths"] == json.loads(jbody)["paths"]
            continue
        assert _normalised(path, pbody) == _normalised(path, jbody), path
    code, body = _get(pport, "/healthz")
    assert code == 503 and json.loads(body)["reasons"] == \
        ["generation_down:2"]
    status = json.loads(_get(pport, "/statusz")[1])
    assert status["goodput"] == WINDOW
    assert status["supervisors"] == [{"generation": 2, "restarts": 2,
                                      "down": True, "exhausted": False}]
    keep[1].exhausted = True
    for port in (jport, pport):
        code, body = _get(port, "/healthz")
        assert code == 503 and json.loads(body)["reasons"] == \
            ["restart_budget_exhausted:2"]
    keep[1].generation_down = keep[1].exhausted = False
    assert _get(pport, "/healthz") == _get(jport, "/healthz")
    assert _get(pport, "/healthz")[0] == 200


def test_endpoint_files_are_published_and_withdrawn(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_OBS_ENDPOINTS_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TPU_GENERATION", "3")
    dead = tmp_path / "r0.999999999.json"
    dead.write_text("{}")
    port = obs.serve(0)
    try:
        assert obs.serve(0) == port == obs.server.port()
        files = sorted(os.listdir(tmp_path))
        mine = "r0.%d.json" % os.getpid()
        assert files == [mine]          # the dead writer's file swept
        doc = json.loads((tmp_path / mine).read_text())
        assert sorted(doc) == ["generation", "pid", "port", "rank",
                               "started_at"]
        assert (doc["generation"], doc["port"]) == (3, port)
        eps = jfleet.discover(str(tmp_path))     # the JAX reader
        assert [(e.rank, e.generation, e.port) for e in eps] == \
            [(0, 3, port)]
    finally:
        obs.server.stop()
    assert os.listdir(tmp_path) == []
    assert not obs.server.running() and fleet.alertz() == jfleet.alertz()
