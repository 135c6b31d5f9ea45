"""The port's restart supervisor against the JAX package's, on plain
Python worker scripts (no torch, no JAX): a worker that dies in
generation 0 is relaunched once with the generation bumped and the
budget charged; a worker that always dies exhausts the budget; both
supervisors return, count and report alike, and ``/healthz`` reads
NOT_READY while a generation is down or the budget is spent.  Every
supervised run has a hard timeout that tears its processes down."""
import sys
import threading

import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu import supervisor as jsupervisor
from mxnet_tpu import telemetry as jtelemetry

from mxnet_tpu_torch import obs, supervisor, telemetry

RUN_TIMEOUT_S = 60

# dies (exit 3) in generation 0, finishes in every later one
FLAKY = ("import os, sys\n"
         "gen = int(os.environ['MXNET_TPU_GENERATION'])\n"
         "print('worker rank', os.environ['MXNET_TPU_PROC_ID'], 'gen', gen)\n"
         "sys.exit(3 if gen == 0 else 0)\n")
DOOMED = "import sys\nsys.exit(5)\n"


def _run(module, script, **kw):
    """``Supervisor([python, -c, script], 1).run()`` under a hard
    timeout; returns (rc, supervisor)."""
    env = dict(kw.pop("env", {}))
    import os
    base = dict(os.environ, MXNET_TPU_GENERATION="0", **env)
    sup = module.Supervisor([sys.executable, "-c", script], 1,
                            grace_s=1.0, env=base, **kw)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("rc", sup.run()),
                         daemon=True)
    t.start()
    t.join(RUN_TIMEOUT_S)
    if t.is_alive():
        sup._kill_tree([p for p in sup._procs if p.poll() is None])
        t.join(10)
        pytest.fail("supervisor run hung past %ds" % RUN_TIMEOUT_S)
    return out["rc"], sup


@pytest.fixture(autouse=True)
def _clean():
    for o, t in ((jobs, jtelemetry), (obs, telemetry)):
        o.status.reset()
        t.registry().clear()
        t.enable()
    yield
    for o, t in ((jobs, jtelemetry), (obs, telemetry)):
        o.status.reset()
        t.disable()
        t.registry().clear()


def _state(sup):
    return (sup.generation, sup.restarts, sup.exhausted,
            sup.generation_down)


def test_a_dead_generation_is_relaunched_once(capfd):
    jrc, jsup = _run(jsupervisor, FLAKY, max_restarts=2)
    prc, psup = _run(supervisor, FLAKY, max_restarts=2)
    assert prc == jrc == 0
    assert _state(psup) == _state(jsup) == (1, 1, False, False)
    out = capfd.readouterr().out
    assert "[g0.0] worker rank 0 gen 0" in out
    assert "[g1.0] worker rank 0 gen 1" in out
    assert "relaunching generation 1 (restart 1/2)" in out
    snap = {r["name"]: r for r in telemetry.snapshot()}
    assert snap["supervisor.restarts"]["value"] == 1
    assert snap["supervisor.generation"]["value"] == 1
    assert obs.status.health() == (True, [])


def test_the_budget_runs_out(capfd):
    jrc, jsup = _run(jsupervisor, DOOMED, max_restarts=1)
    prc, psup = _run(supervisor, DOOMED, max_restarts=1)
    assert prc == jrc == 5
    assert _state(psup) == _state(jsup) == (1, 1, True, True)
    assert "restart budget (1) exhausted" in capfd.readouterr().out
    assert obs.status.health() == jobs.status.health() == \
        (False, ["restart_budget_exhausted:1"])
    snap = {r["name"]: r for r in telemetry.snapshot()}
    assert snap["supervisor.budget_exhausted"]["value"] == 1


def test_worker_env_and_not_ready_while_down(tmp_path):
    sup = supervisor.Supervisor([sys.executable, "-c", "pass"], 2,
                                max_restarts=0, endpoints_dir=str(tmp_path),
                                env={"MXNET_TPU_GENERATION": "4"})
    jsup = jsupervisor.Supervisor([sys.executable, "-c", "pass"], 2,
                                  max_restarts=0,
                                  endpoints_dir=str(tmp_path),
                                  env={"MXNET_TPU_GENERATION": "4"})
    assert sup._worker_env(4, 1, "127.0.0.1:9") == \
        jsup._worker_env(4, 1, "127.0.0.1:9")
    env = sup._worker_env(4, 1, "127.0.0.1:9")
    assert (env["MXNET_TPU_PROC_ID"], env["MXNET_TPU_GENERATION"],
            env["MXNET_TPU_NUM_PROCS"], env["MXNET_TPU_OBS_ENDPOINTS_DIR"]) \
        == ("1", "4", "2", str(tmp_path))
    sup._down = True
    assert obs.status.health() == (False, ["generation_down:4"])
    sup._down = False
    assert obs.status.statusz()["supervisors"] == [
        {"generation": 4, "restarts": 0, "down": False,
         "exhausted": False}]
    with pytest.raises(Exception, match="num_workers"):
        supervisor.Supervisor(["x"], 0)
