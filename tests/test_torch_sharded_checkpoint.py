"""The port's multi-process sharded checkpoints against the JAX
package's (``tests/test_resilience.py``'s sharded cases):

- one process: an injected fault at the shard write aborts the save
  cleanly and the manager recovers; a KILL at the merged-manifest
  commit strands a staging directory that the next manager sweeps;
  ``sweep_shared_staging`` follows each staging directory's owner pid;
  a disarmed fail point costs no visit; ``restore(sharding=)`` checks
its argument;
- two port ranks on CPU gloo write steps in the JAX package's layout
  (``<item>.shard<rank>.params`` + ``.json``, rank 0 storing the
  replicated arrays), which one JAX process restores with equal arrays;
- chaos KILLs of rank 1 at the shard write, between the ``written`` and
  ``committed`` barriers and at ``stage``: the survivor raises a
  ``BarrierTimeout`` naming rank 1 (presumed dead by its stale lease)
  at the barrier the JAX package names, no manifest is committed, the
  staging is swept and the newest step stays the previous one.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.checkpoint import CheckpointManager as JManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.checkpoint import CheckpointError, CheckpointManager
from mxnet_tpu_torch.checkpoint import sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    telemetry.enable()
    telemetry.registry().clear()
    yield
    chaos.disarm()
    chaos.reset()
    telemetry.disable()
    telemetry.registry().clear()


def _params(scale=1.0):
    with mx.cpu():
        return {"w": mx.nd.array(np.arange(8, dtype=np.float32) * scale)}


def test_sharded_abort_on_injected_shard_write_fault(tmp_path):
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(1, {"params": _params()})
    chaos.arm(0)
    chaos.on("checkpoint.sharded.shard_write", nth=1, action=chaos.RAISE)
    with pytest.raises(chaos.ChaosInjected):
        mgr.save(2, {"params": _params(2.0)})
    chaos.disarm()
    assert mgr.latest_step() == 1
    assert not any(d.endswith(".shared.tmp")
                   for d in os.listdir(str(tmp_path)))
    assert telemetry.counter("checkpoint.commit_aborted").value == 1
    st = chaos.stats()
    assert st["injected"]["checkpoint.sharded.shard_write"] == 1
    assert st["survived"]["checkpoint.sharded.shard_write"] == 1
    chaos.reset()
    mgr.save(3, {"params": _params(3.0)})
    assert mgr.latest_step() == 3


def test_sharded_commit_kill_leaves_staging_next_manager_sweeps(tmp_path):
    code = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos
from mxnet_tpu_torch.checkpoint import CheckpointManager

mgr = CheckpointManager(sys.argv[1], sharded=True)
with mx.cpu():
    p = {"w": mx.nd.array(np.arange(8, dtype=np.float32))}
mgr.save(1, {"params": p})
chaos.arm(0)
chaos.on("checkpoint.sharded.commit", nth=1, action=chaos.KILL)
mgr.save(2, {"params": p})
raise SystemExit("kill did not fire")
"""
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    assert out.returncode == 137, (out.stdout[-800:], out.stderr[-800:])
    leftovers = [d for d in os.listdir(str(tmp_path))
                 if d.endswith(".shared.tmp")]
    assert leftovers == ["step_00000002.shared.tmp"]
    mgr = CheckpointManager(str(tmp_path), sharded=True)   # init sweeps
    assert not any(d.endswith(".shared.tmp")
                   for d in os.listdir(str(tmp_path)))
    assert mgr.latest_step() == 1
    assert chaos.stats()["survived"][
        "checkpoint.sharded.shard_write"] >= 1


def test_sweep_shared_staging_owner_liveness(tmp_path):
    root = str(tmp_path)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    d1 = os.path.join(root, "step_00000001.shared.tmp")
    os.makedirs(d1)
    open(os.path.join(d1, ".owner.%d" % proc.pid), "w").close()
    d2 = os.path.join(root, "step_00000002.shared.tmp")
    os.makedirs(d2)
    open(os.path.join(d2, ".owner.%d" % os.getpid()), "w").close()
    crumb = os.path.join(d2, "params.shard00001.params.%d.tmp" % proc.pid)
    open(crumb, "w").close()
    d3 = os.path.join(root, "step_00000003.shared.tmp")
    os.makedirs(d3)
    removed = sharded.sweep_shared_staging(root)
    assert d1 in removed and d3 in removed and crumb in removed
    assert os.path.isdir(d2) and not os.path.exists(crumb)


def test_disarmed_fail_points_make_zero_visits(tmp_path, monkeypatch):
    from mxnet_tpu_torch.chaos import core as chaos_core
    calls = []
    real_visit = chaos_core._visit
    monkeypatch.setattr(chaos_core, "_visit",
                        lambda *a: calls.append(a) or real_visit(*a))
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(1, {"params": _params()})
    assert mgr.latest_step() == 1
    assert mgr.restore().items["params"]["w"].asnumpy().tolist() == \
        list(range(8))
    assert calls == []


def test_restore_onto_a_mesh_waits_for_item_9b(tmp_path):
    """Restoring onto a mesh is ported (tests/
    test_torch_mesh_checkpoint.py); a sharding= that is no
    NamedSharding, dict or callable raises, naming what it takes."""
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(1, {"params": _params()})
    with pytest.raises(CheckpointError, match="NamedSharding"):
        mgr.restore(sharding=object())
    with pytest.raises(mx.MXNetError, match="NamedSharding"):
        sharded.restore_sharded(mgr.step_dir(1), {"files": {}},
                                sharding=object())


# ---------------------------------------------------------------------
# two-rank worlds on CPU gloo
# ---------------------------------------------------------------------

_PRELUDE = r"""
import os, sys
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch import distributed as dist
from mxnet_tpu_torch.checkpoint import CheckpointManager

outdir = sys.argv[1]
assert mx.distributed_init() is True
nproc, rank = dist.world()
telemetry.enable()
chaos.arm_from_spec()
mgr = CheckpointManager(outdir + "/ckpts")
with mx.cpu():
    params = {"w": mx.nd.array(np.arange(8, dtype=np.float32)),
              "b": mx.nd.array(np.ones((2, 3), np.float32) * (rank + 1)),
              "h": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              "i": mx.nd.array(np.arange(4), dtype="int32")}
"""

_WRITE = _PRELUDE + r"""
mgr.save(1, {"params": params, "trainer": b"rank0 state"})
with mx.cpu():
    params["w"] = params["w"] * 2
mgr.save(2, {"params": params, "trainer": b"state 2"})
dist.barrier("published")
assert mgr.latest_step() == 2, mgr.all_steps()
print("WROTE", rank, sorted(os.listdir(mgr.step_dir(2))), flush=True)
"""

_SURVIVOR = r"""
try:
    mgr.save(2, {"params": params})
except dist.BarrierTimeout as e:
    assert 1 in e.ranks, e.ranks
    assert e.tag == EXPECT_TAG, e.tag
    assert 1 in e.presumed_dead, e.presumed_dead
    assert e.elapsed_s is not None and e.elapsed_s < 10.0
    assert mgr.latest_step() == LATEST, mgr.all_steps()
    assert not os.path.isdir(mgr.step_dir(2)), "manifest committed"
    assert not any(d.endswith(".shared.tmp")
                   for d in os.listdir(outdir + "/ckpts")), "staging left"
    assert telemetry.counter("checkpoint.commit_aborted").value == 1
    assert telemetry.counter("dist.rank_failures").value >= 1
    surv = chaos.stats()["survived"]
    assert surv.get(SURVIVED_POINT), surv
    print("SURVIVOR_OK rank=%d tag=%s ranks=%s dead=%s" % (
        rank, e.tag, list(e.ranks), list(e.presumed_dead)), flush=True)
    dist.failfast_exit(0)
raise SystemExit("kill did not fire (rank %d)" % rank)
"""


def _spawn_world(tmp_path, script, extra_env=None, timeout=120):
    path = tmp_path / "worker.py"
    path.write_text(script)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(2):
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   MXNET_TPU_COORDINATOR=coord, MXNET_TPU_NUM_PROCS="2",
                   MXNET_TPU_PROC_ID=str(rank),
                   MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="5000",
                   MXNET_TPU_DIST_LEASE_TTL_S="2", **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(path), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


def test_two_rank_step_restores_in_one_jax_process(tmp_path):
    results = _spawn_world(tmp_path, _WRITE)
    for rank, (rc, text) in enumerate(results):
        assert rc == 0 and "WROTE %d" % rank in text, text[-3000:]
    root = str(tmp_path / "ckpts")
    step_dir = os.path.join(root, "step_00000002")
    assert sorted(os.listdir(step_dir)) == [
        "manifest.json", "params.shard00000.json",
        "params.shard00000.params", "params.shard00001.json",
        "params.shard00001.params", "trainer.bin"]
    jck = JManager(root).restore()
    with mx.cpu():
        pck = CheckpointManager(root).restore()
    assert jck.step == pck.step == 2
    assert jck.items["trainer"] == pck.items["trainer"] == b"state 2"
    want = {"w": np.arange(8, dtype=np.float32) * 2,
            "b": np.ones((2, 3), np.float32),       # rank 0's replica
            "i": np.arange(4, dtype=np.int32)}
    for key, arr in want.items():
        j = np.asarray(jck.items["params"][key].asnumpy())
        p = pck.items["params"][key].asnumpy()
        assert j.dtype == p.dtype == arr.dtype, key
        assert j.tobytes() == p.tobytes() == arr.tobytes(), key
    jh = np.asarray(jck.items["params"]["h"].asnumpy()).astype(np.float32)
    ph = pck.items["params"]["h"]._data.float().numpy()
    assert str(pck.items["params"]["h"].dtype) in ("bfloat16",
                                                   "torch.bfloat16")
    np.testing.assert_array_equal(jh, ph)
    np.testing.assert_array_equal(ph, np.arange(6).reshape(2, 3))
    assert JManager(root).restore(step=1).items["params"]["w"] \
        .asnumpy().tolist() == list(range(8))


KILLS = [
    ("shard_write", {"point": "checkpoint.sharded.shard_write", "nth": 2},
     "ckpt_written", "checkpoint.sharded.barrier.written", 1),
    ("between_barriers",
     {"point": "checkpoint.sharded.barrier.committed", "nth": 2},
     "ckpt_committed", "checkpoint.sharded.barrier.committed", 1),
    ("stage", {"point": "checkpoint.sharded.barrier.stage", "nth": 1},
     "ckpt_stage", "checkpoint.sharded.barrier.stage", None),
]


@pytest.mark.parametrize("name,rule,tag,point,latest", KILLS,
                         ids=[k[0] for k in KILLS])
def test_chaos_kill_of_rank_1_leaves_a_typed_error_and_no_step(
        tmp_path, name, rule, tag, point, latest):
    first = "" if latest is None else (
        'mgr.save(1, {"params": params})\n'
        'dist.barrier("step1_done")\n'
        "assert mgr.latest_step() == 1\n")
    script = (_PRELUDE + first + "EXPECT_TAG = %r\nSURVIVED_POINT = %r\n"
              "LATEST = %r\n" % (tag, point, latest) + _SURVIVOR)
    if latest is None:
        script = script.replace("mgr.save(2, ", "mgr.save(1, ").replace(
            'mgr.step_dir(2)', 'mgr.step_dir(1)')
    spec = chaos.make_spec(seed=0, rules=[dict(rule, action="kill",
                                               rank=1)])
    results = _spawn_world(tmp_path, script,
                           {"MXNET_TPU_CHAOS_SPEC": spec})
    assert results[1][0] == 137, results[1][1][-2000:]
    assert results[0][0] == 0, results[0][1][-3000:]
    assert "SURVIVOR_OK rank=0 tag=%s ranks=[1] dead=[1]" % tag \
        in results[0][1]
