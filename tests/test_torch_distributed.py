"""The port's ``distributed`` against the JAX package's.

The fake-world cases of ``tests/test_resilience.py`` run in both
packages: a 2-rank world in which we are rank 0 and the coordination
store is an in-process dict with the real deadline and delete
semantics (the JAX coordination client's for the JAX package, a
``torch.distributed`` store's for the port).  They hold the typed
errors and their fields, ``_kv_attempt``'s retry and deadline split,
barrier attribution, ``post_abort``, the generation sweep and the
leases to the same behaviour.

Real worlds of two port ranks on CPU gloo (``python`` subprocesses, each
with its own timeout): ``host_allreduce``/``host_broadcast``, plain and
bucketed, give numpy's rank-order sum bit for bit on both ranks; a peer
dead before a collective raises ``RankFailure`` naming it; a dead rank 0
(the store's host) raises ``RankFailure`` naming rank 0.
"""
import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import distributed as jdist
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JMXNetError

from mxnet_tpu_torch import MXNetError, chaos, telemetry
from mxnet_tpu_torch import cpu as tmx_cpu
from mxnet_tpu_torch import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _JaxKV:
    """The JAX coordination client's semantics (tests/test_resilience.py
    :: fake_world)."""

    def __init__(self):
        self.store = {}
        self.deleted = []

    def key_value_set_bytes(self, key, val):
        self.store[key] = bytes(val)

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        if key in self.store:
            return self.store[key]
        raise RuntimeError(
            "DEADLINE_EXCEEDED: GetKeyValue() timed out with key: "
            "%s and duration: %dms" % (key, timeout_ms))

    def key_value_delete(self, key):
        self.deleted.append(key)
        if key.endswith("/"):
            for k in [k for k in self.store if k.startswith(key)]:
                del self.store[k]
        else:
            self.store.pop(key, None)


class _TorchStore:
    """A ``torch.distributed`` store's semantics."""

    def __init__(self):
        self.store = {}
        self.deleted = []

    def set(self, key, value):
        self.store[key] = bytes(value)

    def get(self, key):
        return self.store[key]

    def wait(self, keys, timeout):
        missing = [k for k in keys if k not in self.store]
        if missing:
            raise torch.distributed.DistStoreError(
                "wait timeout after %dms, keys: %s"
                % (timeout / datetime.timedelta(milliseconds=1),
                   ", ".join("/" + k for k in missing)))

    def check(self, keys):
        return all(k in self.store for k in keys)

    def delete_key(self, key):
        self.deleted.append(key)
        return self.store.pop(key, None) is not None


PACKAGES = {
    "jax": (jdist, jchaos, jtelemetry, JMXNetError, _JaxKV, "_client",
            lambda: RuntimeError("DEADLINE_EXCEEDED: GetKeyValue() "
                                 "timed out")),
    "port": (dist, chaos, telemetry, MXNetError, _TorchStore, "_client",
             lambda: torch.distributed.DistStoreError(
                 "wait timeout after 10ms, keys: /k")),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    name = request.param
    d, ch, tel, err, _store, _c, deadline = PACKAGES[name]
    ch.reset()
    yield {"name": name, "dist": d, "chaos": ch, "telemetry": tel,
           "MXNetError": err, "deadline": deadline}
    ch.disarm()
    ch.reset()
    tel.disable()
    tel.registry().clear()


@pytest.fixture
def world(pkg, monkeypatch):
    """A fake 2-rank world in which we are rank 0."""
    d = pkg["dist"]
    store = PACKAGES[pkg["name"]][4]()
    monkeypatch.setattr(d, "world", lambda: (2, 0))
    monkeypatch.setattr(d, "_client", lambda: store)
    monkeypatch.setattr(d, "_seq", [0])
    monkeypatch.setattr(d, "_my_old_keys", [])
    if hasattr(d, "_PREV_GEN_SWEPT"):   # the JAX package's sweep
        monkeypatch.setattr(d, "_PREV_GEN_SWEPT", [False])
    return store


def test_typed_error_hierarchy_and_fields(pkg):
    d = pkg["dist"]
    e = d.BarrierTimeout("boom", tag="ckpt_written", seq=4, ranks=[1, 3],
                         elapsed_s=6.0, presumed_dead=[3])
    assert isinstance(e, d.RankFailure)
    assert isinstance(e, pkg["MXNetError"])
    assert (e.tag, e.seq, e.ranks, e.presumed_dead, e.elapsed_s) == \
        ("ckpt_written", 4, (1, 3), (3,), 6.0)
    assert d.RankFailure("x").ranks == ()


def test_kv_attempt_retries_transient_then_succeeds(pkg):
    d = pkg["dist"]
    pkg["telemetry"].enable()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: socket closed")
        return 7

    assert d._kv_attempt(flaky, "get:k", "test", 1) == 7
    assert len(calls) == 3
    assert pkg["chaos"].stats()["survived"]["dist.collective"] == 2


def test_kv_attempt_deadline_is_not_retried(pkg):
    d = pkg["dist"]
    calls = []

    def dead():
        calls.append(1)
        raise pkg["deadline"]()

    with pytest.raises(d._KVTimeout):
        d._kv_attempt(dead, "get:k", "test", 1)
    assert len(calls) == 1


def test_kv_attempt_exhausted_raises_rank_failure(pkg):
    d = pkg["dist"]

    def always():
        raise RuntimeError("UNAVAILABLE: nope")

    with pytest.raises(d.RankFailure) as e:
        d._kv_attempt(always, "set:k", "broadcast", 9)
    assert (e.value.tag, e.value.seq) == ("broadcast", 9)
    assert "3 attempt(s)" in str(e.value)


def test_injected_fault_at_collective_is_absorbed_by_retry(pkg):
    d, ch = pkg["dist"], pkg["chaos"]
    pkg["telemetry"].enable()
    ch.arm(0)
    ch.on("dist.collective", nth=1, action=ch.RAISE)
    assert d._kv_attempt(lambda: 42, "get:k", "allreduce", 1) == 42
    st = ch.stats()
    assert st["injected"]["dist.collective"] == 1
    assert st["survived"]["dist.collective"] == 1
    assert pkg["telemetry"].counter("chaos.injected").value == 1


def test_barrier_completes_when_peer_acks(pkg, world, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "2000")
    world.store["mxbar/g0/t/1/1"] = b"ok"
    pkg["dist"].barrier("t")
    assert "mxbar/g0/t/1/0" in world.store


def test_barrier_timeout_names_missing_rank(pkg, world, monkeypatch):
    d = pkg["dist"]
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "300")
    pkg["telemetry"].enable()
    with pytest.raises(d.BarrierTimeout) as e:
        d.barrier("ckpt_written")
    err = e.value
    assert (err.ranks, err.tag, err.seq) == ((1,), "ckpt_written", 1)
    assert err.elapsed_s is not None
    assert err.presumed_dead == (1,)
    assert "rank(s) [1]" in str(err)
    assert pkg["telemetry"].counter("dist.rank_failures").value == 1


def test_barrier_abort_ack_fails_fast_with_rank_failure(pkg, world,
                                                        monkeypatch):
    d = pkg["dist"]
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "5000")
    world.store["mxbar/g0/ckpt_written/1/1"] = b"abort:IOError"
    t0 = time.monotonic()
    with pytest.raises(d.RankFailure) as e:
        d.barrier("ckpt_written")
    assert not isinstance(e.value, d.BarrierTimeout)
    assert e.value.ranks == (1,)
    assert time.monotonic() - t0 < 2.0


def test_post_abort_consumes_lockstep_seq(pkg, world):
    d = pkg["dist"]
    d.post_abort("ckpt_written", reason="ChaosInjected")
    assert d._seq[0] == 1
    assert world.store["mxbar/g0/ckpt_written/1/0"].startswith(b"abort")


def test_generation_sweep_deletes_previous_gen_keys(pkg, world,
                                                    monkeypatch):
    """No key of a previous generation reaches a new one's barrier.
    The JAX package's rank 0 deletes them once, since its coordination
    service outlives a generation.  A port generation owns a fresh
    store (its rank 0 hosts a new one on the generation's new port),
    so the port deletes nothing; in both, the generation in every key
    keeps a stale ack, even an abort at the same tag and seq, out."""
    d = pkg["dist"]
    monkeypatch.setenv("MXNET_TPU_GENERATION", "2")
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "300")
    world.store["mxbar/g1/old/3/1"] = b"ok"
    world.store["mxbar/g1/t/1/1"] = b"abort:stale"
    world.store["mxlive/g1/1"] = b"123.0"
    world.store["mxbar/g2/t/1/1"] = b"ok"
    d.barrier("t")
    if pkg["name"] == "jax":
        for prefix in ("mxbar/g1/", "mxlive/g1/", "mxkv_ar/g1/"):
            assert prefix in world.deleted
        assert not any(k.startswith("mxbar/g1/") for k in world.store)
    else:
        assert not [k for k in world.deleted if "/g1/" in k]
    ndel = len(world.deleted)
    world.store["mxbar/g2/t/2/1"] = b"ok"
    d.barrier("t")
    assert "mxbar/g1/" not in world.deleted[ndel:]


def test_lease_beat_age_and_stale(pkg, world):
    d = pkg["dist"]
    assert d.beat_lease() is True
    assert "mxlive/g0/0" in world.store
    age = d.lease_age(0)
    assert age is not None and age < 5.0
    assert d.lease_age(1) is None
    world.store["mxlive/g0/0"] = repr(time.time() - 60).encode()
    assert d.stale_ranks(ttl_s=10.0) == [0, 1]
    assert d.stale_ranks(ttl_s=10.0, ranks=[1]) == [1]


def test_single_process_world_is_inert(pkg):
    d = pkg["dist"]
    assert d.world() == (1, 0)
    assert d.lease_beater() is None and d.beat_lease() is False
    d.barrier("nothing to wait for")
    d.post_abort("nothing")
    assert d.distributed_init() is False


def test_the_spmd_half_still_raises_naming_item_9b():
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep
    with tmx_cpu():
        net = gluon.nn.Dense(2, in_units=2)
        net.initialize(device="cpu")
        tr = gluon.Trainer(net.collect_params(), "sgd")
        with pytest.raises(MXNetError, match="item 9b"):
            TrainStep(net, gluon.loss.L2Loss(), tr, mesh=object())


def test_barrier_acks_stay_bounded_on_a_tcp_store(monkeypatch):
    """Each barrier deletes this rank's own ack from the round before
    on a real ``TCPStore``, so a long run leaves one ack a rank."""
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "2000")
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, 1, is_master=True,
        timeout=datetime.timedelta(seconds=10), wait_for_workers=False)
    monkeypatch.setattr(dist, "world", lambda: (2, 0))
    monkeypatch.setattr(dist, "_client", lambda: store)
    monkeypatch.setattr(dist, "_seq", [0])
    monkeypatch.setattr(dist, "_my_old_keys", [])
    for seq in range(1, 6):
        store.set("mxbar/g0/t/%d/1" % seq, b"ok")     # the peer's ack
        dist.barrier("t")
    mine = ["mxbar/g0/t/%d/0" % seq for seq in range(1, 6)]
    assert [store.check([k]) for k in mine] == [False] * 4 + [True]


@pytest.mark.parametrize("fn", ["host_allreduce", "host_broadcast",
                                "host_allreduce_bucketed",
                                "host_broadcast_bucketed"])
def test_collective_timeout_ms_is_the_group_bound(fn, monkeypatch):
    """A collective waits as long as the process group's bound; a
    ``timeout_ms`` it could not keep raises instead of being ignored."""
    monkeypatch.setenv("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", "7000")
    x = torch.arange(4.0)
    arg = [x] if fn.endswith("_bucketed") else x
    with pytest.raises(MXNetError,
                       match="MXNET_TPU_DIST_BARRIER_TIMEOUT_MS"):
        getattr(dist, fn)(arg, timeout_ms=5000)
    out = getattr(dist, fn)(arg, timeout_ms=7000)
    got = out[0] if fn.endswith("_bucketed") else out
    assert torch.equal(got, x)


# ---------------------------------------------------------------------
# real two-rank worlds on CPU gloo
# ---------------------------------------------------------------------

_WORKER = r"""
import os, sys, time
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import distributed as dist

mode, out = sys.argv[1], sys.argv[2]
assert mx.distributed_init() is True
nproc, rank = dist.world()


def value(r, shape, dtype, seed):
    rng = np.random.default_rng(seed + r)
    return np.asarray((rng.standard_normal(shape) * 100).astype(dtype))


if mode == "collectives":
    res = {}
    for i, (shape, dtype) in enumerate([((1000,), np.float32),
                                        ((3, 7), np.float64),
                                        ((), np.float32),
                                        ((5, 4), np.int64)]):
        mine = value(rank, shape, dtype, 10 * i)
        got = dist.host_allreduce(torch.from_numpy(mine))
        res["sum%d" % i] = got.numpy()
        res["bc%d" % i] = dist.host_broadcast(
            torch.from_numpy(mine)).numpy()
    with mx.cpu():
        nd = dist.host_allreduce(mx.nd.array(value(rank, (6,), np.float32,
                                                   99)))
    res["nd"] = nd.numpy()
    arrays = [torch.from_numpy(value(rank, s, d, 50 + j)) for j, (s, d)
              in enumerate([((4, 5), np.float32), ((9,), np.float64),
                            ((2, 3), np.float32), ((7,), np.int64)])]
    for j, t in enumerate(dist.host_allreduce_bucketed(arrays)):
        res["bsum%d" % j] = t.numpy()
    for j, t in enumerate(dist.host_broadcast_bucketed(arrays)):
        res["bbc%d" % j] = t.numpy()
    res["avg"] = dist.host_allreduce(torch.from_numpy(
        value(rank, (8,), np.float32, 7)), average=True).numpy()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    dist.barrier("done")
    print("OK", rank, flush=True)
elif mode == "dead_peer":
    dist.barrier("ready")
    if rank == 1:
        os._exit(0)
    time.sleep(0.5)
    try:
        dist.host_allreduce(torch.ones(1000))
    except dist.RankFailure as e:
        print("RANKFAILURE", rank, list(e.ranks), e.tag, flush=True)
        dist.failfast_exit(0)
    print("NO ERROR", flush=True)
    dist.failfast_exit(1)
elif mode == "dead_store":
    dist.barrier("ready")
    if rank == 0:
        time.sleep(0.5)         # the peers have read every ack
        os._exit(0)
    time.sleep(1.0)
    try:
        dist.barrier("after")
    except dist.RankFailure as e:
        print("RANKFAILURE", rank, list(e.ranks), e.tag, flush=True)
        dist.failfast_exit(0)
    print("NO ERROR", flush=True)
    dist.failfast_exit(1)
"""


def _spawn_world(tmp_path, mode, n=2, timeout=120):
    path = tmp_path / "worker.py"
    path.write_text(_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(n):
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   MXNET_TPU_COORDINATOR=coord,
                   MXNET_TPU_NUM_PROCS=str(n), MXNET_TPU_PROC_ID=str(rank),
                   MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="20000")
        procs.append(subprocess.Popen(
            [sys.executable, "-u", str(path), mode, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
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


def _rank_order_sum(parts):
    total = parts[0].copy()
    for p in parts[1:]:
        total += p
    return total


def test_two_rank_collectives_give_numpy_rank_order_sum_bitwise(tmp_path):
    results = _spawn_world(tmp_path, "collectives")
    for rank, (rc, text) in enumerate(results):
        assert rc == 0 and "OK %d" % rank in text, text[-3000:]
    got = [np.load(str(tmp_path / ("rank%d.npz" % r))) for r in range(2)]

    def value(r, shape, dtype, seed):
        rng = np.random.default_rng(seed + r)
        return np.asarray((rng.standard_normal(shape) * 100).astype(dtype))

    for i, (shape, dtype) in enumerate([((1000,), np.float32),
                                        ((3, 7), np.float64),
                                        ((), np.float32),
                                        ((5, 4), np.int64)]):
        want = _rank_order_sum([value(r, shape, dtype, 10 * i)
                                for r in range(2)])
        for g in got:
            assert g["sum%d" % i].dtype == want.dtype
            assert g["sum%d" % i].tobytes() == want.tobytes(), i
            assert g["bc%d" % i].tobytes() == \
                value(0, shape, dtype, 10 * i).tobytes()
    for j, (s, d) in enumerate([((4, 5), np.float32), ((9,), np.float64),
                                ((2, 3), np.float32), ((7,), np.int64)]):
        want = _rank_order_sum([value(r, s, d, 50 + j) for r in range(2)])
        for g in got:
            assert g["bsum%d" % j].tobytes() == want.tobytes(), j
            assert g["bbc%d" % j].tobytes() == value(0, s, d,
                                                     50 + j).tobytes()
    want = _rank_order_sum([value(r, (6,), np.float32, 99)
                            for r in range(2)])
    avg = _rank_order_sum([value(r, (8,), np.float32, 7)
                           for r in range(2)]) / np.float32(2)
    for g in got:
        assert g["nd"].tobytes() == want.tobytes()
        assert g["avg"].tobytes() == avg.tobytes()


@pytest.mark.parametrize("mode,survivor,named", [("dead_peer", 0, 1),
                                                 ("dead_store", 1, 0)])
def test_a_dead_peer_raises_rank_failure_naming_it(tmp_path, mode,
                                                   survivor, named):
    results = _spawn_world(tmp_path, mode)
    rc, text = results[survivor]
    assert rc == 0, text[-3000:]
    line = [ln for ln in text.splitlines() if ln.startswith("RANKFAILURE")]
    assert line and line[0].split()[2] == "[%d]" % named, text[-3000:]
