"""Multi-process worlds on ``torch.distributed`` (counterpart of
``mxnet_tpu/distributed.py``).

One call wires a worker into a world from the launcher's environment
(``MXNET_TPU_COORDINATOR`` host:port, ``MXNET_TPU_NUM_PROCS``,
``MXNET_TPU_PROC_ID``; ``python -m mxnet_tpu_torch.launch`` and the
:class:`~mxnet_tpu_torch.supervisor.Supervisor` set them):
:func:`distributed_init` starts a ``TCPStore`` (rank 0 hosts it, as
process 0 hosts JAX's coordination service) and a process group over
it, both bounded by ``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS``.  The group's
backend is ``"cpu:gloo,cuda:nccl"`` where NCCL is built (``"gloo"``
otherwise): a mesh's in-graph collectives
(:mod:`mxnet_tpu_torch.parallel.collectives`) run on CUDA tensors
through NCCL, whose communicator is made lazily, at the first CUDA
collective.

The host transport is gloo.  Collectives (:func:`host_allreduce`,
:func:`host_broadcast` and their ``_bucketed`` forms) are gloo
all-gathers and broadcasts of host copies: every rank gathers every
rank's bytes and sums them in rank order, so every rank gets the same
bits, and the result lands on the input's device.  Barriers, liveness
leases and aborts are keys of the store.  Two ranks may share one card
this way: nothing crosses the card but the copies to and from it.

Failure model (the JAX package's): every cross-process wait is
*attributed*.  A dead or wedged peer never surfaces as a raw store or
gloo error; it surfaces as :class:`BarrierTimeout` / :class:`RankFailure`
carrying the barrier tag, the lockstep sequence number, the missing
rank(s) (found with ``store.check`` and cross-checked against each
rank's liveness lease, beaten from the training loop) and the elapsed
wait.  A lost connection to the store means rank 0, its host, is gone:
it raises naming rank 0.  Transient store errors -- and only those --
retry with bounded backoff.  Keys are namespaced by the supervisor
*generation* (``MXNET_TPU_GENERATION``).  Each generation owns a fresh
store, hosted by its rank 0 on the generation's new coordinator port,
so no key of a dead generation is ever in it: the JAX package's sweep
of the previous generation's keys, which its coordination service
outlives a generation to need, has nothing to do here.  Nothing
carries on as one process: a world that cannot reach its peers
raises.
"""
from __future__ import annotations

import atexit
import datetime
import os
import time

from . import chaos as _chaos
from .base import MXNetError

__all__ = ["RankFailure", "BarrierTimeout", "distributed_init", "world",
           "generation", "beat_lease", "lease_beater", "lease_age",
           "stale_ranks", "host_allreduce", "host_broadcast",
           "host_allreduce_bucketed", "host_broadcast_bucketed",
           "barrier", "post_abort", "failfast_exit"]


class RankFailure(MXNetError):
    """A cross-process operation gave up on one or more peer ranks.

    Carries ``tag`` (the barrier/collective name), ``seq`` (the
    lockstep sequence number), ``ranks`` (the peers attributed --
    missing, aborted, or unreachable), and ``elapsed_s``.
    """

    def __init__(self, msg, tag=None, seq=None, ranks=(), elapsed_s=None):
        super().__init__(msg)
        self.tag = tag
        self.seq = seq
        self.ranks = tuple(ranks)
        self.elapsed_s = elapsed_s


class BarrierTimeout(RankFailure):
    """A barrier rendezvous timed out; ``ranks`` names every rank that
    never acked (``presumed_dead`` the subset whose liveness lease is
    stale or absent)."""

    def __init__(self, msg, tag=None, seq=None, ranks=(), elapsed_s=None,
                 presumed_dead=()):
        super().__init__(msg, tag=tag, seq=seq, ranks=ranks,
                         elapsed_s=elapsed_s)
        self.presumed_dead = tuple(presumed_dead)


class _KVTimeout(Exception):
    """Internal: a blocking store wait hit its deadline.  Callers
    convert it into the typed error that names what they waited for."""

    def __init__(self, elapsed_s):
        super().__init__("%.3fs" % elapsed_s)
        self.elapsed_s = elapsed_s


# ----------------------------------------------------------------------
# the store and the world
# ----------------------------------------------------------------------

class _World:
    __slots__ = ("store", "group", "nproc", "rank", "timeout")

    def __init__(self, store, group, nproc, rank, timeout):
        self.store = store
        self.group = group
        self.nproc = nproc
        self.rank = rank
        self.timeout = timeout


_world = None


def _timeout_ms():
    from . import env as _env
    return int(_env.get("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS"))


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join the multi-process world from arguments or the launcher's
    environment (MXNET_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID): rank 0
    hosts a ``TCPStore`` at the coordinator's address, every rank
    connects and joins a gloo+NCCL process group over it.  Both wait at most
    ``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS``.  No-op (returning False)
    when single-process or already initialized."""
    global _world
    if _world is not None:
        return False
    coordinator_address = coordinator_address or \
        os.environ.get("MXNET_TPU_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("MXNET_TPU_NUM_PROCS", "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("MXNET_TPU_PROC_ID", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    import torch.distributed as dist
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(milliseconds=_timeout_ms())
    try:
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout,
                              wait_for_workers=False)
        # CPU tensors (the host collectives) on gloo, CUDA tensors (a
        # mesh's collectives) on NCCL, whose communicator is made at the
        # first CUDA collective: ranks sharing one card never make one
        dist.init_process_group(_backend(), store=store, rank=process_id,
                                world_size=num_processes, timeout=timeout)
    except (RuntimeError, ValueError) as e:
        raise RankFailure(
            "rank %d could not join the %d-process world at %s: %s"
            % (process_id, num_processes, coordinator_address, e),
            tag="init", ranks=[0] if process_id else ()) from e
    _world = _World(store, dist.group.WORLD, num_processes,
                    process_id, timeout)
    atexit.register(_shutdown)
    return True


def _backend():
    import torch.distributed as dist
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def world():
    """(num_processes, process_id) of the connected world (1, 0 when
    single-process)."""
    if _world is None:
        return 1, 0
    return _world.nproc, _world.rank


def _client():
    return _world.store if _world is not None else None


def _shutdown():
    """Leave the world at interpreter exit: ranks > 0 post a departure
    key; rank 0, which hosts the store, waits for every departure (at
    most the barrier bound) so no peer loses the store mid-call, then
    the graphs that recorded collectives are freed and the process
    group is torn down."""
    global _world
    w = _world
    if w is None:
        return
    base = "mxbar/g%d/shutdown" % generation()
    try:
        if w.rank == 0:
            w.store.wait(["%s/%d" % (base, r) for r in range(1, w.nproc)],
                         w.timeout)
        else:
            w.store.set("%s/%d" % (base, w.rank), b"ok")
    except Exception:       # exiting: a dead peer must not hang or raise
        pass
    _world = None
    try:
        # a live CUDA graph that recorded NCCL collectives keeps the
        # process from exiting once its groups are torn down: free the
        # graphs first
        from . import _capture
        _capture.release_collective_graphs()
    except Exception:
        pass
    try:
        import torch.distributed as dist
        dist.destroy_process_group()
    except Exception:
        pass


# ----------------------------------------------------------------------
# store operations: retry, deadline, attribution
# ----------------------------------------------------------------------

_seq = [0]
_my_old_keys = []   # this rank's keys from past rounds, deleted lazily


def generation():
    """The supervisor generation this process belongs to
    (``MXNET_TPU_GENERATION``, bumped by the restart supervisor on
    every relaunch).  Namespaces every store key, so a restarted world
    never reads the dead world's state."""
    try:
        return int(os.environ.get("MXNET_TPU_GENERATION", "0") or 0)
    except ValueError:
        return 0


def _kv_set(client, key, data):
    client.set(key, data)


def _kv_get(client, key, timeout_ms):
    client.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    return client.get(key)


def _is_deadline(exc):
    import torch.distributed as dist
    return isinstance(exc, dist.DistStoreError) \
        and "timeout" in str(exc).lower()


def _is_store_lost(exc):
    import torch.distributed as dist
    return isinstance(exc, dist.DistNetworkError)


def _kv_attempt(fn, what, kind, seq):
    """One store op under the ``dist.collective`` fail point with
    bounded retry: transient errors (and chaos-injected RAISEs -- the
    fail point sits INSIDE the retry domain, so an injected fault is
    tolerated the way real weather is) retry up to
    ``MXNET_TPU_DIST_KV_RETRIES`` times with doubling backoff, each
    tolerated one counted ``chaos.survived('dist.collective')``.  A
    deadline is NOT transient -- a peer never produced the value -- and
    converts at once to :class:`_KVTimeout` for the caller to
    attribute; nor is a broken connection to the store, whose host,
    rank 0, is gone: that raises :class:`RankFailure` naming rank 0."""
    from . import env as _env
    retries = int(_env.get("MXNET_TPU_DIST_KV_RETRIES"))
    delay = 0.05
    t0 = time.monotonic()
    for attempt in range(retries + 1):
        try:
            # chaos: the store path -- a RAISE here models a flaky
            # store and must be absorbed by this bounded retry; a KILL
            # is a rank dying mid-exchange
            _chaos.fail_point("dist.collective", what=what, kind=kind,
                              seq=seq, attempt=attempt + 1)
            return fn()
        except _KVTimeout:
            raise
        except Exception as e:
            if _is_deadline(e):
                raise _KVTimeout(time.monotonic() - t0) from e
            if _is_store_lost(e):
                _telemetry_rank_failure("store", kind, [0],
                                        time.monotonic() - t0)
                raise RankFailure(
                    "store %s %r: the connection to the store's host, "
                    "rank 0, is lost: %s" % (what, kind, e), tag=kind,
                    seq=seq, ranks=[0],
                    elapsed_s=time.monotonic() - t0) from e
            if attempt >= retries:
                raise RankFailure(
                    "store %s %r failed after %d attempt(s): %s"
                    % (what, kind, attempt + 1, e), tag=kind, seq=seq,
                    elapsed_s=time.monotonic() - t0) from e
            _chaos.survived("dist.collective", "kv_retry")
            time.sleep(delay)
            delay *= 2


def _kv_set_checked(client, key, data, kind, seq):
    return _kv_attempt(lambda: _kv_set(client, key, data),
                       "set:" + key, kind, seq)


def _kv_get_checked(client, key, timeout_ms, kind, seq):
    return _kv_attempt(lambda: _kv_get(client, key, timeout_ms),
                       "get:" + key, kind, seq)


def _gc_old_keys(client):
    """Delete this rank's keys from two rounds back.  Barriers are
    lockstep on _seq: entering round N+1 implies every rank has POSTED
    round N, hence fully consumed round N-1 -- deleting N-1 entries is
    race-free, and the store stays bounded.  (No previous generation's
    keys to sweep: each generation's store is new.)"""
    while len(_my_old_keys) > 1:
        key = _my_old_keys.pop(0)
        try:
            client.delete_key(key)
        except Exception:
            pass


# ----------------------------------------------------------------------
# Liveness leases: a rank that is merely slow still beats its lease
# (every step and every barrier entry), a dead rank stops.  A missing
# rank whose lease is stale past MXNET_TPU_DIST_LEASE_TTL_S (or absent)
# is *presumed dead* in the typed error.
# ----------------------------------------------------------------------

def _lease_key(rank):
    return "mxlive/g%d/%d" % (generation(), rank)


def beat_lease():
    """Refresh this rank's liveness lease (no-op single-process);
    called from the training loop (``ContinuousTrainer``) and at every
    barrier entry.  The value is this host's wall clock, compared only
    for staleness."""
    nproc, rank = world()
    if nproc == 1:
        return False
    try:
        _kv_set(_client(), _lease_key(rank), repr(time.time()).encode())
    except Exception:
        return False            # a failed beat must never kill a step
    return True


def lease_beater():
    """A bound zero-arg beater when this process is part of a
    multi-process world, else ``None`` -- so hot loops pay one
    attribute check per step, never a ``world()`` probe."""
    return beat_lease if world()[0] > 1 else None


def lease_age(rank, timeout_ms=200):
    """Seconds since ``rank`` last beat its lease, or ``None`` when it
    never has (or the store did not answer)."""
    try:
        client = _client()
        key = _lease_key(rank)
        if not client.check([key]):
            return None
        raw = _kv_get(client, key, timeout_ms)
        return max(0.0, time.time() - float(raw.decode()))
    except Exception:
        return None


def stale_ranks(ttl_s=None, ranks=None):
    """Ranks whose lease is absent or older than ``ttl_s``
    (``MXNET_TPU_DIST_LEASE_TTL_S``) -- the presumed-dead set."""
    from . import env as _env
    if ttl_s is None:
        ttl_s = float(_env.get("MXNET_TPU_DIST_LEASE_TTL_S"))
    nproc, _rank = world()
    out = []
    for r in range(nproc) if ranks is None else ranks:
        age = lease_age(r)
        if age is None or age > ttl_s:
            out.append(r)
    return out


def _telemetry_rank_failure(kind, tag, ranks, elapsed_s):
    from . import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.dist_rank_failure(kind, tag, ranks, elapsed_s)


def _telemetry_collective(kind, nbytes, ntensors):
    from . import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.dist_collective(kind, nbytes, ntensors)


# ----------------------------------------------------------------------
# host collectives: gloo over host copies
# ----------------------------------------------------------------------

def _tensor_of(arr):
    """The tensor behind an NDArray, a tensor, or a numpy array/scalar
    (a CPU tensor)."""
    import numpy as np
    import torch
    data = getattr(arr, "_data", arr)
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(np.asarray(data)))


def _result_device(arr):
    """The device a collective's result lands on: the input tensor's
    (an NDArray's tensor's); for a numpy input, the current context's
    device, as the JAX package places it on the default device."""
    import torch
    data = getattr(arr, "_data", arr)
    if isinstance(data, torch.Tensor):
        return data.device
    from .context import current_context
    return current_context().device


def _place(x, device):
    return x if x.device == device else x.to(device)


def _gloo_failure(kind, exc, elapsed_s):
    """The typed error for a gloo collective that failed.  A store that
    no longer answers names rank 0, its host; else the peers whose
    lease is stale, or, while every lease is still fresh, every peer
    the collective waited on."""
    nproc, me = world()
    peers = [r for r in range(nproc) if r != me]
    try:
        _client().check([_lease_key(me)])
        dead = stale_ranks(ranks=peers)
        how = "presumed dead (liveness lease stale/absent)" if dead \
            else "leases fresh; the collective's peers"
        ranks = dead or peers
    except Exception as e:      # noqa: BLE001 -- attribution only
        if not _is_store_lost(e):
            raise
        ranks, how = [0], "the store's host is gone"
    _telemetry_rank_failure("collective", kind, ranks, elapsed_s)
    return RankFailure("%s failed after %.1fs: %s; rank(s) %s: %s"
                       % (kind, elapsed_s, exc, ranks, how),
                       tag=kind, ranks=ranks, elapsed_s=elapsed_s)


def _host_bytes(t):
    """A contiguous CPU uint8 view of ``t``'s elements (a fresh copy,
    which the collective may write into)."""
    import torch
    return t.detach().to("cpu", copy=True).contiguous().reshape(-1) \
        .view(torch.uint8)


def _collective_bound(timeout_ms):
    """Refuse a per-call bound that a collective cannot keep.  A gloo
    collective waits as long as the process group's timeout, fixed by
    :func:`distributed_init` from ``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS``;
    the JAX package's ``timeout_ms`` bounds its KV fallback, a transport
    the port does not have.  ``None`` or that same bound pass."""
    if timeout_ms is None:
        return
    bound = (_world.timeout // datetime.timedelta(milliseconds=1)
             if _world is not None else _timeout_ms())
    if int(timeout_ms) != bound:
        raise MXNetError(
            "timeout_ms=%s: a host collective is bounded by the process "
            "group's timeout, %d ms; set MXNET_TPU_DIST_BARRIER_TIMEOUT_MS "
            "before distributed_init to change it" % (timeout_ms, bound))


def host_allreduce(arr, average=False, timeout_ms=None, _ntensors=1):
    """Sum (or mean) an array across every process: a gloo all-gather
    of every rank's host bytes, summed in rank order, so every rank
    gets the same bits.  The result is a tensor on the input's device
    (``_result_device``).  The wait is bounded by
    ``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS``; a ``timeout_ms`` other than
    that bound raises :class:`MXNetError`."""
    import torch
    import torch.distributed as dist
    _collective_bound(timeout_ms)
    dev = _result_device(arr)
    t = _tensor_of(arr)
    nproc, _rank = world()
    if nproc == 1:
        return _place(t, dev)
    _telemetry_collective("allreduce", t.numel() * t.element_size(),
                          _ntensors)
    # chaos: the gloo transport
    _chaos.fail_point("dist.collective", what="allgather",
                      kind="allreduce", seq=_seq[0])
    mine = _host_bytes(t)
    parts = [torch.empty_like(mine) for _ in range(nproc)]
    t0 = time.monotonic()
    try:
        dist.all_gather(parts, mine, group=_world.group)
    except RuntimeError as e:
        raise _gloo_failure("allreduce", e, time.monotonic() - t0) from e
    vals = [p.view(t.dtype).reshape(t.shape) for p in parts]
    total = vals[0].clone()
    for v in vals[1:]:
        total += v
    if average:
        total = total / nproc
    return _place(total, dev)


def host_broadcast(arr, root=0, timeout_ms=None, _ntensors=1):
    """Every process receives root's value (a tensor placed on the
    input's device, see ``_result_device``).  ``timeout_ms`` as for
    :func:`host_allreduce`."""
    import torch.distributed as dist
    _collective_bound(timeout_ms)
    dev = _result_device(arr)
    t = _tensor_of(arr)
    nproc, _rank = world()
    if nproc == 1:
        return _place(t, dev)
    _telemetry_collective("broadcast", t.numel() * t.element_size(),
                          _ntensors)
    # chaos: the gloo transport
    _chaos.fail_point("dist.collective", what="broadcast",
                      kind="broadcast", seq=_seq[0])
    buf = _host_bytes(t)
    t0 = time.monotonic()
    try:
        dist.broadcast(buf, src=root, group=_world.group)
    except RuntimeError as e:
        raise _gloo_failure("broadcast", e, time.monotonic() - t0) from e
    return _place(buf.view(t.dtype).reshape(t.shape), dev)


def failfast_exit(code=3):
    """Exit NOW, skipping the process group's teardown and the store
    host's departure wait.  A survivor holding a typed
    :class:`RankFailure` cannot shut down cleanly -- its dead peer
    never departs and gloo's teardown can block on it.  This flushes
    stdio and the telemetry sinks, then ``os._exit(code)`` -- the
    supervised-worker exit the restart supervisor relaunches on."""
    import sys
    try:
        from . import telemetry as _telemetry
        if _telemetry._ENABLED:
            _telemetry.flush()
    except Exception:
        pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(code)


def barrier(name="mxnet_tpu_barrier", timeout_ms=None):
    """Attributed rendezvous: every rank posts an ack key and waits for
    every other rank's, so a timeout NAMES the missing rank(s) in a
    typed :class:`BarrierTimeout`.  ``timeout_ms`` defaults to
    ``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS``.  A rank that posted an
    *abort* ack (:func:`post_abort`) raises :class:`RankFailure` on
    every waiter instead -- the fast path a failing-but-alive peer
    takes so survivors never wait out the bound."""
    nproc, rank = world()
    if nproc == 1:
        return
    _seq[0] += 1
    _wait_ranks(name, _seq[0], nproc, rank, timeout_ms)


def post_abort(name, reason=""):
    """Mark the NEXT rendezvous at ``name`` aborted, so peers waiting
    there fail fast with a typed :class:`RankFailure`.  Called by a
    rank that cannot complete a multi-rank protocol (a failed shard
    write inside a sharded save); consumes the lockstep seq the skipped
    barrier would have, so an aborting world stays seq-aligned."""
    nproc, rank = world()
    if nproc == 1:
        return
    _seq[0] += 1
    key = "mxbar/g%d/%s/%d/%d" % (generation(), name, _seq[0], rank)
    try:
        _kv_set(_client(), key,
                b"abort:" + reason.encode("utf-8", "replace"))
    except Exception:
        pass                    # peers then attribute via the timeout


def _wait_ranks(name, seq, nproc, rank, timeout_ms):
    """The rendezvous body: post ``mxbar/g<gen>/<name>/<seq>/<rank>``,
    then collect every peer's ack within the deadline.  Once the
    deadline is spent, the remaining peers' keys are probed with
    ``check`` (no wait), so the error names EVERY missing rank."""
    if timeout_ms is None:
        timeout_ms = _timeout_ms()
    client = _client()
    beat_lease()                # rendezvousing is proof of life
    base = "mxbar/g%d/%s/%d" % (generation(), name, seq)
    my_key = "%s/%d" % (base, rank)
    t0 = time.monotonic()
    _kv_set_checked(client, my_key, b"ok", name, seq)
    deadline = t0 + timeout_ms / 1000.0
    missing, aborted = [], []
    for r in range(nproc):
        if r == rank:
            continue
        key = "%s/%d" % (base, r)
        if missing and not _kv_attempt(lambda k=key: client.check([k]),
                                       "check:" + key, name, seq):
            missing.append(r)
            continue
        remaining_ms = max(1, int(1000 * (deadline - time.monotonic())))
        try:
            val = _kv_get_checked(client, key, remaining_ms, name, seq)
        except _KVTimeout:
            missing.append(r)
            continue
        if val.startswith(b"abort"):
            aborted.append(r)
    _my_old_keys.append(my_key)
    _gc_old_keys(client)
    elapsed = time.monotonic() - t0
    if missing:
        dead = stale_ranks(ranks=missing)
        _telemetry_rank_failure("barrier", name, missing, elapsed)
        raise BarrierTimeout(
            "barrier %r (seq %d) timed out after %.1fs waiting for "
            "rank(s) %s%s" % (
                name, seq, elapsed, missing,
                "; presumed dead (liveness lease stale/absent): %s"
                % dead if dead else "; leases fresh (slow peer?)"),
            tag=name, seq=seq, ranks=missing, elapsed_s=elapsed,
            presumed_dead=dead)
    if aborted:
        _telemetry_rank_failure("abort", name, aborted, elapsed)
        raise RankFailure(
            "rank(s) %s aborted at barrier %r (seq %d) after %.1fs"
            % (aborted, name, seq, elapsed),
            tag=name, seq=seq, ranks=aborted, elapsed_s=elapsed)


# ----------------------------------------------------------------------
# Bucketed host collectives: a whole list of tensors flattened into one
# contiguous buffer per dtype, one collective per buffer, the results
# split back onto each input's device.  ``dist.collectives`` vs
# ``dist.tensors_coalesced`` telemetry records the drop.
# ----------------------------------------------------------------------

def _bucketed(arrays, one_collective):
    """Group ``arrays`` by dtype, run ``one_collective(buffer,
    ntensors)`` once per group on the flat concatenation, and return
    the per-input results placed back on each input's device."""
    import torch
    arrays = list(arrays)
    tensors = [_tensor_of(a) for a in arrays]
    devices = [_result_device(a) for a in arrays]
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    out = [None] * len(arrays)
    for idxs in groups.values():
        dev = tensors[idxs[0]].device
        buf = torch.cat([tensors[i].detach().reshape(-1).to(dev)
                         for i in idxs])
        res = one_collective(buf, len(idxs))
        offset = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = _place(res[offset:offset + n]
                            .reshape(tensors[i].shape), devices[i])
            offset += n
    return out


def host_allreduce_bucketed(arrays, average=False, timeout_ms=None):
    """Sum (or mean) a LIST of arrays across every process with one
    flattened collective per dtype group instead of one per tensor.
    Results come back in input order, each on its input's device.
    ``timeout_ms`` as for :func:`host_allreduce`."""
    _collective_bound(timeout_ms)
    if world()[0] == 1:
        return [_place(_tensor_of(a), _result_device(a)) for a in arrays]
    return _bucketed(
        arrays,
        lambda buf, n: host_allreduce(buf, average=average, _ntensors=n))


def host_broadcast_bucketed(arrays, root=0, timeout_ms=None):
    """Every process receives root's values for a LIST of arrays, one
    flattened collective per dtype group (the initial parameter
    broadcast).  ``timeout_ms`` as for :func:`host_allreduce`."""
    _collective_bound(timeout_ms)
    if world()[0] == 1:
        return [_place(_tensor_of(a), _result_device(a)) for a in arrays]
    return _bucketed(
        arrays,
        lambda buf, n: host_broadcast(buf, root=root, _ntensors=n))
