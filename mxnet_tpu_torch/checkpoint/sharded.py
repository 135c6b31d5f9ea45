"""Multi-process sharded checkpoints with the rank-death-safe commit
(counterpart of ``mxnet_tpu/checkpoint/sharded.py``).

The layout is the JAX package's, so either package restores the
other's step:

- every process writes ``<item>.shard<rank>.params`` plus a
  ``<item>.shard<rank>.json`` index mapping each stored entry to its
  ``(key, global_shape, dtype, slices)``.  In the port every parameter
  is replicated (data parallelism: one full copy a rank), and only the
  ``replica_id == 0`` copy is stored, rank 0's: the other ranks write
  empty shard files, which record that they reached the ``written``
  gate.  So a saved step holds rank 0's BatchNorm running statistics,
  which differ per rank.  Each file lands through a pid-suffixed temp
  + rename, so a killed rank leaves ``*.tmp`` crumbs, never a
  plausible-looking partial shard;
- all processes rendezvous at three **attributed barriers**
  (:func:`~mxnet_tpu_torch.distributed.barrier`): ``stage`` after the
  staging dir exists, ``written`` after every rank's shards are
  durable, and ``committed`` -- the commit GATE: **process 0 stages the
  merged manifest, then the whole world confirms at "committed" BEFORE
  the atomic directory rename**.  A rank dead anywhere up to that gate
  means the rename never happens: a torn step is impossible, a rank
  death costs at most one step.  (The rename happens *after* the gate,
  so on ranks != 0 a returned save precedes global visibility by an
  instant -- a reader that needs the step visible rendezvouses first);
- a failed save aborts *cleanly* on every survivor: the staging dir is
  swept, ``checkpoint.commit_aborted`` counts it, a failing-but-alive
  rank posts an abort ack (``distributed.post_abort``) so peers fail
  fast, and the typed error propagates for the caller's policy
  (``serving.loop``);
- restore reads every shard file and reassembles each parameter into
  its full array on the host (the port's restored arrays come back on
  the host; ``restore_training`` copies each onto its parameter's
  device).  Restoring onto a mesh (``sharding=``) waits for the SPMD
  half of the multi-device slice (ROADMAP item 9b) and raises.

Chaos fail points cover every dangerous spot under the JAX names: each
barrier (``checkpoint.sharded.barrier.<tag>``), the per-rank shard
write (``checkpoint.sharded.shard_write``), and the merged-manifest
commit (``checkpoint.sharded.commit``).  A single process runs the
same machinery with no-op barriers.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np

from .. import chaos as _chaos
from .. import telemetry as _telemetry
from ..base import MXNetError
from . import core as _core

__all__ = ["save_sharded", "restore_sharded", "sweep_shared_staging"]

_SHARED_STAGING_RE = re.compile(r"^step_\d{8}\.shared\.tmp$")
_OWNER_PREFIX = ".owner."


def _world():
    from ..distributed import world
    return world()


def _barrier(nprocs, tag, step=None):
    if nprocs > 1:
        from ..distributed import barrier
        # chaos: a KILL here is a rank dying AT the rendezvous -- the
        # previous phase's work done, the ack never posted; survivors
        # must abort with a typed BarrierTimeout naming this rank
        _chaos.fail_point("checkpoint.sharded.barrier." + tag,
                          tag=tag, step=step)
        barrier("ckpt_%s" % tag)


def sweep_shared_staging(root):
    """Remove ``step_<N>.shared.tmp`` staging dirs left by a dead
    sharded save.  The shared staging name carries no pid (all ranks
    address one dir), so liveness rides the ``.owner.<pid>`` marker
    rank 0 drops at creation: a dir whose owner is dead -- or that has
    no marker at all -- is torn down; a live owner's dir is in flight
    and left alone (but its *interior* dead-pid ``*.tmp`` shard crumbs
    are swept).  Returns removed paths."""
    removed = []
    try:
        entries = os.listdir(root)
    except OSError:
        return removed
    for name in entries:
        if not _SHARED_STAGING_RE.match(name):
            continue
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        owner = None
        try:
            for inner in os.listdir(path):
                if inner.startswith(_OWNER_PREFIX):
                    owner = int(inner[len(_OWNER_PREFIX):])
                    break
        except (OSError, ValueError):
            pass
        if owner is not None and (owner == os.getpid()
                                  or _core._pid_alive(owner)):
            removed.extend(_core.sweep_stale_tmps(path))
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
        _chaos.survived("checkpoint.sharded.shard_write", "sweep")
    return removed


def _local_shards(value, rank):
    """``(global_shape, dtype name, [(index, tensor), ...])`` of what
    this process stores of one replicated array: the whole array on
    rank 0 (its ``replica_id == 0`` copy), nothing elsewhere."""
    import torch
    data = getattr(value, "_data", value)
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
    shape = tuple(data.shape)
    name = str(data.dtype).rpartition(".")[2]
    if rank != 0:
        return shape, name, []
    return shape, name, [([[0, d] for d in shape], data.detach().cpu())]


def save_sharded(manager, step, items, metadata):
    """Stage and commit one sharded step under ``manager.root``.  Every
    process calls this with the same ``step``/``items``; returns the
    bytes written *by this process*.  Any failure -- a peer dead at a
    barrier, a local write error, an injected fault -- aborts the whole
    save cleanly (:func:`_abort_save`); the manifest is only renamed
    into place after EVERY rank confirmed at the "committed" gate."""
    from ..distributed import RankFailure
    nprocs, rank = _world()
    final = manager.step_dir(step)
    staging = final + ".shared.tmp"
    # the gate every survivor re-raises through; "stage" until the
    # first barrier passes, None once the commit gate has been crossed
    pending_gate = ["stage"]
    try:
        return _save_sharded_inner(manager, step, items, metadata,
                                   nprocs, rank, final, staging,
                                   pending_gate)
    except Exception as e:
        _abort_save(e, step, staging, nprocs, rank, pending_gate[0],
                    RankFailure)
        raise


def _save_sharded_inner(manager, step, items, metadata, nprocs, rank,
                        final, staging, pending_gate):
    from ..ndarray import ndarray as nd
    if rank == 0:
        # dead predecessors first (a killed world's staging), then this
        # step's own leftover
        sweep_shared_staging(manager.root)
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        with open(os.path.join(staging,
                               _OWNER_PREFIX + str(os.getpid())), "w"):
            pass
    _barrier(nprocs, "stage", step)
    pending_gate[0] = "written"

    nd.waitall()
    written = 0
    for name, value in sorted(items.items()):
        # chaos: a KILL here is a rank dying mid-shard-write -- pid-tmp
        # crumbs on disk, no "written" ack; survivors abort at the next
        # barrier and the crumbs are swept by the next save
        _chaos.fail_point("checkpoint.sharded.shard_write", item=name,
                          rank=rank, step=step, path=staging)
        if isinstance(value, (bytes, bytearray, memoryview)):
            if rank == 0:               # opaque blobs are rank-0 state
                written += _stage_file(staging, name + ".bin",
                                       lambda p: _write_bytes(p, value))
            continue
        payload = {}
        index = {}
        for key, arr in value.items():
            shape, dtype, shards = _local_shards(arr, rank)
            entry = {"global_shape": list(shape), "dtype": dtype,
                     "slices": []}
            for i, (sl, data) in enumerate(shards):
                skey = "%s@%d" % (key, i)
                payload[skey] = data
                entry["slices"].append({"key": skey, "index": sl})
            index[key] = entry
        fname = "%s.shard%05d.params" % (name, rank)
        written += _stage_file(staging, fname,
                               lambda p: nd.save(p, payload))
        written += _stage_file(
            staging, fname[:-7] + ".json",
            lambda p: _write_json(p, {"item": name, "rank": rank,
                                      "params": index}))

    _barrier(nprocs, "written", step)
    pending_gate[0] = "committed"
    if rank == 0:
        files = {}
        for fname in sorted(os.listdir(staging)):
            if fname.startswith("."):
                continue                # the .owner.<pid> marker
            nbytes, crc = _core.file_digest(os.path.join(staging, fname))
            kind = "shard" if ".shard" in fname else "bin"
            item = fname.split(".shard")[0] if kind == "shard" \
                else fname.rsplit(".", 1)[0]
            files[fname] = {"bytes": nbytes, "crc32": crc, "kind": kind,
                            "item": item}
        manifest = {
            "format_version": _core.FORMAT_VERSION,
            "step": int(step),
            "files": files,
            "topology": {"num_processes": int(nprocs), "process_id": 0,
                         "num_devices": int(nprocs)},
            "metadata": metadata or {},
        }

        def _write_manifest(tmp):
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
        # chaos: a KILL here is the coordinator dying mid-merge -- every
        # shard durable, no manifest; survivors time out at the
        # "committed" gate naming rank 0 and the save costs one step
        _chaos.fail_point("checkpoint.sharded.commit", step=step,
                          path=staging)
        _core.commit(os.path.join(staging, _core.MANIFEST_NAME),
                     _write_manifest)
        _core._fsync_dir(staging)
    # the commit GATE: the staged manifest becomes visible ONLY after
    # every rank confirms it got this far
    _barrier(nprocs, "committed", step)
    pending_gate[0] = None
    if rank == 0:
        try:
            os.remove(os.path.join(staging,
                                   _OWNER_PREFIX + str(os.getpid())))
        except OSError:
            pass
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(staging, final)
        _core._fsync_dir(manager.root)
    return written


def _stage_file(staging, fname, write_fn):
    """Write one staged file through a pid-suffixed temp + fsync +
    rename; returns the bytes written."""
    tmp = os.path.join(staging, "%s.%d.tmp" % (fname, os.getpid()))
    write_fn(tmp)
    nbytes, _crc = _core._digest(tmp, fsync=True)
    os.replace(tmp, os.path.join(staging, fname))
    return nbytes


def _write_bytes(path, value):
    # staging dir: atomicity comes from the pid-tmp rename in
    # _stage_file plus the directory rename at commit
    with open(path, "wb") as f:
        f.write(bytes(value))


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _abort_save(exc, step, staging, nprocs, rank, gate, rank_failure):
    """Clean abort on every survivor: tell peers (a failing-but-alive
    rank posts an abort ack at the gate they will wait on next), sweep
    the staging dir, count ``checkpoint.commit_aborted``, and credit
    the survival to the fail point that made the weather."""
    if gate is not None and nprocs > 1 \
            and not isinstance(exc, rank_failure):
        from ..distributed import post_abort
        try:
            post_abort("ckpt_%s" % gate, reason=type(exc).__name__)
        except Exception:
            pass
    shutil.rmtree(staging, ignore_errors=True)
    if _telemetry._ENABLED:
        _telemetry.hooks.checkpoint_commit_aborted(
            step, "%s: %s" % (type(exc).__name__, exc), rank=rank)
    if isinstance(exc, rank_failure):
        tag = getattr(exc, "tag", "") or ""
        point = "checkpoint.sharded.barrier." + tag[5:] \
            if tag.startswith("ckpt_") else "checkpoint.sharded.commit"
    elif getattr(exc, "point", None):     # an injected local fault
        point = exc.point
    else:
        point = "checkpoint.sharded.commit"
    _chaos.survived(point, "abort")


def restore_sharded(dirpath, manifest, sharding=None):
    """Reassemble a sharded step into full arrays, as NDArrays on the
    host (64-bit arrays become 32-bit, as every restore makes them).
    Returns ``(items, nbytes_read)``.  ``sharding`` (placement onto a
    mesh) raises: the mesh is the SPMD half of the multi-device slice,
    ROADMAP item 9b."""
    import torch
    from ..ndarray import ndarray as nd
    from ..ops.table import canonical
    if sharding is not None:
        raise MXNetError("restore(sharding=...): placing a restored step "
                         "onto a mesh waits for the SPMD half of the "
                         "multi-device slice (ROADMAP item 9b)")
    files = manifest["files"]
    items = {}
    nbytes = 0
    shard_indexes = {}
    for fname, entry in sorted(files.items()):
        nbytes += entry.get("bytes", 0)
        if entry.get("kind") == "bin":
            items[entry.get("item", fname)] = \
                _core.read_item(dirpath, fname, entry)
            continue
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(dirpath, fname)) as f:
            idx = json.load(f)
        shard_indexes.setdefault(idx["item"], []).append(
            (fname[:-5] + ".params", idx["params"]))
    for item, parts in sorted(shard_indexes.items()):
        assembled = {}
        for fname, index in parts:
            payload = nd.load_tensors(os.path.join(dirpath, fname))
            for key, entry in index.items():
                shape = tuple(entry["global_shape"])
                full = assembled.setdefault(key, torch.empty(
                    shape, dtype=getattr(torch, entry["dtype"])))
                for sl in entry["slices"]:
                    region = tuple(slice(a, b) for a, b in sl["index"])
                    full[region] = payload[sl["key"]].reshape(
                        full[region].shape)
        items[item] = {key: nd.NDArray(canonical(t))
                       for key, t in sorted(assembled.items())}
    return items, nbytes
