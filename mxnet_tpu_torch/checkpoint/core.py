"""Atomic, manifest-verified, step-numbered checkpoints (counterpart of
``mxnet_tpu/checkpoint/core.py``; the multi-process sharded layout is
:mod:`.sharded`).

Two layers:

**File commits** -- :func:`commit` writes through a ``<path>.<pid>.tmp``
staging file, fsyncs, then renames (``os.replace``) into place, so a
crash at any instant leaves either the old file or the new one, never a
truncated hybrid.  Every commit also sweeps stale temps left by writers
that died (:func:`sweep_stale_tmps`).

**Managed step directories** -- :class:`CheckpointManager` owns a root
directory of ``step_<N>/`` checkpoints.  A save stages every file in
``step_<N>.<pid>.tmp/``, fsyncs, writes ``manifest.json`` (per-file
byte sizes and CRC32 checksums, topology, step, user metadata) LAST,
then renames the whole directory into place.  Discovery tolerates
corruption: a step whose manifest is missing or invalid, or whose
checksums mismatch, is skipped with a warning (and quarantined) and the
previous good step wins.  Retention (``max_to_keep`` /
``keep_every_n_steps``) and async writing (:mod:`.async_writer`) hang
off the manager.

The chaos fail points ``checkpoint.commit.pre_manifest`` (data files
staged, manifest not yet written: the kill-mid-commit spot) and
``checkpoint.commit.post_commit`` (after the publishing rename: a
corruption there is what verification and quarantine exist to catch)
sit where the JAX package has them, and saves, restores and
quarantines count under its ``checkpoint.*`` telemetry.

Files and manifests are the JAX package's: a step written by either
package restores in the other.  Restored arrays come back on the host;
:meth:`CheckpointManager.restore_training` copies each into its
parameter on the parameter's device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import warnings
import zlib

from .. import chaos as _chaos
from .. import obs as _obs
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = [
    "CheckpointError", "CheckpointManager", "Checkpoint",
    "commit", "atomic_write_bytes", "sweep_stale_tmps",
    "file_digest", "load_manifest", "verify_files",
    "MANIFEST_NAME", "FORMAT_VERSION",
]

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"\.(\d+)\.tmp$")
_DIGEST_CHUNK = 1 << 20


class CheckpointError(MXNetError):
    """A checkpoint failed to commit or verify."""


# ----------------------------------------------------------------------
# file commits
# ----------------------------------------------------------------------

def _fsync_dir(path):
    """Durably record a rename/create in its directory (best-effort:
    some filesystems refuse a directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _digest(path, fsync):
    """``(nbytes, crc32)`` of a file, fsynced first when asked."""
    crc = 0
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_DIGEST_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
        if fsync:
            os.fsync(f.fileno())
    return nbytes, crc & 0xFFFFFFFF


def file_digest(path):
    """``(nbytes, crc32)`` of a file (no fsync; verification reads)."""
    return _digest(path, fsync=False)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def sweep_stale_tmps(dirpath, prefix=None):
    """Remove ``*.<pid>.tmp`` files and directories whose writer process
    is dead; temps of live pids (our own in-flight async writer among
    them) stay.  Called at manager init and by every :func:`commit`.
    Returns the paths removed."""
    removed = []
    try:
        entries = os.listdir(dirpath)
    except OSError:
        return removed
    for name in entries:
        m = _TMP_RE.search(name)
        if m is None:
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(dirpath, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def commit(path, write_fn):
    """Atomically publish one file: ``write_fn(tmp)`` -> fsync ->
    ``os.replace(tmp, path)``.  Returns ``(nbytes, crc32)`` of the
    committed bytes.  On any failure the temp is removed and the
    previous ``path`` is untouched."""
    path = os.fspath(path)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        write_fn(tmp)
        nbytes, crc = _digest(tmp, fsync=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    parent = os.path.dirname(path) or "."
    _fsync_dir(parent)
    sweep_stale_tmps(parent, prefix=os.path.basename(path))
    return nbytes, crc


def atomic_write_bytes(path, data):
    """Atomically replace ``path`` with ``data`` (bytes): the helper
    behind ``Trainer.save_states``."""
    def _write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    return commit(path, _write)


# ----------------------------------------------------------------------
# manifests
# ----------------------------------------------------------------------

def load_manifest(dirpath):
    """Parse ``manifest.json`` of a step dir; raises CheckpointError if
    missing or invalid."""
    mpath = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except OSError as e:
        raise CheckpointError("no manifest in %s: %s" % (dirpath, e)) from e
    except ValueError as e:
        raise CheckpointError("invalid manifest in %s: %s"
                              % (dirpath, e)) from e
    if not isinstance(manifest, dict) or "files" not in manifest:
        raise CheckpointError("malformed manifest in %s" % dirpath)
    return manifest


def verify_files(dirpath, files):
    """Check every manifest entry against the bytes on disk.  Returns a
    list of problem strings (empty = intact).  ``files`` is the
    manifest's ``{fname: {"bytes": n, "crc32": c, ...}}`` mapping."""
    problems = []
    for fname, entry in files.items():
        fpath = os.path.join(dirpath, fname)
        if not os.path.exists(fpath):
            problems.append("missing file %r" % fname)
            continue
        nbytes, crc = file_digest(fpath)
        if nbytes != entry.get("bytes"):
            problems.append("size mismatch on %r: %d != %d"
                            % (fname, nbytes, entry.get("bytes")))
        elif crc != entry.get("crc32"):
            problems.append("crc32 mismatch on %r" % fname)
    return problems


# ----------------------------------------------------------------------
# items: a dict of arrays (a .params file) or raw bytes (a .bin blob)
# ----------------------------------------------------------------------

def write_item(dirpath, name, kind, payload):
    """Write one staged item file; returns ``(fname, manifest entry)``.
    Inside staging there is no concurrent reader, so the write is
    plain: the atomicity boundary is the directory rename."""
    if kind == "params":
        from ..ndarray import ndarray as nd
        fname = name + ".params"
        nd.save(os.path.join(dirpath, fname), payload)
    elif kind == "bin":
        fname = name + ".bin"
        with open(os.path.join(dirpath, fname), "wb") as f:
            f.write(payload)
    else:
        raise CheckpointError("unknown item kind %r" % kind)
    nbytes, crc = _digest(os.path.join(dirpath, fname), fsync=True)
    return fname, {"bytes": nbytes, "crc32": crc, "kind": kind,
                   "item": name}


def _topology():
    from ..distributed import world
    nprocs, rank = world()
    return {"num_processes": int(nprocs), "process_id": int(rank)}


def read_item(dirpath, fname, entry):
    """Load one manifest entry back: a ``params`` item as a dict of
    NDArrays on the host, a ``bin`` item as bytes."""
    kind = entry.get("kind", "bin")
    fpath = os.path.join(dirpath, fname)
    if kind == "params":
        from ..context import cpu
        from ..ndarray import ndarray as nd
        return nd.load(fpath, ctx=cpu())
    if kind == "bin":
        with open(fpath, "rb") as f:
            return f.read()
    raise CheckpointError("unknown item kind %r in manifest" % kind)


class Checkpoint:
    """What :meth:`CheckpointManager.restore` returns: ``step``, the
    ``items`` dict (name -> dict of NDArrays or bytes), and the user
    ``metadata`` saved alongside."""

    __slots__ = ("step", "items", "metadata")

    def __init__(self, step, items, metadata):
        self.step = step
        self.items = items
        self.metadata = metadata

    def __repr__(self):
        return "Checkpoint(step=%d, items=%s)" % (self.step,
                                                  sorted(self.items))


# ----------------------------------------------------------------------
# manager
# ----------------------------------------------------------------------

class CheckpointManager:
    """Managed step-numbered checkpoints under one root directory.

    ::

        mgr = mx.checkpoint.CheckpointManager(root, max_to_keep=3)
        mgr.save_training(step, net, trainer)
        ...
        ckpt = mgr.restore_training(net, trainer)   # newest intact step

    ``items`` of :meth:`save` are dicts of arrays (saved as ``.params``)
    or raw ``bytes`` blobs.  Options (``None`` defers to the env
    registry):

    - ``max_to_keep`` (``MXNET_TPU_CKPT_MAX_TO_KEEP``; 0 = unlimited):
      oldest steps beyond this many are deleted after each save;
    - ``keep_every_n_steps``: steps divisible by this are exempt from
      ``max_to_keep``;
    - ``async_save`` (``MXNET_TPU_CKPT_ASYNC``): copy the state to host
      memory at ``save()``, then serialize and commit on a background
      thread; at most one save in flight, a writer error re-raised at
      the next ``save``/``wait_until_finished``;

    - ``quarantine`` (``MXNET_TPU_CKPT_QUARANTINE``, default on): a
      step that fails verification during :meth:`latest_step` is
      renamed ``step_<N>.corrupt`` (counted in
      ``checkpoint.quarantined``) instead of silently skipped.

    - ``sharded`` (default: auto = multi-process runs): every process
      takes part in each save, rank 0 stores the replicated arrays, and
      three attributed barriers gate the commit (:mod:`.sharded`).
      Saves are synchronous under it, as in the JAX package.
    """

    def __init__(self, root, max_to_keep=None, keep_every_n_steps=None,
                 async_save=None, sharded=None, quarantine=None):
        from .. import env as _env
        if quarantine is None:
            quarantine = _env.get("MXNET_TPU_CKPT_QUARANTINE")
        self.quarantine = bool(quarantine)
        self.root = os.fspath(root)
        if max_to_keep is None:
            max_to_keep = _env.get("MXNET_TPU_CKPT_MAX_TO_KEEP") or None
        if max_to_keep is not None and max_to_keep < 1:
            max_to_keep = None
        self.max_to_keep = max_to_keep
        self.keep_every_n_steps = keep_every_n_steps or None
        if async_save is None:
            async_save = _env.get("MXNET_TPU_CKPT_ASYNC")
        self._sharded = sharded
        self._writer = None
        if async_save:
            from .async_writer import AsyncWriter
            self._writer = AsyncWriter()
        os.makedirs(self.root, exist_ok=True)
        sweep_stale_tmps(self.root)
        if _topology()["process_id"] == 0:
            # a dead multi-rank world's shared staging: the sharded
            # layout stages without a pid suffix, so its sweep rides an
            # owner marker instead
            from . import sharded as _sharded
            _sharded.sweep_shared_staging(self.root)

    # -- layout --------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.root, "step_%08d" % int(step))

    def all_steps(self):
        """Every committed step number, ascending (no intactness check:
        use :meth:`latest_step` for the newest that loads)."""
        steps = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return steps
        for name in entries:
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _verify_step(self, step):
        """Manifest of an intact step, or None (with a warning)."""
        dirpath = self.step_dir(step)
        try:
            manifest = load_manifest(dirpath)
            problems = verify_files(dirpath, manifest["files"])
        except CheckpointError as e:
            problems = [str(e)]
            manifest = None
        if problems:
            warnings.warn(
                "checkpoint step %d at %s failed verification (%s); "
                "skipping it" % (step, dirpath, "; ".join(problems)),
                RuntimeWarning, stacklevel=3)
            return None
        return manifest

    def _quarantine_step(self, step):
        """Rename a step dir that failed verification to
        ``<dir>.corrupt``, so the rollback is visible and the torn bytes
        stay as evidence (a no-op with ``quarantine`` off).  Tolerant of
        a concurrent writer re-saving the step or another process
        quarantining first; rank 0 only in a multi-process world."""
        if not self.quarantine or _topology()["process_id"] != 0:
            return False
        src = self.step_dir(step)
        dst = src + ".corrupt"
        try:
            if os.path.isdir(dst):
                shutil.rmtree(dst, ignore_errors=True)
            os.replace(src, dst)
        except OSError:
            return False
        if _telemetry._ENABLED:
            _telemetry.hooks.checkpoint_quarantine(step, dst)
        _chaos.survived("checkpoint.commit", "quarantine")
        return True

    def latest_step(self):
        """Newest step that passes manifest and checksum verification,
        or None.  A torn newest step falls back to the previous good
        one and is quarantined."""
        for step in reversed(self.all_steps()):
            if self._verify_step(step) is not None:
                return step
            self._quarantine_step(step)
        return None

    # -- save ----------------------------------------------------------
    def save(self, step, items, metadata=None):
        """Checkpoint ``items`` as ``step``.  Synchronous unless the
        manager was built with ``async_save``; either way the state is
        copied to host memory before this returns, so the training loop
        may update parameters and optimizer state in place at once."""
        step = int(step)
        if not isinstance(items, dict) or not items:
            raise CheckpointError("save() needs a non-empty items dict")
        if self._writer is not None:
            self._writer.check()        # re-raise a prior writer error
        from .async_writer import snapshot_items
        t0 = time.perf_counter()
        if self._use_sharded():
            from . import sharded
            nbytes = sharded.save_sharded(self, step, items, metadata)
            self._record_save(step, nbytes, time.perf_counter() - t0,
                              async_save=False)
            return
        snapshot = snapshot_items(items)

        def _write():
            nbytes = self._write_step(step, snapshot, metadata)
            self._apply_retention()
            return nbytes

        if self._writer is not None:
            self._writer.submit(_write, step=step)
            self._record_save(step, None, time.perf_counter() - t0,
                              async_save=True)
        else:
            nbytes = _write()
            self._record_save(step, nbytes, time.perf_counter() - t0,
                              async_save=False)

    def _use_sharded(self):
        if self._sharded is not None:
            return self._sharded
        return _topology()["num_processes"] > 1

    def _record_save(self, step, nbytes, seconds, async_save):
        if _telemetry._ENABLED:
            _telemetry.hooks.checkpoint("save", nbytes=nbytes,
                                        seconds=seconds, step=step,
                                        root=self.root,
                                        async_save=async_save)

    def _write_step(self, step, snapshot, metadata):
        """Serialize a host snapshot into a staged dir and commit it;
        returns the bytes written.  Runs on the writer thread under
        async saves."""
        sp = _obs.begin_span("checkpoint.commit", step=step) \
            if _obs._TRACE_ENABLED else None
        try:
            return self._write_step_inner(step, snapshot, metadata)
        finally:
            if sp is not None:
                _obs.end_span(sp)

    def _write_step_inner(self, step, snapshot, metadata):
        final = self.step_dir(step)
        staging = "%s.%d.tmp" % (final, os.getpid())
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        files = {}
        total = 0
        for name, (kind, payload) in sorted(snapshot.items()):
            fname, entry = write_item(staging, name, kind, payload)
            files[fname] = entry
            total += entry["bytes"]
        manifest = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "files": files,
            "topology": _topology(),
            "metadata": metadata or {},
        }

        def _write_manifest(tmp):
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
        # chaos: a KILL here is the canonical kill-mid-commit -- data
        # files staged, manifest absent -- which must cost at most one
        # step, never the job
        _chaos.fail_point("checkpoint.commit.pre_manifest", step=step,
                          path=staging)
        # manifest LAST: its presence asserts every data file above it
        # is complete, so the rename below publishes all-or-nothing
        commit(os.path.join(staging, MANIFEST_NAME), _write_manifest)
        _fsync_dir(staging)
        if os.path.isdir(final):        # re-saving an existing step
            shutil.rmtree(final)
        os.replace(staging, final)
        _fsync_dir(self.root)
        sweep_stale_tmps(self.root)
        # chaos: corruption AFTER the atomic publish models bit-rot or a
        # non-atomic foreign writer -- what manifest verification and
        # quarantine exist to catch
        _chaos.fail_point("checkpoint.commit.post_commit", step=step,
                          path=final)
        return total

    def _apply_retention(self):
        if self.max_to_keep is None:
            return
        keep_n = self.keep_every_n_steps
        candidates = [s for s in self.all_steps()
                      if not (keep_n and s % keep_n == 0)]
        excess = len(candidates) - self.max_to_keep
        for step in candidates[:max(0, excess)]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)

    # -- restore -------------------------------------------------------
    def restore(self, step=None, sharding=None):
        """Load a checkpoint: the newest intact step when ``step`` is
        None (None if there is none), or exactly ``step`` (raising
        CheckpointError if it fails verification).  Arrays come back as
        NDArrays on the host, a sharded step's reassembled
        (:func:`.sharded.restore_sharded`).  ``sharding`` (placement
        onto a mesh) waits for ROADMAP item 9b and raises."""
        if sharding is not None:
            raise CheckpointError(
                "restore(sharding=...): placing a restored step onto a "
                "mesh waits for the SPMD half of the multi-device slice "
                "(ROADMAP item 9b)")
        self.wait_until_finished()
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
            manifest = self._verify_step(step)
            if manifest is None:        # raced a concurrent delete
                return None
        else:
            step = int(step)
            manifest = self._verify_step(step)
            if manifest is None:
                raise CheckpointError(
                    "checkpoint step %d failed verification" % step)
        dirpath = self.step_dir(step)
        if any(e.get("kind") == "shard"
               for e in manifest["files"].values()):
            from . import sharded
            items, _nbytes = sharded.restore_sharded(dirpath, manifest)
        else:
            items = {entry.get("item", fname):
                     read_item(dirpath, fname, entry)
                     for fname, entry in sorted(manifest["files"].items())}
        if _telemetry._ENABLED:
            _telemetry.hooks.checkpoint(
                "restore",
                nbytes=sum(e.get("bytes", 0)
                           for e in manifest["files"].values()),
                seconds=time.perf_counter() - t0, step=step,
                root=self.root)
        return Checkpoint(step, items, manifest.get("metadata", {}))

    # -- training-loop conveniences ------------------------------------
    def save_training(self, step, block, trainer=None, metadata=None):
        """Checkpoint a Gluon block's parameters by structural name
        (and a Trainer's optimizer state)."""
        items = {"params": {k: p._reduce() for k, p in
                            block._collect_params_with_prefix().items()
                            if p._data is not None}}
        if trainer is not None:
            items["trainer"] = trainer.get_states()
        self.save(step, items, metadata=metadata)

    def restore_training(self, block, trainer=None, step=None, ctx=None):
        """Restore :meth:`save_training` state in place; returns the
        Checkpoint (None on a fresh start)."""
        ckpt = self.restore(step=step)
        if ckpt is None:
            return None
        params = ckpt.items.get("params")
        if params is not None:
            _load_block_params(block, params, ctx=ctx)
        if trainer is not None and "trainer" in ckpt.items:
            trainer.set_states(ckpt.items["trainer"])
        return ckpt

    # -- async plumbing ------------------------------------------------
    def wait_until_finished(self):
        """Block until any in-flight async save has committed; re-raises
        the writer's error if it failed."""
        if self._writer is not None:
            self._writer.wait_until_finished()

    def close(self):
        self.wait_until_finished()


def _load_block_params(block, params, ctx=None):
    """Assign a restored params dict onto a block by structural name.
    A gradient-taking parameter keeps its tensor, which the optimizer
    state and autograd hold: the value is copied into it.  An auxiliary
    one (``grad_req="null"``) is rebound; one whose shape is still
    deferred takes the value's shape on ``ctx`` or its recorded
    device."""
    targets = block._collect_params_with_prefix()
    for name in params:
        if name not in targets:
            raise CheckpointError(
                "restored parameter %r not found in block" % name)
    for name, data in params.items():
        targets[name]._load(data, ctx)
