"""``mxnet_tpu_torch.checkpoint``: managed checkpoints with atomic
commit, integrity verification, retention and async writes (counterpart
of ``mxnet_tpu/checkpoint``, one process; its ``sharded`` layout is not
ported yet).

- :mod:`.core` -- tmp+fsync+rename file commits, step-numbered
  checkpoint directories with a checksum-carrying manifest committed
  LAST, and :class:`CheckpointManager` with corruption-tolerant
  discovery and retention;
- :mod:`.async_writer` -- a host copy at the loop boundary, serialize
  and commit on a background thread, at most one in flight, errors
  re-raised at the next save or wait.

Env knobs: ``MXNET_TPU_CKPT_ASYNC``, ``MXNET_TPU_CKPT_MAX_TO_KEEP``.
"""
from .core import (Checkpoint, CheckpointError, CheckpointManager,
                   atomic_write_bytes, commit, file_digest,
                   load_manifest, sweep_stale_tmps, verify_files,
                   FORMAT_VERSION, MANIFEST_NAME)
from .async_writer import AsyncWriter, snapshot_items
from . import core
from . import async_writer

__all__ = [
    "Checkpoint", "CheckpointError", "CheckpointManager", "AsyncWriter",
    "atomic_write_bytes", "commit", "file_digest", "load_manifest",
    "snapshot_items", "sweep_stale_tmps", "verify_files",
    "FORMAT_VERSION", "MANIFEST_NAME", "core", "async_writer",
]
