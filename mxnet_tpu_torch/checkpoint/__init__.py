"""``mxnet_tpu_torch.checkpoint``: managed checkpoints with atomic
commit, integrity verification, retention and async writes (counterpart
of ``mxnet_tpu/checkpoint``).

- :mod:`.core` -- tmp+fsync+rename file commits, step-numbered
  checkpoint directories with a checksum-carrying manifest committed
  LAST, and :class:`CheckpointManager` with corruption-tolerant
  discovery and retention;
- :mod:`.async_writer` -- a host copy at the loop boundary, serialize
  and commit on a background thread, at most one in flight, errors
  re-raised at the next save or wait;
- :mod:`.sharded` -- the multi-process layout: per-rank shard files,
  three attributed barriers, the manifest renamed in only after every
  rank confirmed (the rank-death-safe commit).

Env knobs: ``MXNET_TPU_CKPT_ASYNC``, ``MXNET_TPU_CKPT_MAX_TO_KEEP``.
"""
from .core import (Checkpoint, CheckpointError, CheckpointManager,
                   atomic_write_bytes, commit, file_digest,
                   load_manifest, sweep_stale_tmps, verify_files,
                   FORMAT_VERSION, MANIFEST_NAME)
from .async_writer import AsyncWriter, snapshot_items
from . import core
from . import async_writer
from . import sharded

__all__ = [
    "Checkpoint", "CheckpointError", "CheckpointManager", "AsyncWriter",
    "atomic_write_bytes", "commit", "file_digest", "load_manifest",
    "snapshot_items", "sweep_stale_tmps", "verify_files",
    "FORMAT_VERSION", "MANIFEST_NAME", "core", "async_writer", "sharded",
]
