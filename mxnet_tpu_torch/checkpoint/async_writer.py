"""Async checkpoint writing: snapshot on the loop thread, commit on a
background thread (counterpart of ``mxnet_tpu/checkpoint/async_writer.py``).

At the loop boundary the parameters and optimizer state are copied to
host memory; a writer thread then serializes, fsyncs and atomically
commits them while the next steps run.  The port updates weights and
optimizer state in place (``Trainer.step``, ``TrainStep``'s bucketed
updates), so the snapshot must be a finished copy, never a reference:
:func:`snapshot_items` copies every array to the host before it
returns.

Contract:

- **at most one in flight** -- a new save first drains the previous
  one, so checkpoints land in order and host memory holds at most one
  extra copy of the state;
- **retries** -- a failed background write (a full disk blip, an NFS
  hiccup, an injected chaos fault at ``checkpoint.async_write``) retries
  up to ``MXNET_TPU_CKPT_WRITE_RETRIES`` times with exponential backoff
  from ``MXNET_TPU_CKPT_RETRY_BACKOFF_S`` seconds; a retry that lands
  counts as ``chaos.survived.checkpoint.async_write``;
- **errors are never swallowed** -- a write that fails every attempt is
  surfaced through the ``checkpoint.write_failed`` telemetry event and
  stored and re-raised at the next ``save()``/``wait_until_finished()``;
- ``wait_until_finished()`` is the durability barrier: after it returns
  the bytes are committed.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import chaos as _chaos
from .. import sync as _sync
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["AsyncWriter", "snapshot_items"]

# Test seam: when set to a threading.Event, the writer thread blocks on
# it before serializing -- how the tests show the training loop
# advancing while the bytes are not yet on disk.
_TEST_WRITE_GATE = None


def _env_default(name):
    from .. import env as _env
    return _env.get(name)


# a writer's defaults when its constructor is given none, read from the
# environment when the module loads
_RETRIES = _env_default("MXNET_TPU_CKPT_WRITE_RETRIES")
_BACKOFF_S = _env_default("MXNET_TPU_CKPT_RETRY_BACKOFF_S")


def _to_host(value):
    """A host copy of one array (NDArray, tensor or array-like) that
    later in-place updates of the source cannot reach."""
    from ..ndarray import NDArray
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return np.array(value, copy=True)


def snapshot_items(items):
    """Copy a save's payload to host memory at a consistent loop
    boundary: the device's queue drained first, then every array copied.
    Returns ``{name: (kind, payload)}`` with payloads safe to hand to
    another thread."""
    from ..ndarray import waitall
    waitall()
    snapshot = {}
    for name, value in items.items():
        if isinstance(value, (bytes, bytearray, memoryview)):
            snapshot[name] = ("bin", bytes(value))
        elif isinstance(value, dict):
            snapshot[name] = ("params",
                              {k: _to_host(v) for k, v in value.items()})
        else:
            raise MXNetError(
                "checkpoint item %r must be a dict of arrays or bytes, "
                "got %s" % (name, type(value).__name__))
    return snapshot


class AsyncWriter:
    """Background committer with the at-most-one-in-flight contract."""

    def __init__(self, retries=None, backoff_s=None):
        self._thread = None
        self._error = None
        self._lock = _sync.Lock(name="checkpoint.async_writer")
        self._retries = int(retries if retries is not None else _RETRIES)
        self._backoff_s = float(backoff_s if backoff_s is not None
                                else _BACKOFF_S)

    def check(self):
        """Re-raise (once) an error from a completed background save."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, fn, step=None):
        """Run ``fn()`` on the writer thread after draining the previous
        save (recorded as ``checkpoint.async_wait``) and re-raising its
        error; returns the seconds the drain took."""
        t0 = time.perf_counter()
        self.wait_until_finished()
        waited = time.perf_counter() - t0
        if _telemetry._ENABLED:
            _telemetry.hooks.checkpoint_wait(waited, step=step)

        def _run():
            gate = _TEST_WRITE_GATE
            if gate is not None:
                gate.wait()
            attempts = self._retries + 1
            for attempt in range(1, attempts + 1):
                try:
                    _chaos.fail_point("checkpoint.async_write",
                                      step=step, attempt=attempt)
                    fn()
                except Exception as e:  # re-raised by check()
                    if attempt < attempts:
                        # transient weather: back off and retry; the
                        # staged dir is made anew, so a partial attempt
                        # cannot poison the next one
                        if _telemetry._ENABLED:
                            _telemetry.hooks.checkpoint_retry(
                                attempt, str(e), step=step)
                        time.sleep(self._backoff_s * (2 ** (attempt - 1)))
                        continue
                    if _telemetry._ENABLED:
                        _telemetry.hooks.checkpoint_write_failed(
                            attempts, str(e), step=step)
                    with self._lock:
                        self._error = e
                else:
                    if attempt > 1:
                        _chaos.survived("checkpoint.async_write", "retry")
                    return

        self._thread = threading.Thread(
            target=_run, name="mxtt-ckpt-writer-%s" % step, daemon=True)
        self._thread.start()
        return waited

    def wait_until_finished(self):
        """Join the in-flight save (if any) and surface its error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self.check()

    @property
    def in_flight(self):
        t = self._thread
        return t is not None and t.is_alive()
