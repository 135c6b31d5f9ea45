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
- **retries** -- a failed background write retries ``_RETRIES`` times
  with exponential backoff from ``_BACKOFF_S`` seconds;
- **errors are never swallowed** -- a write that fails every attempt is
  stored and re-raised at the next ``save()``/``wait_until_finished()``;
- ``wait_until_finished()`` is the durability barrier: after it returns
  the bytes are committed.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["AsyncWriter", "snapshot_items"]

# Test seam: when set to a threading.Event, the writer thread blocks on
# it before serializing -- how the tests show the training loop
# advancing while the bytes are not yet on disk.
_TEST_WRITE_GATE = None

_RETRIES = 2
_BACKOFF_S = 0.25


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

    def __init__(self):
        self._thread = None
        self._error = None
        self._lock = threading.Lock()

    def check(self):
        """Re-raise (once) an error from a completed background save."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, fn, step=None):
        """Run ``fn()`` on the writer thread after draining the previous
        save (and re-raising its error)."""
        self.wait_until_finished()

        def _run():
            gate = _TEST_WRITE_GATE
            if gate is not None:
                gate.wait()
            attempts = _RETRIES + 1
            for attempt in range(1, attempts + 1):
                try:
                    fn()
                    return
                except Exception as e:  # re-raised by check()
                    if attempt < attempts:
                        time.sleep(_BACKOFF_S * (2 ** (attempt - 1)))
                        continue
                    with self._lock:
                        self._error = e

        self._thread = threading.Thread(
            target=_run, name="mxtt-ckpt-writer-%s" % step, daemon=True)
        self._thread.start()

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
