"""Engine control surface (counterpart of ``mxnet_tpu/engine.py``).

The reference's dependency engine (``src/engine/threaded_engine.cc``)
schedules every mutation as an asynchronous op over versioned
variables.  Here the CUDA stream orders and runs each eager launch
asynchronously, so this module keeps only the controls: the sync point
(``waitall``), the bulk size and scope, and the naive-engine switch.

Bulking is the port's sixth deviation.  The JAX package defers eager
ops and replays each region as one jitted program
(``mxnet_tpu/ndarray/bulk.py``); the port defers nothing.  Each eager
op is launched at once on the stream, which already takes launches
asynchronously; a region replayed as a CUDA graph would write its
outputs into the same static buffers on every replay (each output the
caller holds would need a copy out), and its key is unknown until its
last op is called.  The port's captured regions are ``hybridize()``
and ``TrainStep``.  So the bulk size is kept and reported with the JAX
package's contract, and a result inside a bulk scope is bitwise the
result outside it.
"""
from __future__ import annotations

import contextlib
import threading

from . import env as _env
from .ndarray.ndarray import waitall  # re-export  # noqa: F401

__all__ = ["bulk", "is_blocking", "set_bulk_size", "waitall"]

_blocking = _env.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
_lock = threading.Lock()
_state = {"enabled": _env.get("MXNET_TPU_EAGER_BULK"),
          "size": _env.get("MXNET_TPU_EAGER_BULK_MAX")}


def set_bulk_size(size):
    """Reference: ``mx.engine.set_bulk_size``.  Sets the most eager ops
    a bulk region may hold and returns the previous effective size, 0
    while bulking was off; ``size <= 1`` turns bulking off.  The port
    keeps the number and defers no op (see the module docstring)."""
    size = int(size)
    with _lock:
        prev = _state["size"] if _state["enabled"] else 0
        if size <= 1:
            _state["enabled"] = False
        else:
            _state["enabled"] = True
            _state["size"] = size
    return prev


@contextlib.contextmanager
def bulk(size):
    """Bulk scope (reference: ``with mx.engine.bulk(size):``): the bulk
    size is ``size`` inside and the previous one again on exit, also on
    an exception.  Ops inside run as they do outside it."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def is_blocking():
    """True under ``MXNET_ENGINE_TYPE=NaiveEngine``, read at import."""
    return _blocking
