"""KVStore, the single-process types (counterpart of
``mxnet_tpu/kvstore.py``).

``create("local" | "device" | "nccl")`` gives a :class:`KVStore` over one
process.  There are no per-device gradient copies to reduce on one card,
so a pushed list of values is summed (the reference's ``CommDevice``
reduce) and that is all the reduction there is:

- without an optimizer, ``push`` keeps the merged value until a
  ``pull`` takes it, and ``pushpull`` returns it (allreduce semantics
  over one worker);
- after :meth:`KVStore.set_optimizer`, ``push`` and ``pushpull`` update
  the stored copy of the key through the optimizer's updater, and
  ``pull`` reads that copy (``update_on_kvstore``).

``set_gradient_compression({"type": "2bit", "threshold": t})`` quantizes
each merged value to ``{-t, 0, t}`` with an error-feedback residual a
key (:class:`_TwoBitCompression`), as ``gradient_compression.cc`` does.

Every operation stays on the value's device: a merge, a compression or
an update is device math, and ``out`` is written in place (its tensor
stays the one a parameter, an optimizer or a captured graph holds).
Values and outputs are NDArrays or tensors.  The multi-process types
(``dist_*``, ``horovod``) and ``row_sparse_pull`` are not ported.
"""
from __future__ import annotations

import pickle

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "nccl")
_DIST = ("dist", "dist_sync", "dist_async", "dist_device_sync", "horovod")


def _tensor(value):
    return value._data if isinstance(value, NDArray) else value


class _TwoBitCompression:
    """2-bit gradient compression with error feedback (reference:
    ``src/kvstore/gradient_compression.cc``): what quantization drops
    from a key's value is added to its next one."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residual = {}

    def compress_decompress(self, key, grad):
        r = self._residual.get(key)
        g = grad if r is None else grad + r
        t = self.threshold
        q = torch.where(g >= t, t, torch.where(g <= -t, -t, 0.0)) \
            .to(g.dtype)
        self._residual[key] = g - q
        return q


class KVStore:
    """A single-process key-value store of tensors (reference:
    ``python/mxnet/kvstore.py :: KVStore``)."""

    def __init__(self, kv_type="local"):
        if kv_type not in _LOCAL:
            raise MXNetError(_not_ported(kv_type))
        self.type = kv_type
        self._store = {}       # key -> tensor (the "server" copy)
        self._pending = {}     # key -> merged value awaiting a pull
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @staticmethod
    def _keyify(key):
        return key if isinstance(key, (str, int)) else str(key)

    def init(self, key, value):
        """Store a copy of ``value`` under ``key`` (a key given twice
        keeps its first value)."""
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        key = self._keyify(key)
        if key not in self._store:
            self._store[key] = _tensor(value).detach().clone()

    def _reduce(self, key, value):
        """The sum of a pushed value or list of values, compressed when
        compression is set."""
        if isinstance(value, (list, tuple)):
            merged = _tensor(value[0]).detach()
            for v in value[1:]:
                merged = merged + _tensor(v).detach()
        else:
            merged = _tensor(value).detach()
        if self._compression is not None:
            merged = self._compression.compress_decompress(key, merged)
        return merged

    def _stored(self, key):
        if key not in self._store:
            raise MXNetError("kvstore key %r not initialized" % key)
        return self._store[key]

    @torch.no_grad()
    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        key = self._keyify(key)
        stored = self._stored(key)
        merged = self._reduce(key, value)
        if self._updater is not None:
            self._updater(key, merged, stored)
        elif key in self._pending:
            self._pending[key] = self._pending[key] + merged
        else:
            self._pending[key] = merged

    @staticmethod
    def _write(out, src):
        """Copy ``src`` into each ``out`` that is not already a view of
        the same elements (a single-process ``pushpull`` of a gradient
        into itself copies nothing)."""
        outs = out if isinstance(out, (list, tuple)) else [out]
        for o in outs:
            t = _tensor(o)
            if (t.data_ptr(), t.shape, t.stride(), t.dtype) != \
                    (src.data_ptr(), src.shape, src.stride(), src.dtype):
                t.copy_(src)

    @torch.no_grad()
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        key = self._keyify(key)
        stored = self._stored(key)
        src = stored
        if self._updater is None and key in self._pending:
            src = self._pending.pop(key)
        self._write(out, src)
        return out

    @torch.no_grad()
    def pushpull(self, key, value, out=None, priority=0):
        """Fused push and pull (reference: ``MXKVStorePushPullEx``):
        without an optimizer, ``out`` gets the merged ``value``; with
        one, the stored copy is updated and ``out`` gets it."""
        if isinstance(key, (list, tuple)):
            outs = out if out is not None else [None] * len(key)
            for k, v, o in zip(key, value, outs):
                self.pushpull(k, v, o, priority)
            return
        key = self._keyify(key)
        if self._updater is not None:
            result = self._stored(key)
            self._updater(key, self._reduce(key, value), result)
        else:
            result = self._reduce(key, value)
        if out is not None:
            self._write(out, result)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: sparse arrays are not ported "
                         "yet (ROADMAP Queue 1 item 10)")

    def set_optimizer(self, optimizer):
        """Update stored values with ``optimizer`` at each push (a copy
        of it, as the reference pickles it to its servers)."""
        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = opt.get_updater(self._optimizer)

    def set_gradient_compression(self, compression_params):
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError("unsupported compression type %r" % ctype)
        self._compression = _TwoBitCompression(
            compression_params.get("threshold", 0.5))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        from .checkpoint.core import atomic_write_bytes
        atomic_write_bytes(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        """Nothing to wait for in one process."""


def _not_ported(name):
    if name in _DIST:
        return ("kvstore %r: multi-process kvstores are not ported yet "
                "(ROADMAP Queue 1 item 9)" % name)
    return "unknown kvstore type %r" % name


def create(name="local"):
    """A single-process store: ``"local"``, ``"device"`` or ``"nccl"``
    (reference: ``kvstore.create``)."""
    if name not in _LOCAL:
        raise MXNetError(_not_ported(name))
    return KVStore(name)
