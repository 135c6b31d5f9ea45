"""KVStore (counterpart of ``mxnet_tpu/kvstore.py``).

``create("local" | "device" | "nccl")`` gives a single-process store.
There are no per-device gradient copies to reduce on one card, so a
pushed list of values is summed (the reference's ``CommDevice``
reduce) and that is all the reduction there is:

- without an optimizer, ``push`` keeps the merged value until a
  ``pull`` takes it, and ``pushpull`` returns it (allreduce semantics
  over one worker);
- after :meth:`KVStore.set_optimizer`, ``push`` and ``pushpull`` update
  the stored copy of the key through the optimizer's updater, and
  ``pull`` reads that copy (``update_on_kvstore``).

``create("dist_sync" | "dist_device_sync" | "dist_async" | "dist")``
gives the multi-process store: ``rank``/``num_workers`` are the
world's (:func:`~mxnet_tpu_torch.distributed.world`), and each merged
value is summed across the processes before it is stored, returned or
applied (:func:`~mxnet_tpu_torch.distributed.host_allreduce`, a gloo
all-gather of host copies summed in rank order);
:meth:`KVStore.pushpull_bucket` reduces a whole list of keys in one
collective a dtype.  The four types share this path, as they do in the
JAX package: ``dist_async`` keeps synchronous semantics.  A store
created before :func:`~mxnet_tpu_torch.distributed.distributed_init`
(or in one process) reduces over one process.  ``"horovod"`` is the
JAX package's single-process store of that name (the reduction is
:class:`~mxnet_tpu_torch.horovod.DistributedTrainer`'s).

``set_gradient_compression({"type": "2bit", "threshold": t})`` quantizes
each merged value to ``{-t, 0, t}`` with an error-feedback residual a
key (:class:`_TwoBitCompression`), as ``gradient_compression.cc`` does,
before the cross-process sum.

Every operation stays on the value's device: a merge, a compression or
an update is device math, and ``out`` is written in place (its tensor
stays the one a parameter, an optimizer or a captured graph holds).
Values and outputs are NDArrays or tensors.  With telemetry on, each
verb records the JAX package's ``kvstore.*`` instruments.

Row-sparse values (:class:`~mxnet_tpu_torch.ndarray.sparse.
RowSparseNDArray`) follow the JAX package: a pushed list of them merges
by the union of their rows and stays sparse, a dense operand makes the
merge dense; a sparse merge skips compression, and a dist store
densifies it before the cross-process sum (the ranks' row sets differ).
With an optimizer, a sparse gradient reaches the updater as it is
(``Optimizer.update_row_sparse``); without one, ``pull`` densifies what
``push`` kept, and ``pushpull``/``pushpull_bucket`` return it dense.
:meth:`KVStore.row_sparse_pull` gathers only the requested rows (their
ids deduplicated on the host, as the JAX store does).
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch

from . import optimizer as opt
from . import telemetry as _telemetry
from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ndarray import sparse as _sp

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device", "nccl", "dist", "dist_sync", "dist_async",
          "dist_device_sync", "horovod")


def _tensor(value):
    return value._data if isinstance(value, NDArray) else value


def _value_nbytes(value):
    """Payload size of a pushed or pulled value, from its metadata (a
    row-sparse value's stored rows and ids)."""
    if isinstance(value, (list, tuple)):
        return sum(_value_nbytes(v) for v in value)
    if isinstance(value, _sp.RowSparseNDArray):
        return sum(t.numel() * t.element_size()
                   for t in (value._rs_data, value._rs_indices))
    t = _tensor(value)
    return t.numel() * t.element_size()


def _add(a, b):
    """Two values summed: row-sparse stays row-sparse (over the union of
    the rows), a dense operand makes the sum a dense tensor."""
    if isinstance(a, _sp.RowSparseNDArray) or \
            isinstance(b, _sp.RowSparseNDArray):
        s = _sp.elemwise_add(*(v if isinstance(v, _sp.RowSparseNDArray)
                               else NDArray(_tensor(v)) for v in (a, b)))
        return s if isinstance(s, _sp.RowSparseNDArray) else s._data
    return _tensor(a) + _tensor(b)


def _dense(merged):
    """A merge as a tensor (a sparse one densified)."""
    if isinstance(merged, _sp.BaseSparseNDArray):
        return merged.todense()._data
    return merged


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
        if kv_type not in _TYPES:
            raise MXNetError("unknown kvstore type %r" % kv_type)
        self.type = kv_type
        self._store = {}       # key -> tensor (the "server" copy)
        self._pending = {}     # key -> merged value awaiting a pull
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._is_dist = kv_type.startswith("dist")

    @property
    def rank(self):
        from .distributed import world
        return world()[1] if self._is_dist else 0

    @property
    def num_workers(self):
        from .distributed import world
        return world()[0] if self._is_dist else 1

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

    @staticmethod
    def _merge(value):
        """The sum of a pushed value or list of values: a tensor, or a
        ``RowSparseNDArray`` over the union of the rows when every
        operand is row-sparse."""
        if isinstance(value, (list, tuple)):
            merged = value[0]
            for v in value[1:]:
                merged = _add(merged, v)
            value = merged
        if isinstance(value, _sp.BaseSparseNDArray):
            return value
        return _tensor(value).detach()

    def _reduce(self, key, value):
        """:meth:`_merge`, compressed when compression is set (a dense
        merge only), then summed across the processes of a dist store
        (a sparse merge densified first)."""
        merged = self._merge(value)
        sparse = isinstance(merged, _sp.BaseSparseNDArray)
        if not sparse and self._compression is not None:
            merged = self._compression.compress_decompress(key, merged)
        if self._is_dist:
            merged = _dense(merged)
            from .distributed import host_allreduce, world
            if world()[0] > 1:
                merged = host_allreduce(merged)
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
        if _telemetry._ENABLED:
            _telemetry.hooks.kv_op("push", _value_nbytes(value))
        merged = self._reduce(key, value)
        if self._updater is not None:
            self._updater(key, merged, stored)
        elif key not in self._pending:
            self._pending[key] = merged
        else:
            self._pending[key] = _add(self._pending[key], merged)

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
        if _telemetry._ENABLED:
            _telemetry.hooks.kv_op("pull", _value_nbytes(stored))
        src = stored
        if self._updater is None and key in self._pending:
            src = _dense(self._pending.pop(key))
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
        t0 = time.perf_counter() if _telemetry._ENABLED else None
        if self._updater is not None:
            result = self._stored(key)
            self._updater(key, self._reduce(key, value), result)
        else:
            result = _dense(self._reduce(key, value))
        if t0 is not None:
            _telemetry.hooks.kv_op("pushpull", _value_nbytes(value),
                                   time.perf_counter() - t0)
        if out is not None:
            self._write(out, result)
        return out

    @torch.no_grad()
    def pushpull_bucket(self, keys, values, outs, priority=0):
        """Fused push and pull over a LIST of keys: each key's values
        merge (and compress), then a dist store sums the whole list
        across the processes in ONE collective a dtype
        (:func:`~mxnet_tpu_torch.distributed.host_allreduce_bucketed`)
        and writes each result into its ``outs`` entry.  Telemetry
        records one ``kvstore.pushpull`` for the bucket.  With an
        optimizer set, each key goes through :meth:`pushpull`."""
        keys = [self._keyify(k) for k in keys]
        t0 = time.perf_counter() if _telemetry._ENABLED else None
        dense_idx, merged = [], []
        for j, (key, value) in enumerate(zip(keys, values)):
            if self._updater is not None:
                self.pushpull(key, value, outs[j], priority)
                continue
            m = _dense(self._merge(value))
            if self._compression is not None:
                m = self._compression.compress_decompress(key, m)
            dense_idx.append(j)
            merged.append(m)
        if not dense_idx:
            return outs
        if self._is_dist:
            from .distributed import host_allreduce_bucketed, world
            if world()[0] > 1:
                merged = host_allreduce_bucketed(merged)
        for j, res in zip(dense_idx, merged):
            self._write(outs[j], res)
        if t0 is not None:
            _telemetry.hooks.kv_op(
                "pushpull", sum(_value_nbytes(values[j])
                                for j in dense_idx),
                time.perf_counter() - t0)
        return outs

    @torch.no_grad()
    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows ``row_ids`` of the stored value (their ids
        deduplicated): ``out`` a ``RowSparseNDArray`` takes them
        sparsely, a dense ``out`` takes them at their rows with every
        other row zero, and with ``out=None`` a ``RowSparseNDArray`` is
        returned.  Without ``row_ids`` this is :meth:`pull`."""
        key = self._keyify(key)
        full = self._stored(key)
        if row_ids is None:
            return self.pull(key, out, priority)
        ids = row_ids._data if isinstance(row_ids, NDArray) else row_ids
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
            else np.asarray(ids)
        rows = torch.from_numpy(np.unique(ids.astype(np.int32))) \
            .to(full.device)
        picked = full[rows.long()]
        if _telemetry._ENABLED:
            _telemetry.hooks.kv_op("pull", picked.numel()
                                   * picked.element_size())
        if out is None:
            return _sp.RowSparseNDArray(picked, rows, full.shape,
                                        full.dtype,
                                        Context.of_tensor(full))
        outs = out if isinstance(out, (list, tuple)) else [out]
        for o in outs:
            if isinstance(o, _sp.RowSparseNDArray):
                o._rs_data = picked.to(o._rs_data.device)
                o._rs_indices = rows.to(o._rs_indices.device)
            else:
                t = _tensor(o)
                t.zero_()
                t.index_copy_(0, rows.long().to(t.device),
                              picked.to(t.device, t.dtype))
        return out

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
        """An attributed rendezvous of every process of a dist store
        (:func:`~mxnet_tpu_torch.distributed.barrier`); nothing to wait
        for in one process."""
        if self._is_dist:
            from .distributed import barrier
            barrier("kvstore_barrier")


def create(name="local"):
    """Reference: ``kvstore.create``; accepted types: local, device,
    nccl, dist_sync, dist_device_sync, dist_async, dist, horovod."""
    if name not in _TYPES:
        raise MXNetError("unknown kvstore type %r" % name)
    return KVStore(name)
