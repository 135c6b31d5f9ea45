"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``)."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["ArrayDataset", "Dataset", "RecordFileDataset",
           "SimpleDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return _FilteredDataset(self, fn)

    def take(self, count):
        return _TakenDataset(self, count)

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _FilteredDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._indices = [i for i in range(len(data)) if fn(data[i])]

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class _TakenDataset(Dataset):
    def __init__(self, data, count):
        self._data = data
        self._count = min(count, len(data))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError(idx)
        return self._data[idx]


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
        self._data = list(args)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file: item ``i`` is the raw
    record bytes of the ``i``-th key of its ``.idx``."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = filename[:filename.rindex(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
