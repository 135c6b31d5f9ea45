"""Legacy data iterators (counterpart of ``mxnet_tpu/io/io.py``).

``ImageRecordIter`` has the JAX package's two routes.  On the host
route it wraps :class:`~..image.ImageIter` (decode and augment over a
thread pool) in a normalizing iterator behind a background prefetch
thread (``PrefetchingIter``); its batches are NDArrays on the current
context.  With ``ctx=`` it returns a :class:`~..dataio.DeviceFeed`: the
batch stays uint8 through decode, crop and mirror, lands on the card
through the feed's pinned ring, and the cast and mean/std
normalization run there (:class:`~..dataio.DeviceTransform`).
``mesh=``/``sharding=`` land each batch as this process's slice of the
global batch on the mesh's device (the feed's mesh route).
``num_parts``/``part_index`` shard the records as in the JAX package.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..context import scoped_context
from ..ndarray import NDArray, array

DataDesc = namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    """One batch (reference: ``DataBatch``)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (reference: ``DataIter``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        return self.next()

    def next(self):
        raise StopIteration

    @property
    def provide_data(self):
        return None

    @property
    def provide_label(self):
        return None


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: ``NDArrayIter``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name) if label is not None \
            else []
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.reset()

    @staticmethod
    def _init_data(data, default_name):
        if isinstance(data, (np.ndarray, NDArray)):
            data = [(default_name, data)]
        elif isinstance(data, dict):
            data = list(data.items())
        elif isinstance(data, (list, tuple)):
            data = [("%s_%d" % (default_name, i) if i else default_name, d)
                    for i, d in enumerate(data)]
        out = []
        for name, d in data:
            if isinstance(d, NDArray):
                d = d.asnumpy()
            out.append((name, np.asarray(d)))
        return out

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:])
                for n, d in self.data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:])
                for n, d in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        self.order = np.random.permutation(self.num_data) if self.shuffle \
            else np.arange(self.num_data)

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        idx = self.order[self.cursor:self.cursor + self.batch_size]
        pad = 0
        if len(idx) < self.batch_size:
            if self.last_batch_handle == "discard":
                raise StopIteration
            pad = self.batch_size - len(idx)
            idx = np.concatenate([idx, self.order[:pad]])
        data = [array(d[idx]) for _, d in self.data]
        label = [array(d[idx]) for _, d in self.label]
        return DataBatch(data=data, label=label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches per epoch
    (reference: ``ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class PrefetchingIter(DataIter):
    """Background-thread prefetch (reference: ``PrefetchingIter`` /
    dmlc ThreadedIter double-buffering).

    The producer closes over the *inner* iterator only and every put is
    stop-responsive, so a consumer that abandons iteration mid-epoch
    (GC without ``close()``) can never strand the thread parked on a
    full buffer -- the ``weakref.finalize`` stops it (the same
    discipline as :class:`~..dataio.DeviceFeed`)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter supports one inner iter here")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._depth = prefetch_depth
        self._queue = None
        self._thread = None
        self._finalizer = None
        self._start()

    def _start(self):
        self._queue = q = queue.Queue(self._depth)
        self._stop = stop = threading.Event()
        inner = self.iter
        # the batches land where the creator's thread would put them
        scope = scoped_context() or contextlib.nullcontext()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            while not stop.is_set():
                try:
                    with scope:
                        batch = inner.next()
                except StopIteration:
                    put(None)
                    return
                except Exception as e:       # re-raised at next()
                    put(e)
                    return
                if not put(batch):
                    return

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mxnet_tpu_torch.PrefetchingIter")
        from ..dataio.feed import _release_producer
        self._finalizer = weakref.finalize(self, _release_producer,
                                           q, stop)
        self._thread.start()

    def close(self):
        """Stop and join the producer; idempotent, safe mid-epoch."""
        if self._finalizer is not None:
            self._finalizer.detach()
        if self._stop is not None:
            self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=5)

    def reset(self):
        self.close()
        self.iter.reset()
        self._start()

    def next(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label


def MNISTIter(image=None, label=None, batch_size=128, shuffle=True,
              flat=False, **kwargs):
    """Reference: C++ ``iter_mnist.cc``; reads idx-ubyte files."""
    import gzip
    import struct as _struct

    def _read(img_path, lbl_path):
        op = gzip.open if img_path.endswith(".gz") else open
        with op(lbl_path, "rb") as f:
            _struct.unpack(">II", f.read(8))
            lbl = np.frombuffer(f.read(), np.uint8).astype(np.float32)
        with op(img_path, "rb") as f:
            _, n, h, w = _struct.unpack(">IIII", f.read(16))
            img = np.frombuffer(f.read(), np.uint8).reshape(n, 1, h, w)
        return img.astype(np.float32) / 255.0, lbl

    data, lbl = _read(image, label)
    if flat:
        data = data.reshape(len(data), -1)
    return NDArrayIter(data, lbl, batch_size, shuffle=shuffle)


def CSVIter(data_csv=None, data_shape=None, label_csv=None, label_shape=None,
            batch_size=128, **kwargs):
    """Reference: C++ ``iter_csv.cc``."""
    data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
    data = data.reshape((-1,) + tuple(data_shape))
    label = None
    if label_csv:
        label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
    return NDArrayIter(data, label, batch_size)


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=128,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                    num_parts=1, part_index=0, preprocess_threads=4,
                    resize=0, ctx=None, mesh=None, sharding=None,
                    feed_depth=None, dtype="float32", **kwargs):
    """High-throughput record iterator (reference:
    ``iter_image_recordio_2.cc :: ImageRecordIOParser2``); threaded
    decode + augment + prefetch.

    With ``ctx`` the pipeline returns a :class:`~..dataio.DeviceFeed`
    instead of a host prefetcher: decode+crop+mirror stay host-side on
    uint8, the batch ships compact to the card, and the cast and
    mean/std normalization run there after landing.  ``mesh=`` or
    ``sharding=`` land it on a mesh's device instead, each batch this
    process's slice of the global batch (:class:`~..dataio.DeviceFeed`)."""
    from ..image import CastAug, CreateAugmenter, ImageIter

    aug = CreateAugmenter(data_shape, resize=resize, rand_crop=rand_crop,
                          rand_mirror=rand_mirror)
    if ctx is not None or mesh is not None or sharding is not None:
        from ..dataio import DeviceFeed, DeviceTransform
        from ..dataio.feed import check_placement
        check_placement("ImageRecordIter", mesh, sharding)
        aug = [a for a in aug if not isinstance(a, CastAug)]
        inner = ImageIter(batch_size, data_shape, path_imgrec=path_imgrec,
                          aug_list=aug, shuffle=shuffle,
                          num_parts=num_parts, part_index=part_index,
                          preprocess_threads=preprocess_threads,
                          dtype="uint8")
        mean_seq = (mean_r, mean_g, mean_b)
        std_seq = (std_r or 1, std_g or 1, std_b or 1)
        transform = DeviceTransform(
            dtype=dtype,
            mean=mean_seq if any(mean_seq) else None,
            std=std_seq if any(s != 1 for s in std_seq) else None)
        return DeviceFeed(inner, ctx=ctx, mesh=mesh, sharding=sharding,
                          transform=transform, depth=feed_depth)
    inner = ImageIter(batch_size, data_shape, path_imgrec=path_imgrec,
                      aug_list=aug, shuffle=shuffle, num_parts=num_parts,
                      part_index=part_index,
                      preprocess_threads=preprocess_threads)

    mean = np.array([mean_r, mean_g, mean_b], np.float32).reshape(3, 1, 1)
    std = np.array([std_r or 1, std_g or 1, std_b or 1],
                   np.float32).reshape(3, 1, 1)

    class _NormIter(DataIter):
        def __init__(self):
            super().__init__(batch_size)

        def reset(self):
            inner.reset()

        def next(self):
            d, labels, pad = inner.next_np()
            if d.shape[1] == 3 and (mean.any() or (std != 1).any()):
                d = (d - mean) / std
            return DataBatch(data=[array(d)], label=[array(labels)],
                             pad=pad)

        @property
        def provide_data(self):
            return [DataDesc("data", (batch_size,) + tuple(data_shape))]

        @property
        def provide_label(self):
            return [DataDesc("softmax_label", (batch_size,))]

    return PrefetchingIter(_NormIter())
