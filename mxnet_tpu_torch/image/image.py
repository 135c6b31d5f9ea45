"""Image IO and the legacy ``ImageIter`` (counterpart of
``mxnet_tpu/image/image.py``).

Decoding is OpenCV first, then PIL, on the host in numpy, as in the JAX
package -- no per-image device round-trips -- and ``ImageIter`` fans
the decode and augment work over a thread pool (cv2 releases the GIL in
the codec) or a process pool.  The augmenters draw from numpy's global
``np.random`` state, so under one ``np.random.seed`` and
``preprocess_threads=0`` the two packages give the same batches bit for
bit.  ``next_np(out=)`` fills a caller's buffer in place: the device
feed (:mod:`..dataio`) hands it a pinned host slot.  NDArrays made here
(``imread``, ``imdecode``, ``imresize``, ``ImageIter.next``) land on
the current context, the card unless a ``with mx.cpu():`` scope says
otherwise; augmenters keep an NDArray input's context.
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray, array

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover - cv2 is in the image
    _cv2 = None

# magic bytes of the codecs imdecode handles
_IMG_SIGNATURES = (b"\xff\xd8\xff",            # JPEG
                   b"\x89PNG\r\n\x1a\n",       # PNG
                   b"BM",                        # BMP
                   b"GIF8",                      # GIF
                   b"RIFF")                      # WebP


def _looks_compressed(payload):
    return any(payload[:len(m)] == m for m in _IMG_SIGNATURES)


def _decode_np(buf, flag=1):
    """bytes -> HWC uint8 RGB (or L) numpy array, fastest available codec."""
    if _cv2 is not None:
        a = _cv2.imdecode(np.frombuffer(buf, np.uint8),
                          _cv2.IMREAD_COLOR if flag else
                          _cv2.IMREAD_GRAYSCALE)
        if a is not None:
            if flag:
                # BGR -> RGB as a zero-copy stride flip: the later
                # transpose+cast pass materializes it, saving cvtColor's
                # full-image pass
                a = a[:, :, ::-1]
            else:
                a = a[:, :, None]
            return a
    from PIL import Image
    pil = Image.open(io.BytesIO(buf)).convert("RGB" if flag else "L")
    a = np.asarray(pil)
    if a.ndim == 2:
        a = a[:, :, None]
    return a


def _resize_np(a, w, h, interp=1):
    """HWC numpy resize on the host (no device round-trip)."""
    if _cv2 is not None:
        out = _cv2.resize(a, (w, h),
                          interpolation=_cv2.INTER_LINEAR if interp
                          else _cv2.INTER_NEAREST)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    from PIL import Image
    mode = Image.BILINEAR if interp else Image.NEAREST
    chans = []
    for c in range(a.shape[2]):
        chans.append(np.asarray(
            Image.fromarray(a[:, :, c]).resize((w, h), mode)))
    return np.stack(chans, axis=2)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file to an HWC uint8 NDArray (reference: ``imread``)."""
    with open(filename, "rb") as f:
        return array(_decode_np(f.read(), flag))


def imdecode(buf, flag=1, to_rgb=True):
    """Decode a compressed image buffer (reference: ``imdecode``)."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    return array(_decode_np(bytes(buf), flag))


def imresize(src, w, h, interp=1):
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    if a.dtype == np.uint8:
        return array(_resize_np(a, w, h, interp))
    out = _resize_np(a.astype(np.float32), w, h, interp)
    return array(out)


def _as_np(src):
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _like(src, a):
    """Return ``a`` as the same container type as ``src`` (numpy stays
    numpy -- the ImageIter hot path never touches the device; an
    NDArray stays on its context)."""
    return array(a, ctx=src.context) if isinstance(src, NDArray) else a


class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size

    def __call__(self, src):
        a = _as_np(src)
        h, w = a.shape[:2]
        if min(h, w) == self.size:
            return src
        if h > w:
            new_w, new_h = self.size, int(h * self.size / w)
        else:
            new_w, new_h = int(w * self.size / h), self.size
        return _like(src, _resize_np(a, new_w, new_h))


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)

    def __call__(self, src):
        a = _as_np(src)
        w, h = self.size
        y0 = max((a.shape[0] - h) // 2, 0)
        x0 = max((a.shape[1] - w) // 2, 0)
        out = a[y0:y0 + h, x0:x0 + w]
        if out.shape[:2] != (h, w):
            out = _resize_np(out, w, h)
        return _like(src, out)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)

    def __call__(self, src):
        a = _as_np(src)
        w, h = self.size
        y0 = np.random.randint(0, max(a.shape[0] - h, 0) + 1)
        x0 = np.random.randint(0, max(a.shape[1] - w, 0) + 1)
        out = a[y0:y0 + h, x0:x0 + w]
        if out.shape[:2] != (h, w):
            out = _resize_np(out, w, h)
        return _like(src, out)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return _like(src, np.ascontiguousarray(_as_np(src)[:, ::-1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        self.typ = typ

    def __call__(self, src):
        if isinstance(src, NDArray):
            return src.astype(self.typ)
        return np.asarray(src).astype(self.typ)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, src):
        a = _as_np(src).astype(np.float32)
        if self.brightness:
            a *= 1.0 + np.random.uniform(-self.brightness, self.brightness)
        if self.contrast:
            f = 1.0 + np.random.uniform(-self.contrast, self.contrast)
            a = (a - a.mean()) * f + a.mean()
        if self.saturation:
            f = 1.0 + np.random.uniform(-self.saturation, self.saturation)
            gray = a.mean(axis=2, keepdims=True)
            a = gray + (a - gray) * f
        return _like(src, np.clip(a, 0, 255).astype(np.float32))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference: ``CreateAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    auglist.append(CastAug())
    return auglist


def _process_record_np(rec, data_shape, auglist, final_dtype, dst=None):
    """One raw record (bytes) -> (CHW array, label): standalone so both
    the thread pool and the process pool can run it.  With ``dst`` the
    result is written (cast fused with the copy -- one memory pass)
    into the given CHW buffer row and ``dst`` is returned."""
    from ..recordio import _unpack_view
    header, payload = _unpack_view(rec)   # zero-copy payload view
    label = header.label
    c, h, w = data_shape
    img = None
    if len(payload) == c * h * w:
        # raw (already-decoded) record: the im2rec --encoding .raw fast
        # path.  Raw records carry no shape metadata -- data_shape IS
        # the contract.  A payload that length-matches but starts with a
        # codec signature is decoded instead; if that decode fails (raw
        # pixels colliding with a 2-byte magic) it falls back to the
        # raw reshape rather than aborting the epoch.
        if not _looks_compressed(payload):
            img = np.frombuffer(payload, np.uint8).reshape(h, w, c)
        else:
            try:
                img = _decode_np(payload, 1 if c == 3 else 0)
            except Exception:
                img = np.frombuffer(payload, np.uint8).reshape(h, w, c)
    else:
        img = _decode_np(payload, 1 if c == 3 else 0)
    for aug in auglist:
        img = aug(img)               # numpy in -> numpy out (host-side)
    a = _as_np(img)
    if a.ndim == 3:
        a = a.transpose(2, 0, 1)
    if dst is not None:
        np.copyto(dst, a, casting="unsafe")
        return dst, label
    if final_dtype is not None:
        a = a.astype(final_dtype, copy=False)
    return a, label


# -- process-pool decode workers (reference: ImageRecordIOParser2's
# C++ decode threads; here real processes so numpy augmenters scale
# past the GIL, with a SharedMemory output slab as the cpu_shared
# handoff) --------------------------------------------------------------

_POOL_STATE = {}


def _pool_worker_init(idx_path, rec_path, shm_name, slab_shape, slab_dtype,
                      auglist, data_shape, final_dtype):
    from multiprocessing import shared_memory
    from ..recordio import MXIndexedRecordIO
    np.random.seed((os.getpid() * 2654435761) % (2 ** 31))
    shm = shared_memory.SharedMemory(name=shm_name)
    _POOL_STATE["shm"] = shm
    _POOL_STATE["slab"] = np.ndarray(slab_shape, dtype=slab_dtype,
                                     buffer=shm.buf)
    _POOL_STATE["rec"] = MXIndexedRecordIO(idx_path, rec_path, "r")
    _POOL_STATE["args"] = (data_shape, auglist, final_dtype)


def _pool_process_chunk(task):
    offs, keys = task
    data_shape, auglist, final_dtype = _POOL_STATE["args"]
    rec = _POOL_STATE["rec"]
    slab = _POOL_STATE["slab"]
    labels = []
    for o, k in zip(offs, keys):
        _, label = _process_record_np(rec.read_idx(k), data_shape,
                                      auglist, final_dtype, dst=slab[o])
        labels.append(float(np.atleast_1d(np.asarray(label))[0]))
    return offs, labels


class ImageIter:
    """Legacy image iterator over .rec or .lst (reference: ``ImageIter``).

    Yields ``DataBatch``-like objects with CHW float data; sharding via
    num_parts/part_index as the reference's distributed input contract.

    ``preprocess_threads`` fans decode+augment over threads (cv2
    releases the GIL in the codec); ``preprocess_procs`` > 0 instead
    uses a forkserver-based PROCESS pool with a SharedMemory output
    slab -- the numpy augmenters scale past the GIL, the decoded batch
    crosses processes without pickling (the reference's cpu_shared
    storage analog, ``cpu_shared_storage_manager.h``).
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", aug_list=None,
                 shuffle=False, num_parts=1, part_index=0, label_width=1,
                 preprocess_threads=4, preprocess_procs=0,
                 dtype="float32", **kwargs):
        from ..recordio import MXIndexedRecordIO
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self.shuffle = shuffle
        self.dtype = np.dtype(dtype)
        # an explicit CastAug in a user-supplied aug_list wins over the
        # dtype parameter; for the default list the dtype parameter wins
        # and the CastAug is dropped entirely -- the cast happens fused
        # with the copy into the batch buffer (one memory pass, not two)
        if aug_list is None:
            self.auglist = [a for a in self.auglist
                            if not isinstance(a, CastAug)]
            self._final_dtype = self.dtype
        else:
            self._final_dtype = None if any(
                isinstance(a, CastAug) for a in self.auglist) \
                else self.dtype
        # dtype of the assembled batch buffer
        self._batch_dtype = self._final_dtype
        if self._batch_dtype is None:
            self._batch_dtype = np.dtype("float32")
            for a in self.auglist:
                if isinstance(a, CastAug):
                    self._batch_dtype = np.dtype(a.typ)
        self._pool = None
        self._proc_pool = None
        self._shm = None
        self._main_file_restore = None
        self._n_procs = int(preprocess_procs or 0)
        if self._n_procs == 0 and preprocess_threads and \
                preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(preprocess_threads)
        self._rec = None
        self._imglist = None
        if path_imgrec:
            idx_path = path_imgrec[:path_imgrec.rindex(".")] + ".idx"
            self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
            keys = list(self._rec.keys)
        elif path_imglist:
            self._imglist = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    self._imglist.append(
                        (float(parts[1]), os.path.join(path_root, parts[-1])))
            keys = list(range(len(self._imglist)))
        else:
            raise MXNetError("need path_imgrec or path_imglist")
        # distributed sharding (reference: num_parts/part_index kwargs)
        self._keys = keys[part_index::num_parts]
        if self._n_procs > 0:
            if self._rec is None:
                raise MXNetError(
                    "preprocess_procs needs path_imgrec (each worker "
                    "process opens its own record reader)")
            self._start_proc_pool(path_imgrec)
        self.reset()

    def _start_proc_pool(self, path_imgrec):
        import multiprocessing as mp
        from multiprocessing import shared_memory
        slab_dtype = self._batch_dtype
        slab_shape = (self.batch_size,) + self.data_shape
        self._slab_dtype = slab_dtype
        self._shm = shared_memory.SharedMemory(
            create=True,
            size=int(np.prod(slab_shape)) * slab_dtype.itemsize)
        self._slab = np.ndarray(slab_shape, dtype=slab_dtype,
                                buffer=self._shm.buf)
        idx_path = path_imgrec[:path_imgrec.rindex(".")] + ".idx"
        # forkserver: workers fork from a CLEAN server process (itself
        # launched by exec), never from this process -- forking a
        # process that holds a CUDA context or torch's thread pools is
        # deadlock-prone.  The workers import this module (and so the
        # port and torch, never JAX) and reattach the slab by name.
        # The initargs (augmenter list included) travel by pickle, which
        # they support.
        try:
            ctx = mp.get_context("forkserver")
        except ValueError:  # pragma: no cover - non-POSIX fallback
            ctx = mp.get_context("spawn")
        # forkserver/spawn workers re-execute __main__ when it has a
        # __file__; a parent launched from stdin or a notebook cell has
        # the bogus path '<stdin>', which makes every worker crash on
        # import and the pool respawn forever (a hang, not an error).
        # The workers only need _pool_worker_init from THIS importable
        # module, so drop the unloadable __file__ for the POOL'S
        # LIFETIME -- the Pool's maintenance thread respawns dead
        # workers later, so the attr must stay gone while the pool
        # lives -- and restore it in close() once terminate()+join()
        # make respawns impossible: mutating __main__ forever would be a
        # process-global side effect other tooling could observe.
        import sys as _sys
        main_mod = _sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        if main_file is not None and not os.path.exists(main_file):
            del main_mod.__file__
            self._main_file_restore = (main_mod, main_file)
        self._proc_pool = ctx.Pool(
            self._n_procs, initializer=_pool_worker_init,
            initargs=(idx_path, path_imgrec, self._shm.name,
                      slab_shape, slab_dtype, self.auglist,
                      self.data_shape, self._final_dtype))

    def reset(self):
        self._order = np.random.permutation(len(self._keys)) if self.shuffle \
            else np.arange(len(self._keys))
        self._cursor = 0

    def close(self):
        """Release the record reader, decode pools, and shared slab."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
            self._proc_pool = None
        if self._main_file_restore is not None:
            # the pool is dead (terminate+join above): no maintenance
            # thread can respawn a worker, so the spawn workaround ends
            # here and __main__ goes back exactly as found
            mod, path = self._main_file_restore
            if not hasattr(mod, "__file__"):
                mod.__file__ = path
            self._main_file_restore = None
        if self._shm is not None:
            self._slab = None
            try:
                self._shm.close()
                self._shm.unlink()
            except (FileNotFoundError, OSError):
                pass
            self._shm = None
        if self._rec is not None:
            self._rec.close()
            self._rec = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _process_record(self, rec):
        """One raw record (bytes) -> (CHW float array, label).  Pure
        host-side work: safe to fan out over the thread pool."""
        return _process_record_np(rec, self.data_shape, self.auglist,
                                  self._final_dtype)

    def _process_file(self, key):
        label, path = self._imglist[self._keys[key]]
        with open(path, "rb") as f:
            img = _decode_np(f.read(), 1)
        return self._augment(img), label

    def _augment(self, img):
        for aug in self.auglist:
            img = aug(img)           # numpy in -> numpy out (host-side)
        a = _as_np(img)
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        if self._final_dtype is not None:
            a = a.astype(self._final_dtype, copy=False)
        return a

    def _read_one(self, key):
        if self._rec is not None:
            return self._process_record(self._rec.read_idx(self._keys[key]))
        return self._process_file(key)

    def __iter__(self):
        return self

    def next_np(self, out=None):
        """One batch as host numpy ``(data, labels, pad)`` -- the zero
        device-round-trip path the ImageRecordIter pipeline uses.

        ``out``: optional preallocated (batch, C, H, W) array filled in
        place (the device feed passes a pinned staging slot, so the batch
        is assembled where the copy to the card reads it)."""
        if self._cursor >= len(self._keys):
            raise StopIteration
        # final partial batch is padded by wrapping to the start
        # (reference behavior: batch.pad records the overhang)
        pad = max(0, self._cursor + self.batch_size - len(self._keys))
        idxs = [self._order[(self._cursor + i) % len(self._keys)]
                for i in range(self.batch_size)]
        if self._proc_pool is not None:
            # process-pool mode: each worker reads its keys from its own
            # reader and writes decoded images straight into the shared
            # slab -- no record or image bytes cross a process boundary
            keys = [self._keys[k] for k in idxs]
            nchunks = min(self._n_procs, len(keys))
            tasks = []
            for ci in range(nchunks):
                offs = list(range(ci, len(keys), nchunks))
                tasks.append((offs, [keys[o] for o in offs]))
            labels = np.empty(self.batch_size, np.float32)
            for offs, ls in self._proc_pool.map(_pool_process_chunk,
                                                tasks):
                for o, l in zip(offs, ls):
                    labels[o] = l
            self._cursor += self.batch_size
            if out is not None:
                np.copyto(out, self._slab)
                return out, labels, pad
            return self._slab.copy(), labels, pad
        # decode+augment writes straight into the batch buffer (cast
        # fused with the copy) -- no per-image float temporaries, no
        # np.stack pass
        buf = out if out is not None else np.empty(
            (self.batch_size,) + self.data_shape, self._batch_dtype)
        if self._rec is not None:
            # one thread-pooled native batch read of the record bytes
            # (the shared reader handle is NOT safe for concurrent
            # read_idx), then parallel decode+augment over the buffers
            recs = self._rec.read_batch([self._keys[k] for k in idxs])

            def fill_rec(i):
                _, label = _process_record_np(
                    recs[i], self.data_shape, self.auglist,
                    self._final_dtype, dst=buf[i])
                return label
            if self._pool is not None:
                results = list(self._pool.map(fill_rec,
                                              range(len(recs))))
            else:
                results = [fill_rec(i) for i in range(len(recs))]
        else:
            def fill_file(args):
                i, key = args
                a, label = self._process_file(key)
                np.copyto(buf[i], a, casting="unsafe")
                return label
            if self._pool is not None:
                results = list(self._pool.map(fill_file,
                                              enumerate(idxs)))
            else:
                results = [fill_file(x) for x in enumerate(idxs)]
        labels = np.asarray(
            [np.atleast_1d(np.asarray(l, np.float32))[0]
             for l in results], np.float32)
        self._cursor += self.batch_size
        return buf, labels, pad

    def __next__(self):
        data, labels, pad = self.next_np()
        from ..io import DataBatch
        return DataBatch(data=[array(data)], label=[array(labels)],
                         pad=pad)

    next = __next__

    def device_feed(self, ctx=None, mesh=None, sharding=None,
                    transform=None, depth=None, compact=None):
        """Wrap this iterator in a :class:`~..dataio.DeviceFeed`: decoded
        batches are assembled by ``next_np`` straight into the feed's
        pinned host slots (in this iter's dtype -- construct with
        ``dtype='uint8'`` for compact staging) and a background thread
        overlaps the asynchronous copy to the card with the consumer's
        compute."""
        from ..dataio import DeviceFeed
        return DeviceFeed(self, ctx=ctx, mesh=mesh, sharding=sharding,
                          transform=transform, depth=depth,
                          compact=compact)
