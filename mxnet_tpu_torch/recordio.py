"""RecordIO, MXNet's packed-record file format (counterpart of
``mxnet_tpu/recordio.py``): ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack``/``unpack`` and ``pack_img``/``unpack_img`` over
the dmlc-core record framing:

    [kMagic u32][(cflag<<29)|length u32][payload][pad to 4B]

cflag: 0 = whole record, 1 = first chunk, 2 = middle, 3 = last -- records
larger than one chunk are split; magic is escaped inside payloads by
chunking.  ``.idx`` sidecar: "key\\toffset\\n" per record.

Every file written here is byte for byte the JAX package's, ``.rec``
and ``.idx``, raw and JPEG.  Reads and writes go through the native
engine (:mod:`._native`) when it builds, else through Python.
"""
from __future__ import annotations

import ctypes
import io
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

kMagic = 0xCED7230A
_HEADER_FMT = "<IfQQ"  # flag, label, id, id2
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])


def _native_lib():
    from ._native import load
    return load()


class MXRecordIO:
    """Sequential record reader/writer (reference: ``MXRecordIO``).

    IO runs through the C++ engine (``_native/recordio_native.cc`` --
    buffered framing, thread-pooled batch reads) when the native library
    is available, with a byte-identical pure-Python fallback.
    """

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self._nh = None          # native handle
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise MXNetError("invalid flag %r" % self.flag)
        lib = _native_lib()
        if lib is not None:
            h = lib.rio_open(self.uri.encode(), 1 if self.writable else 0)
            if not h:
                raise MXNetError("cannot open %r" % self.uri)
            self._nh = h
            self.record = True   # sentinel: "open"
            return
        self.record = open(self.uri, "wb" if self.writable else "rb")

    def close(self):
        if self._nh is not None:
            _native_lib().rio_close(self._nh)
            self._nh = None
            self.record = None
        elif self.record is not None:
            self.record.close()
            self.record = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        if self._nh is not None:
            # a buffered write may not be visible to ftell-reported file
            # offsets used by the .idx sidecar, so tell() is exact: the
            # native side tracks the logical position through the buffer
            return int(_native_lib().rio_tell(self._nh))
        return self.record.tell()

    _MAX_CHUNK = (1 << 29) - 1

    def _write_chunk(self, cflag, buf):
        self.record.write(struct.pack("<I", kMagic))
        self.record.write(struct.pack("<I", (cflag << 29) | len(buf)))
        self.record.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def write(self, buf):
        if not self.writable:
            raise MXNetError("not opened for writing")
        if self._nh is not None:
            if _native_lib().rio_write(self._nh, bytes(buf),
                                       len(buf)) != 0:
                raise MXNetError("recordio write failed")
            return
        # The length field is 29 bits; larger payloads split into
        # cflag 1 (first) / 2 (middle) / 3 (last) chunks, matching the
        # dmlc recordio framing, so the reader never desynchronizes.
        if len(buf) <= self._MAX_CHUNK:
            self._write_chunk(0, buf)
            return
        chunks = [buf[i:i + self._MAX_CHUNK]
                  for i in range(0, len(buf), self._MAX_CHUNK)]
        for i, chunk in enumerate(chunks):
            cflag = 1 if i == 0 else (3 if i == len(chunks) - 1 else 2)
            self._write_chunk(cflag, chunk)

    def read(self):
        if self.writable:
            raise MXNetError("not opened for reading")
        if self._nh is not None:
            lib = _native_lib()
            out = ctypes.c_void_p()
            n = lib.rio_read(self._nh, ctypes.byref(out))
            if n == -1:
                return None
            if n < 0:
                raise MXNetError("corrupt recordio: bad frame")
            data = ctypes.string_at(out, n)
            lib.rio_free(out)
            return data
        data = b""
        while True:
            hdr = self.record.read(8)
            if len(hdr) < 8:
                if data:
                    # EOF in the middle of a multi-chunk record (chunks
                    # seen but no cflag-3 terminator): truncated file.
                    raise MXNetError(
                        "corrupt recordio: EOF inside a chunked record")
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != kMagic:
                raise MXNetError("corrupt recordio: bad magic 0x%x" % magic)
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            payload = self.record.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            data += payload
            if cflag in (0, 3):
                return data


class MXIndexedRecordIO(MXRecordIO):
    """Indexed random-access reader/writer (reference:
    ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        self.fidx = open(idx_path, "w") if flag == "w" else None

    def close(self):
        super().close()
        if getattr(self, "fidx", None) is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        if self._nh is not None:
            if _native_lib().rio_seek(self._nh, self.idx[idx]) != 0:
                raise MXNetError("seek failed for key %r" % (idx,))
            return
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def read_batch(self, keys, nthreads=4):
        """Read many records concurrently (reference: the threaded
        record loader in ``iter_image_recordio_2.cc``).

        The JAX package's routing: on a single-core host (or
        nthreads<=1) the buffered sequential Python reads, since the
        native path pays a per-record malloc+memcpy+ctypes round-trip;
        the native thread pool only on multicore hosts with several
        reader threads.
        """
        lib = _native_lib()
        if lib is None or self.writable or nthreads <= 1 \
                or (os.cpu_count() or 1) <= 1:
            return [self.read_idx(k) for k in keys]
        n = len(keys)
        offsets = (ctypes.c_long * n)(*[self.idx[k] for k in keys])
        bufs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_long * n)()
        rc = lib.rio_read_batch(self.uri.encode(), offsets, n, bufs, lens,
                                int(nthreads))
        # harvest/free EVERY allocated buffer before raising: an early
        # raise would leak the rest of the batch's native heap
        out, bad = [], None
        for i in range(n):
            if lens[i] < 0 or bufs[i] is None:
                if bad is None:
                    bad = keys[i]
                out.append(None)
            else:
                out.append(ctypes.string_at(bufs[i], lens[i]))
            if bufs[i]:
                lib.rio_free(bufs[i])
        if rc != 0:
            raise MXNetError("cannot open %r for batch read" % self.uri)
        if bad is not None:
            raise MXNetError("corrupt record at key %r" % (bad,))
        return out

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack a header + payload into a record string (reference: ``pack``)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_HEADER_FMT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        hdr = struct.pack(_HEADER_FMT, label.size, 0.0, header.id,
                          header.id2) + label.tobytes()
    return hdr + s


def unpack(s):
    """Unpack a record into (IRHeader, payload) (reference: ``unpack``)."""
    header, view = _unpack_view(s)
    return header, bytes(view)


def _unpack_view(s):
    """``unpack`` returning the payload as a zero-copy memoryview.

    The hot decode paths use this: for raw-pixel records the public
    ``unpack``'s payload slice would copy the whole image (150,528 B at
    224x224x3) per record.  The view aliases ``s`` -- callers must not
    outlive it.
    """
    flag, label, id_, id2 = struct.unpack_from(_HEADER_FMT, s, 0)
    view = memoryview(s)[_HEADER_SIZE:]
    if flag > 0:
        # copy the (tiny) label floats: callers retain labels long
        # after the record, and a zero-copy label would pin the whole
        # record's bytes alive per sample
        label = np.frombuffer(bytes(view[:flag * 4]), np.float32)
        view = view[flag * 4:]
    return IRHeader(flag, label, id_, id2), view


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image array into a record (reference: ``pack_img``)."""
    from PIL import Image
    buf = io.BytesIO()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        pil = Image.fromarray(arr, "L")
    else:
        pil = Image.fromarray(arr[:, :, :3], "RGB")
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kw = {"quality": quality} if fmt == "JPEG" else {}
    pil.save(buf, fmt, **kw)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=1):
    """Decode a record into (IRHeader, HWC uint8 image array)."""
    from .image.image import _decode_np
    header, img_bytes = unpack(s)
    arr = _decode_np(bytes(img_bytes), iscolor)
    if arr.shape[2] == 1 and iscolor:
        arr = np.repeat(arr, 3, axis=2)
    return header, arr
