"""The native host runtimes (counterpart of ``mxnet_tpu/_native``),
compiled on first use.

- ``recordio_native.cc``: buffered record framing and a thread-pooled
  batch reader.  Without a toolchain, or after a failed build,
  :func:`load` returns None and :mod:`..recordio` reads and writes in
  Python, byte for byte the same files.  ``MXNET_TPU_NATIVE=0`` forces
  the Python route.
- ``predict_native.cc`` (with the C header ``mxnet_predict.h``): the C
  predict ABI, an ONNX interpreter for edge deploys with no Python
  (``MXPredCreate`` ... ``MXPredFree``, ``MXNDList*``).  It is a host
  runtime by design; :func:`load_predict` returns None without a
  toolchain, and ``predictor.NativePredictor`` then raises.

Both are host code with a plain C interface loaded through
:mod:`ctypes`, built with ``g++ -O2 -shared -fPIC`` into
``build/torch_native/`` of the checkout (or ``$MXNET_TPU_NATIVE_CACHE``),
under an flock and through an atomic rename, so that processes starting
together neither build one twice nor load a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from pathlib import Path

__all__ = ["available", "load", "load_predict", "predict_so_path",
           "so_path"]

_SRC = Path(__file__).resolve().parent / "recordio_native.cc"
_OUT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_LIB = None
_TRIED = False


def _cache_dir():
    d = Path(os.environ.get("MXNET_TPU_NATIVE_CACHE") or _OUT)
    d.mkdir(parents=True, exist_ok=True)
    return d


def so_path():
    """Where the library is built to."""
    return _cache_dir() / "librecordio_native.so"


def _current(so, src=_SRC):
    return so.exists() and so.stat().st_mtime >= src.stat().st_mtime


def _build(src, out):
    """Compile ``src`` to ``out`` under an flock, into a temporary file
    renamed into place."""
    import fcntl
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _current(out, src):  # another process built it meanwhile
                return
            tmp = "%s.%d.tmp" % (out, os.getpid())
            proc = subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 str(src), "-o", tmp], capture_output=True, text=True,
                timeout=120)
            if proc.returncode != 0:
                raise RuntimeError("native build failed:\n%s"
                                   % proc.stderr[-2000:])
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def available():
    """Whether a current library is built and loads; never compiles."""
    if _LIB is not None:
        return True
    if os.environ.get("MXNET_TPU_NATIVE", "1") == "0":
        return False
    so = so_path()
    if not _current(so):
        return False
    try:
        ctypes.CDLL(str(so))
        return True
    except OSError:
        return False


def load():
    """The loaded library, built first if needed; None when unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("MXNET_TPU_NATIVE", "1") == "0":
        return None
    try:
        so = so_path()
        if not _current(so):
            _build(_SRC, so)
        lib = ctypes.CDLL(str(so))
        lib.rio_open.restype = ctypes.c_void_p
        lib.rio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.rio_close.argtypes = [ctypes.c_void_p]
        lib.rio_tell.restype = ctypes.c_long
        lib.rio_tell.argtypes = [ctypes.c_void_p]
        lib.rio_seek.restype = ctypes.c_int
        lib.rio_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.rio_flush.restype = ctypes.c_int
        lib.rio_flush.argtypes = [ctypes.c_void_p]
        lib.rio_write.restype = ctypes.c_int
        lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long]
        # out-pointers are void*: a c_char_p would make ctypes copy to
        # bytes and lose the malloc'd pointer that rio_free must get
        lib.rio_read.restype = ctypes.c_long
        lib.rio_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_void_p)]
        lib.rio_free.argtypes = [ctypes.c_void_p]
        lib.rio_read_batch.restype = ctypes.c_int
        lib.rio_read_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int]
        _LIB = lib
    except Exception as e:  # no toolchain or a failed build: Python route
        warnings.warn("mxnet_tpu_torch native recordio unavailable (%s); "
                      "reading records in Python" % e)
        _LIB = None
    return _LIB


# ----------------------------------------------------------------------
# The C predict runtime (predict_native.cc; reference c_predict_api.cc)
# ----------------------------------------------------------------------

_PRED_SRC = Path(__file__).resolve().parent / "predict_native.cc"
_PRED_LIB = None
_PRED_TRIED = False


def predict_so_path():
    """Where the predict runtime is built to (for linking C programs
    against it, with ``mxnet_predict.h`` beside its source)."""
    return _cache_dir() / "libmxtpu_predict.so"


def load_predict():
    """The C predict runtime, built first if needed; None when there is
    no toolchain or the build fails."""
    global _PRED_LIB, _PRED_TRIED
    if _PRED_TRIED:
        return _PRED_LIB
    _PRED_TRIED = True
    if os.environ.get("MXNET_TPU_NATIVE", "1") == "0":
        return None
    try:
        so = predict_so_path()
        if not _current(so, _PRED_SRC):
            _build(_PRED_SRC, so)
        lib = ctypes.CDLL(str(so))
        lib.MXPredGetLastError.restype = ctypes.c_char_p
        lib.MXPredCreate.restype = ctypes.c_int
        lib.MXPredCreate.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_void_p)]
        lib.MXPredCreateFromFile.restype = ctypes.c_int
        lib.MXPredCreateFromFile.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.MXPredSetInput.restype = ctypes.c_int
        lib.MXPredSetInput.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.MXPredForward.restype = ctypes.c_int
        lib.MXPredForward.argtypes = [ctypes.c_void_p]
        lib.MXPredGetOutputShape.restype = ctypes.c_int
        lib.MXPredGetOutputShape.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int)]
        lib.MXPredGetOutput.restype = ctypes.c_int
        lib.MXPredGetOutput.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.MXPredFree.argtypes = [ctypes.c_void_p]
        _PRED_LIB = lib
    except Exception as e:  # no toolchain or a failed build
        warnings.warn("mxnet_tpu_torch native predict runtime "
                      "unavailable: %s" % e)
        _PRED_LIB = None
    return _PRED_LIB
