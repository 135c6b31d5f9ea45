"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`.  No
PyTorch header is included, so a build takes seconds.  Libraries land
in ``build/torch_kernels/`` beside the package, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  The first call builds every source, one ``nvcc`` each,
all started together.  A failing ``nvcc`` raises with its output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["NVCC_FLAGS", "build_all", "built", "library_names", "load",
           "sources"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
_lock = threading.Lock()
_libs = {}


def sources():
    """``{name: path}`` of every kernel source in ``csrc/``."""
    return {p.stem: p for p in sorted(_CSRC.glob("*.cu"))}


def library_names():
    """The file name of each kernel library, as :func:`build_all` names
    it (a hash of the source, its headers and the flags): what a serving
    fingerprint records of the kernels.  Reads no compiler and builds
    nothing."""
    return sorted(_target(src).name for src in sources().values())


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                     "the port's CUDA kernels build from source at first "
                     "use")


def _target(src):
    h = hashlib.sha256(src.read_bytes())
    for inc in sorted(_CSRC.glob("*.cuh")):
        h.update(inc.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _OUT / ("lib%s-%s.so" % (src.stem, h.hexdigest()[:16]))


def build_all():
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: library path}``."""
    with _lock:
        targets = {name: _target(src) for name, src in sources().items()}
        todo = {n: t for n, t in targets.items() if not t.exists()}
        if todo:
            _OUT.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, target in todo.items():
                tmp = target.with_suffix(".%d.tmp" % os.getpid())
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                       str(sources()[name])]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append("%s: nvcc exit %d\n%s"
                                  % (name, proc.returncode, out))
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, todo[name])
            if failed:
                raise MXNetError("CUDA kernel build failed:\n"
                                 + "\n".join(failed))
        return targets


def built():
    """Whether every kernel library is built and loads; starts no
    ``nvcc`` (the ``KERNELS`` row of ``mx.runtime.Features``)."""
    for name, src in sources().items():
        if name in _libs:
            continue
        target = _target(src)
        if not target.exists():
            return False
        try:
            ctypes.CDLL(str(target))
        except OSError:
            return False
    return True


def load(name):
    """The loaded :class:`ctypes.CDLL` of kernel source ``name``, built
    first if needed."""
    lib = _libs.get(name)
    if lib is None:
        targets = build_all()
        if name not in targets:
            raise MXNetError("no kernel source csrc/%s.cu" % name)
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(targets[name]))
    return lib
