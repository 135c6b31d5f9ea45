"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``;
reference ``python/mxnet/runtime.py :: Features`` over
``src/libinfo.cc``).

The port reports the JAX package's 26 feature names, each with the
port's own truth: ``CUDA``, ``CUDNN`` and ``GPU`` from torch; ``TPU``,
``XLA``, ``PALLAS`` and ``MKLDNN`` false; ``KERNELS`` whether the hand
kernels are built and load (``build/torch_kernels/``) and
``NATIVE_RECORDIO`` whether the native recordio engine is
(``build/torch_native/``), neither probe starting a compiler.  The live
rows (``TELEMETRY``, ``TSAN``, ``PROFILING``, ``CHAOS``, ``NUMERICS``,
``MEMORY_WATCH``, ``OBS_TRACE``, ``OBS_GOODPUT``, ``FLEET``) read the
live state of the port's subsystems; ``SHARD_CHECK`` whether
``MXNET_TPU_SHARD_CHECK`` armed the sharding sanitizer's collective
contract (:mod:`.analysis.sharding`).
"""
from __future__ import annotations

from collections import namedtuple

__all__ = ["Feature", "Features", "env_vars", "feature_list"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _detect():
    import torch

    from . import _build, _native, chaos, obs, profiling, sync, telemetry
    from .analysis import memory, numerics, sharding
    from .obs import fleet

    feats = {
        "TPU": False,
        "GPU": torch.cuda.is_available(),
        "CPU": True,
        "CUDA": torch.version.cuda is not None,
        "CUDNN": torch.backends.cudnn.is_available(),
        "MKLDNN": False,
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,     # preemption.install()
        "NATIVE_RECORDIO": _native.available(),
        "DIST_KVSTORE": True,       # the dist_* kvstores over gloo
        "OPENMP": torch.backends.openmp.is_available(),
        "F16C": True,
        "TELEMETRY": telemetry.enabled(),
        "TSAN": sync.tsan_enabled(),
        "PROFILING": profiling.enabled(),
        "SHARD_CHECK": sharding.shard_check_enabled(),
        "KERNELS": _build.built(),
        "CHAOS": chaos.armed(),
        "NUMERICS": numerics.check_enabled(),
        "MEMORY_WATCH": memory.watch_enabled(),
        "OBS_TRACE": obs.tracing_enabled(),
        "OBS_GOODPUT": obs.goodput_enabled(),
        "FLEET": fleet.active(),
    }
    return {k: Feature(k, bool(v)) for k, v in feats.items()}


class Features(dict):
    """Reference: ``mx.runtime.Features()`` -- mapping of feature name to
    ``Feature(name, enabled)`` with ``is_enabled``."""

    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("unknown feature %r" % feature_name)
        return self[feature_name].enabled

    def __repr__(self):
        return "[%s]" % ", ".join(
            "✔ %s" % k if v.enabled else "✖ %s" % k
            for k, v in sorted(self.items()))


def feature_list():
    """Reference: ``libinfo_features``."""
    return list(Features().values())


def env_vars():
    """Every registered ``MXNET_*`` variable with its current (typed)
    value, default and doc (:func:`mxnet_tpu_torch.env.describe`)."""
    from . import env as _env
    return _env.describe()
