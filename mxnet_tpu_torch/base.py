"""Base error type of the PyTorch/CUDA port (counterpart of
``mxnet_tpu/base.py :: MXNetError``)."""
from __future__ import annotations

__all__ = ["MXNetError", "check_call"]


class MXNetError(RuntimeError):
    """Framework error type: bad arguments, shapes or devices, and
    failures of a kernel launch, raised as native Python exceptions."""


def check_call(ret):
    """Compatibility no-op: the port has no flat C ABI to check."""
    return ret
