"""Device resolution (counterpart of ``mxnet_tpu/context.py``).

Every entry point of the port runs on the GPU unless its caller asks
for the CPU.  Without CUDA, and without that request, it raises: it
never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; ``"cpu"`` (or a CPU ``torch.device``) ->
    the CPU; any CUDA spelling -> that CUDA device.  Raises
    :class:`MXNetError` when CUDA is asked for, or defaulted to, and
    absent."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("unsupported device %r: the port runs on CUDA, "
                         "or on the CPU when asked" % (device,))
    if not torch.cuda.is_available():
        raise MXNetError("CUDA is not available; pass device='cpu' to "
                         "run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
