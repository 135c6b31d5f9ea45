"""Random-number state (counterpart of ``mxnet_tpu/random.py``).

MXNet draws dropout masks and random initial values from one
process-wide seed.  The port keeps one :class:`torch.Generator` per
device, made from that seed at first use; :func:`seed` starts them all
again, in place, so a CUDA graph that registered a generator
(:mod:`mxnet_tpu_torch._capture`) keeps drawing from it.  The numbers
differ from the JAX package's for the same seed (another generator):
tests hand both the same inputs instead.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["generator", "seed"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_state = {"seed": _DEFAULT_SEED, "generators": {}}


def seed(seed_state, ctx="all"):
    """Re-seed every device's generator with ``seed_state`` (``ctx`` is
    the reference's; one seed drives every device here, as in the JAX
    package)."""
    with _lock:
        _state["seed"] = int(seed_state)
        for gen in _state["generators"].values():
            gen.manual_seed(_state["seed"])


def generator(device):
    """The generator of ``device`` (a ``torch.device`` or its name)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["generators"].get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_state["seed"])
            _state["generators"][device] = gen
        return gen
