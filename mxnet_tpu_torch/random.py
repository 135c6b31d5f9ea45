"""Random-number state (counterpart of ``mxnet_tpu/random.py``).

MXNet draws dropout masks and random initial values from one
process-wide seed.  The port keeps one :class:`torch.Generator` per
device, made from that seed at first use; :func:`seed` starts them all
again, in place, so a CUDA graph that registered a generator
(:mod:`mxnet_tpu_torch._capture`) keeps drawing from it.  The numbers
differ from the JAX package's for the same seed (another generator):
tests hand both the same inputs instead.  Inside :func:`drawing_from`
the draws of the calling thread come from a generator its caller gave
(``HybridBlock.functionalize``'s ``rng``, where the JAX package threads
a key).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["drawing_from", "generator", "seed"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_state = {"seed": _DEFAULT_SEED, "generators": {}}
_local = threading.local()


@contextlib.contextmanager
def drawing_from(gen):
    """Within the scope, in this thread, :func:`generator` returns
    ``gen`` (a ``torch.Generator``); ``None`` leaves the devices' own
    generators in force."""
    prev = getattr(_local, "gen", None)
    _local.gen = gen
    try:
        yield
    finally:
        _local.gen = prev


def seed(seed_state, ctx="all"):
    """Re-seed every device's generator with ``seed_state`` (``ctx`` is
    the reference's; one seed drives every device here, as in the JAX
    package)."""
    with _lock:
        _state["seed"] = int(seed_state)
        for gen in _state["generators"].values():
            gen.manual_seed(_state["seed"])


def generator(device):
    """The generator of ``device`` (a ``torch.device`` or its name), or
    the one :func:`drawing_from` put in force (a draw on another device
    than that generator's raises in PyTorch)."""
    given = getattr(_local, "gen", None)
    if given is not None:
        return given
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
