"""Carry a parameter dict across from the JAX package.

:func:`params_from_numpy` takes the dict that the JAX
``TinyGPT.init_params`` (or a checkpoint) gives, as numpy arrays
(``{k: np.asarray(v)}``), and returns the port's dict: the same names
and the same layouts (``wqkv`` stays ``(units, 3*units)`` and is used as
``x @ w``), so both packages run on identical weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ...context import resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(params, device=None, dtype=None):
    """``{name: array}`` -> ``{name: tensor on device}``, each a fresh
    tensor (never the caller's own); ``dtype`` casts every tensor when
    given, else each keeps its own."""
    dev = resolve_device(device)
    out = {}
    for name, value in params.items():
        if isinstance(value, torch.Tensor):
            out[name] = value.detach().to(device=dev,
                                          dtype=dtype or value.dtype,
                                          copy=True)
        else:
            t = torch.from_numpy(np.array(value, copy=True))
            out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out
