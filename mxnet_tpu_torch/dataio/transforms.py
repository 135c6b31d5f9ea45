"""On-device batch transforms for the device feed (counterpart of
``mxnet_tpu/dataio/transforms.py``).

Batches cross from the host to the card in their compact dtype (a uint8
image batch is 4x smaller than its float32 cast); the expansion -- cast,
scale, mean/std normalization, random mirror, random crop -- runs on the
card after the batch lands.  The JAX package jits these stages into one
XLA program; here they are plain torch ops on the batch's device, in the
same order and each arithmetic stage in the target dtype, so a bf16
batch is cast first and then offset and divided in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..ndarray import NDArray
from ..ops.table import torch_dtype

__all__ = ["DeviceTransform"]


def _chan_const(v, ndim, chan_axis, dtype, device):
    """Broadcastable (1, C, 1, ...) constant from a scalar or per-channel
    sequence, in ``dtype`` on ``device``."""
    a = torch.as_tensor(np.asarray(v, np.float32), device=device)
    if a.ndim:
        shape = [1] * ndim
        shape[chan_axis] = a.shape[0]
        a = a.reshape(shape)
    return a.to(dtype)


class DeviceTransform:
    """Post-landing batch transform: ``transform(x, generator=None)``.

    Batches are NCHW (batch, channel, height, width) unless only the
    dtype/scale/normalize stages are used, which are layout-agnostic.
    Stage order: random crop -> random mirror (both on the compact
    dtype) -> cast -> scale -> mean -> std.

    ``generator`` is a ``torch.Generator`` on the batch's device (the
    port's generator of that device, :func:`..random.generator`, when
    None); only the random stages (``crop``, ``rand_mirror``) draw from
    it.  The JAX package's ``key`` has no torch counterpart, so those two
    stages draw other numbers than the JAX transform's for one seed.
    Nothing here reads the card from the host: the crop offsets stay on
    the device and select rows and columns by index.
    """

    def __init__(self, dtype="float32", scale=None, mean=None, std=None,
                 rand_mirror=False, crop=None, chan_axis=1):
        self.dtype = torch_dtype(dtype) if dtype is not None else None
        self.scale = scale
        self.rand_mirror = bool(rand_mirror)
        self.crop = (crop, crop) if isinstance(crop, int) else \
            (tuple(crop) if crop is not None else None)
        self._chan_axis = chan_axis
        self._mean = mean
        self._std = std

    def _apply(self, x, generator):
        if (self.crop is not None or self.rand_mirror) and generator is None:
            generator = _random.generator(x.device)
        if self.crop is not None:
            ch, cw = self.crop
            y0 = torch.randint(0, x.shape[-2] - ch + 1, (1,),
                               generator=generator, device=x.device)
            x0 = torch.randint(0, x.shape[-1] - cw + 1, (1,),
                               generator=generator, device=x.device)
            x = x.index_select(-2, y0 + torch.arange(ch, device=x.device))
            x = x.index_select(-1, x0 + torch.arange(cw, device=x.device))
        if self.rand_mirror:
            flip = torch.rand((x.shape[0],), generator=generator,
                              device=x.device) < 0.5
            flip = flip.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
            x = torch.where(flip, x.flip(-1), x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.scale is not None:
            x = x * torch.tensor(self.scale, dtype=x.dtype, device=x.device)
        if self._mean is not None:
            x = x - _chan_const(self._mean, x.ndim, self._chan_axis,
                                x.dtype, x.device)
        if self._std is not None:
            x = x / _chan_const(self._std, x.ndim, self._chan_axis,
                                x.dtype, x.device)
        return x

    def __call__(self, x, generator=None):
        if isinstance(x, NDArray):
            return NDArray(self._apply(x._data, generator))
        return self._apply(x, generator)
