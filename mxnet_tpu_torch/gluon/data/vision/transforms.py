"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): ``Compose``,
``ToTensor``, ``Normalize`` and ``Cast``, on HWC images in host memory;
their outputs are on ``mx.cpu()``.  The random augmentations and the
resizing transforms wait for the port of ``image/``."""
from __future__ import annotations

import numpy as np

from ....context import cpu
from ....ndarray import NDArray, array
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Cast", "Compose", "Normalize", "ToTensor"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class ToTensor(Block):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1]."""

    def forward(self, x):
        a = _to_np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return array(a, ctx=cpu())


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def forward(self, x):
        a = _to_np(x)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return array((a - mean) / std, ctx=cpu())


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return array(_to_np(x), ctx=cpu(), dtype=self._dtype)
