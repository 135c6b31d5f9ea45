"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``) on HWC images in host
memory; their outputs are on ``mx.cpu()``.

The random transforms draw from numpy's global ``np.random`` state in
the JAX package's order, so under one ``np.random.seed`` both packages
make the same draws.  ``Resize`` is ``jax.image.resize(..., "bilinear")``
(antialiased when it shrinks) rebuilt in numpy: the same float32 weight
matrices, contracted one spatial axis at a time.
"""
from __future__ import annotations

import numpy as np

from ....context import cpu
from ....ndarray import NDArray, array
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Cast", "CenterCrop", "Compose", "Normalize", "RandomBrightness",
           "RandomColorJitter", "RandomContrast", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomLighting",
           "RandomResizedCrop", "RandomSaturation", "Resize", "ToTensor"]


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


def _host(a):
    return array(a, ctx=cpu())


def _bilinear_weights(m, n):
    """``jax.image``'s (m, n) float32 weight matrix of a bilinear resize
    from ``m`` samples to ``n``: a triangle kernel, widened by m / n when
    shrinking, normalized per output, zero where an output centre falls
    outside the input."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    kernel_scale = f32(max(1.0 / (n / m), 1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _resize_bilinear(a, h, w):
    """HWC ``a`` resized to (h, w) in float32; a uint8 input rounds (half
    to even) and clips back to uint8."""
    out = np.asarray(a, np.float32)
    if out.shape[0] != h:
        out = np.tensordot(_bilinear_weights(out.shape[0], h), out,
                           axes=([0], [0]))
    if out.shape[1] != w:
        out = np.moveaxis(np.tensordot(_bilinear_weights(out.shape[1], w),
                                       out, axes=([0], [1])), 0, 1)
    out = out.astype(np.float32)
    if np.asarray(a).dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(out)


class Resize(Block):
    """Bilinear resize to ``size`` (an int or ``(w, h)``)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        return _host(_resize_bilinear(_to_np(x), h, w))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        a = _to_np(x)
        w, h = self._size
        y0 = max((a.shape[0] - h) // 2, 0)
        x0 = max((a.shape[1] - w) // 2, 0)
        return _host(a[y0:y0 + h, x0:x0 + w])


class RandomResizedCrop(Block):
    """Random area/aspect crop, then a resize to ``size`` (the ImageNet
    train-time augmentation)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _to_np(x)
        H, W = a.shape[:2]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = a[y0:y0 + h, x0:x0 + w]
                return Resize(self._size)(_host(crop))
        return Resize(self._size)(CenterCrop(min(H, W))(_host(a)))


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        a = _to_np(x)
        if self._pad:
            p = self._pad
            a = np.pad(a, ((p, p), (p, p), (0, 0)), mode="constant")
        w, h = self._size
        y0 = np.random.randint(0, max(a.shape[0] - h, 0) + 1)
        x0 = np.random.randint(0, max(a.shape[1] - w, 0) + 1)
        return _host(a[y0:y0 + h, x0:x0 + w])


class RandomFlipLeftRight(Block):
    def forward(self, x):
        a = _to_np(x)
        if np.random.rand() < 0.5:
            a = a[:, ::-1]
        return _host(np.ascontiguousarray(a))


class RandomFlipTopBottom(Block):
    def forward(self, x):
        a = _to_np(x)
        if np.random.rand() < 0.5:
            a = a[::-1]
        return _host(np.ascontiguousarray(a))


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._b, self._b)
        return _host(np.clip(a * f, 0, 255))


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._c, self._c)
        mean = a.mean()
        return _host(np.clip((a - mean) * f + mean, 0, 255))


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._s, self._s)
        gray = a.mean(axis=2, keepdims=True)
        return _host(np.clip(gray + (a - gray) * f, 0, 255))


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        # permuting the indices draws what permuting the list draws
        for i in np.random.permutation(len(self._ts)).tolist():
            x = self._ts[i](x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha_std=0.05):
        super().__init__()
        self._std = alpha_std

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._std, 3).astype(np.float32)
        rgb = (self._eigvec @ (alpha * self._eigval)).astype(np.float32)
        return _host(np.clip(a + rgb, 0, 255))
