"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).  The weight layout follows the
data layout: ``NCHW`` -> ``OIHW``, ``NHWC`` -> ``OHWI``; a transposed
convolution's weight is ``(in, out / groups, *k)`` (``(in, *k, out /
groups)`` channels-last)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "ReflectionPad2D"]


def _tuplify(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._act = activation
        self._groups = groups
        self._kernel = kernel_size
        self._c_axis = layout.index("C")
        self._channels_last = self._c_axis == len(kernel_size) + 1
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def _weight_shape(self, in_channels):
        if self._op_name == "Convolution":
            outer = self._channels
            inner = in_channels // self._groups if in_channels else 0
        else:       # Deconvolution: (in, out / groups, *k)
            outer = in_channels if in_channels else 0
            inner = self._channels // self._groups
        if self._channels_last:
            return (outer,) + tuple(self._kernel) + (inner,)
        return (outer, inner) + tuple(self._kernel)

    def infer_shape(self, x):
        self.weight.shape = self._weight_shape(x.shape[self._c_axis])

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 1),
                         _tuplify(strides, 1), _tuplify(padding, 1),
                         _tuplify(dilation, 1), groups, layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2),
                         _tuplify(strides, 2), _tuplify(padding, 2),
                         _tuplify(dilation, 2), groups, layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 3),
                         _tuplify(strides, 3), _tuplify(padding, 3),
                         _tuplify(dilation, 3), groups, layout, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2),
                         _tuplify(strides, 2), _tuplify(padding, 2),
                         _tuplify(dilation, 2), groups, layout,
                         op_name="Deconvolution",
                         adj=_tuplify(output_padding, 2), **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 1),
                         _tuplify(strides, 1), _tuplify(padding, 1),
                         _tuplify(dilation, 1), groups, layout,
                         op_name="Deconvolution",
                         adj=_tuplify(output_padding, 1), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=None, ceil_mode=False, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


def _pool(n, pool_type, default_layout, avg):
    """A windowed pooling layer over ``n`` spatial axes."""
    def __init__(self, pool_size=(2,) * n if n > 1 else 2, strides=None,
                 padding=0, layout=default_layout, ceil_mode=False,
                 count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _tuplify(pool_size, n),
            _tuplify(strides, n) if strides is not None else None,
            _tuplify(padding, n), False, pool_type, layout,
            count_include_pad if avg else None, ceil_mode, **kwargs)
    return __init__


def _global_pool(n, pool_type, default_layout):
    """A pooling layer over all ``n`` spatial axes."""
    def __init__(self, layout=default_layout, **kwargs):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, True, pool_type,
                          layout, **kwargs)
    return __init__


class MaxPool1D(_Pooling):
    __init__ = _pool(1, "max", "NCW", False)


class MaxPool2D(_Pooling):
    __init__ = _pool(2, "max", "NCHW", False)


class MaxPool3D(_Pooling):
    __init__ = _pool(3, "max", "NCDHW", False)


class AvgPool1D(_Pooling):
    __init__ = _pool(1, "avg", "NCW", True)


class AvgPool2D(_Pooling):
    __init__ = _pool(2, "avg", "NCHW", True)


class AvgPool3D(_Pooling):
    __init__ = _pool(3, "avg", "NCDHW", True)


class GlobalMaxPool1D(_Pooling):
    __init__ = _global_pool(1, "max", "NCW")


class GlobalMaxPool2D(_Pooling):
    __init__ = _global_pool(2, "max", "NCHW")


class GlobalMaxPool3D(_Pooling):
    __init__ = _global_pool(3, "max", "NCDHW")


class GlobalAvgPool1D(_Pooling):
    __init__ = _global_pool(1, "avg", "NCW")


class GlobalAvgPool2D(_Pooling):
    __init__ = _global_pool(2, "avg", "NCHW")


class GlobalAvgPool3D(_Pooling):
    __init__ = _global_pool(3, "avg", "NCDHW")


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the two last axes of an NCHW input by ``padding``."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        p = _tuplify(padding, 2)
        self._pad_width = (0, 0, 0, 0, p[0], p[0], p[1], p[1])

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._pad_width)
