"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).  The weight layout follows the
data layout: ``NCHW`` -> ``OIHW``, ``NHWC`` -> ``OHWI``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "GlobalAvgPool2D", "MaxPool2D"]


def _tuplify(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
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
        ic = in_channels // self._groups if in_channels else 0
        if self._channels_last:
            return (self._channels,) + tuple(self._kernel) + (ic,)
        return (self._channels, ic) + tuple(self._kernel)

    def infer_shape(self, x):
        self.weight.shape = self._weight_shape(x.shape[self._c_axis])

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, no_bias=bias is None,
                            **self._kwargs)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2),
                         _tuplify(strides, 2), _tuplify(padding, 2),
                         _tuplify(dilation, 2), groups, layout, **kwargs)


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


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplify(pool_size, 2),
                         _tuplify(strides, 2) if strides is not None
                         else None,
                         _tuplify(padding, 2), False, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, "avg", layout,
                         **kwargs)
