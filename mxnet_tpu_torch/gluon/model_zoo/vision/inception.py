"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; Szegedy et al.,
"Rethinking the Inception Architecture"): each mixed block a channel
concat of parallel conv towers, on the layout's channel axis.  Input
(N, 3, 299, 299) under the default NCHW ``layout``; with
``layout="NHWC"`` every conv unit's BatchNorm+ReLU runs through the
fused kernel."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock


def _conv(channels, kernel_size, strides=1, padding=0, layout="NCHW"):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size=kernel_size, strides=strides,
                      padding=padding, use_bias=False, layout=layout),
            nn.BatchNorm(epsilon=0.001, axis=layout.index("C")),
            nn.Activation("relu"))
    return out


class _Tower(HybridBlock):
    """One branch: a sequence of conv units."""

    def __init__(self, specs, pool_first=None, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential()
            if pool_first == "avg":
                self.body.add(nn.AvgPool2D(pool_size=3, strides=1,
                                           padding=1, layout=layout))
            elif pool_first == "max":
                self.body.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           layout=layout))
            for (c, k, s, p) in specs:
                self.body.add(_conv(c, k, s, p, layout=layout))

    def hybrid_forward(self, F, x):
        return self.body(x)


class _Mixed(HybridBlock):
    """Channel-concat of parallel towers."""

    def __init__(self, towers, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._c_axis = layout.index("C")
        with self.name_scope():
            self.towers = nn.HybridSequential()
            for t in towers:
                self.towers.add(t)

    def hybrid_forward(self, F, x):
        return F.Concat(*[t(x) for t in self.towers], dim=self._c_axis)


def _mixed_a(pool_features, layout="NCHW"):
    return _Mixed([
        _Tower([(64, 1, 1, 0)], layout=layout),
        _Tower([(48, 1, 1, 0), (64, 5, 1, 2)], layout=layout),
        _Tower([(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)],
               layout=layout),
        _Tower([(pool_features, 1, 1, 0)], pool_first="avg",
               layout=layout),
    ], layout=layout)


def _mixed_b(layout="NCHW"):
    return _Mixed([
        _Tower([(384, 3, 2, 0)], layout=layout),
        _Tower([(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)],
               layout=layout),
        _Tower([], pool_first="max", layout=layout),
    ], layout=layout)


def _mixed_c(channels_7x7, layout="NCHW"):
    c = channels_7x7
    return _Mixed([
        _Tower([(192, 1, 1, 0)], layout=layout),
        _Tower([(c, 1, 1, 0), (c, (1, 7), 1, (0, 3)),
                (192, (7, 1), 1, (3, 0))], layout=layout),
        _Tower([(c, 1, 1, 0), (c, (7, 1), 1, (3, 0)),
                (c, (1, 7), 1, (0, 3)), (c, (7, 1), 1, (3, 0)),
                (192, (1, 7), 1, (0, 3))], layout=layout),
        _Tower([(192, 1, 1, 0)], pool_first="avg", layout=layout),
    ], layout=layout)


def _mixed_d(layout="NCHW"):
    return _Mixed([
        _Tower([(192, 1, 1, 0), (320, 3, 2, 0)], layout=layout),
        _Tower([(192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)],
               layout=layout),
        _Tower([], pool_first="max", layout=layout),
    ], layout=layout)


class _MixedE(HybridBlock):
    """The expanded-output block: two towers themselves fork 1x3/3x1."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._c_axis = layout.index("C")
        with self.name_scope():
            self.b1 = _conv(320, 1, layout=layout)
            self.b2_stem = _conv(384, 1, layout=layout)
            self.b2_a = _conv(384, (1, 3), 1, (0, 1), layout=layout)
            self.b2_b = _conv(384, (3, 1), 1, (1, 0), layout=layout)
            self.b3_stem = nn.HybridSequential()
            self.b3_stem.add(_conv(448, 1, layout=layout),
                             _conv(384, 3, 1, 1, layout=layout))
            self.b3_a = _conv(384, (1, 3), 1, (0, 1), layout=layout)
            self.b3_b = _conv(384, (3, 1), 1, (1, 0), layout=layout)
            self.b4 = nn.HybridSequential()
            self.b4.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1,
                                     layout=layout),
                        _conv(192, 1, layout=layout))

    def hybrid_forward(self, F, x):
        y2 = self.b2_stem(x)
        y3 = self.b3_stem(x)
        return F.Concat(self.b1(x), self.b2_a(y2), self.b2_b(y2),
                        self.b3_a(y3), self.b3_b(y3), self.b4(x),
                        dim=self._c_axis)


class Inception3(HybridBlock):
    """Reference: ``Inception3`` (inception v3, 299x299 input)."""

    def __init__(self, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential()
            self.features.add(
                _conv(32, 3, 2, 0, layout=layout),
                _conv(32, 3, 1, 0, layout=layout),
                _conv(64, 3, 1, 1, layout=layout),
                nn.MaxPool2D(pool_size=3, strides=2, layout=layout),
                _conv(80, 1, 1, 0, layout=layout),
                _conv(192, 3, 1, 0, layout=layout),
                nn.MaxPool2D(pool_size=3, strides=2, layout=layout),
                _mixed_a(32, layout), _mixed_a(64, layout),
                _mixed_a(64, layout),
                _mixed_b(layout),
                _mixed_c(128, layout), _mixed_c(160, layout),
                _mixed_c(160, layout), _mixed_c(192, layout),
                _mixed_d(layout),
                _MixedE(layout=layout), _MixedE(layout=layout),
                nn.GlobalAvgPool2D(layout=layout),
                nn.Dropout(0.5),
            )
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def inception_v3(pretrained=False, classes=1000, **kwargs):
    """Inception V3.  There are no pretrained weights to download: load
    a ``.params`` file with ``net.load_parameters`` or carry weights
    across with ``gluon.convert.params_from_numpy``."""
    if pretrained:
        from ....base import MXNetError
        raise MXNetError("pretrained weights are not bundled; use "
                         "net.load_parameters(path)")
    return Inception3(classes=classes, **kwargs)
