"""SqueezeNet 1.0/1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``).  ``layout`` threads
end to end; the fire module's expand concat follows the layout's channel
axis, and its pools round up (``ceil_mode=True``)."""
from ....base import MXNetError
from ... import nn
from ...block import HybridBlock


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels,
               layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1, layout=layout))

    paths = _FirePaths(expand1x1_channels, expand3x3_channels,
                       layout=layout)
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0, layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding,
                      layout=layout))
    out.add(nn.Activation("relu"))
    return out


class _FirePaths(HybridBlock):
    def __init__(self, c1, c3, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._c_axis = layout.index("C")
        self.p1 = _make_fire_conv(c1, 1, layout=layout)
        self.p3 = _make_fire_conv(c3, 3, 1, layout=layout)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=self._c_axis)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError("version must be 1.0 or 1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, 7, 2, layout=layout))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(16, 64, 64, layout))
                self.features.add(_make_fire(16, 64, 64, layout))
                self.features.add(_make_fire(32, 128, 128, layout))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(32, 128, 128, layout))
                self.features.add(_make_fire(48, 192, 192, layout))
                self.features.add(_make_fire(48, 192, 192, layout))
                self.features.add(_make_fire(64, 256, 256, layout))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(64, 256, 256, layout))
            else:
                self.features.add(nn.Conv2D(64, 3, 2, layout=layout))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(16, 64, 64, layout))
                self.features.add(_make_fire(16, 64, 64, layout))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(32, 128, 128, layout))
                self.features.add(_make_fire(32, 128, 128, layout))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                               layout=layout))
                self.features.add(_make_fire(48, 192, 192, layout))
                self.features.add(_make_fire(48, 192, 192, layout))
                self.features.add(_make_fire(64, 256, 256, layout))
                self.features.add(_make_fire(64, 256, 256, layout))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, 1, layout=layout))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D(layout=layout))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw):
    kw.pop("pretrained", None)
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    kw.pop("pretrained", None)
    return SqueezeNet("1.1", **kw)
