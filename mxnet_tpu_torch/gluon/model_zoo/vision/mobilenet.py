"""MobileNet V1/V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``): depthwise separable
convolutions as grouped ``Conv2D`` with ``groups`` equal to the
channels, ReLU6 as ``clip(x, 0, 6)``.  ``layout`` threads end to end;
with ``layout="NHWC"`` V1's BatchNorm+ReLU pairs run through the fused
kernel (V2's ReLU6 is not a relu and stays unfused)."""
from ... import nn
from ...block import HybridBlock


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False, layout="NCHW"):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False, layout=layout))
    out.add(nn.BatchNorm(scale=True, axis=layout.index("C")))
    if active:
        out.add(RELU6() if relu6 else nn.Activation("relu"))


class RELU6(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False,
                 layout="NCHW"):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6, layout=layout)
    _add_conv(out, channels, relu6=relu6, layout=layout)


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True, layout=layout)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True,
                      layout=layout)
            _add_conv(self.out, channels, active=False, relu6=True,
                      layout=layout)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                      pad=1, layout=layout)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s, layout=layout)
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                      pad=1, relu6=True, layout=layout)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                                 + [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                              + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(LinearBottleneck(in_c, c, t, s,
                                                   layout=layout))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
            _add_conv(self.features, last_channels, relu6=True,
                      layout=layout)
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.HybridSequential(prefix="output_")
            self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                      prefix="pred_", layout=layout))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, **kwargs):
    kwargs.pop("pretrained", None)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, **kwargs):
    kwargs.pop("pretrained", None)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kw):
    return get_mobilenet(1.0, **kw)


def mobilenet0_75(**kw):
    return get_mobilenet(0.75, **kw)


def mobilenet0_5(**kw):
    return get_mobilenet(0.5, **kw)


def mobilenet0_25(**kw):
    return get_mobilenet(0.25, **kw)


def mobilenet_v2_1_0(**kw):
    return get_mobilenet_v2(1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return get_mobilenet_v2(0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return get_mobilenet_v2(0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return get_mobilenet_v2(0.25, **kw)
