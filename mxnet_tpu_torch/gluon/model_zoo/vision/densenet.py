"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``).  ``layout`` threads
end to end; each dense layer concatenates its input with its new
features on the layout's channel axis, and the transitions pool with
``AvgPool2D(2, 2)``.  With ``layout="NHWC"`` every BatchNorm+ReLU pair
(two a dense layer, one a transition, the stem and the head: 121 in
DenseNet-121) runs through the fused kernel."""
from ... import nn
from ...block import HybridBlock


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        self._c_axis = layout.index("C")
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm(axis=self._c_axis))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, 1, use_bias=False,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=self._c_axis))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, 3, padding=1, use_bias=False,
                                layout=layout))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return F.Concat(x, out, dim=self._c_axis)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index, layout="NCHW"):
    out = nn.HybridSequential(prefix="stage%d_" % stage_index)
    for _ in range(num_layers):
        out.add(_DenseLayer(growth_rate, bn_size, dropout, layout=layout))
    return out


def _make_transition(num_output_features, layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm(axis=layout.index("C")))
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, 1, use_bias=False,
                      layout=layout))
    out.add(nn.AvgPool2D(2, 2, layout=layout))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        c_axis = layout.index("C")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=c_axis))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1,
                    layout=layout))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2,
                                                       layout=layout))
                    num_features //= 2
            self.features.add(nn.BatchNorm(axis=c_axis))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _get(num, **kw):
    kw.pop("pretrained", None)
    f, g, b = densenet_spec[num]
    return DenseNet(f, g, b, **kw)


def densenet121(**kw):
    return _get(121, **kw)


def densenet161(**kw):
    return _get(161, **kw)


def densenet169(**kw):
    return _get(169, **kw)


def densenet201(**kw):
    return _get(201, **kw)
