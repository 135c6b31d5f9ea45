"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``).  ``layout`` threads end to
end; with ``layout="NHWC"`` each BatchNorm+ReLU pair of a ``_bn`` net
runs through the fused kernel."""
from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        c_axis = layout.index("C")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], 3, padding=1,
                                                layout=layout))
                    if batch_norm:
                        self.features.add(nn.BatchNorm(axis=c_axis))
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2, layout=layout))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, **kwargs):
    kwargs.pop("pretrained", None)
    if num_layers not in vgg_spec:
        raise MXNetError("bad vgg depth %d" % num_layers)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


def vgg11_bn(**kw):
    return get_vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return get_vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return get_vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return get_vgg(19, batch_norm=True, **kw)
