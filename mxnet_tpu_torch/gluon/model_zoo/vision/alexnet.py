"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``).
``layout`` threads end to end (NCHW default, NHWC channels-last)."""
from ... import nn
from ...block import HybridBlock


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu",
                                        layout=layout))
            self.features.add(nn.MaxPool2D(3, 2, layout=layout))
            self.features.add(nn.Conv2D(192, 5, padding=2,
                                        activation="relu", layout=layout))
            self.features.add(nn.MaxPool2D(3, 2, layout=layout))
            self.features.add(nn.Conv2D(384, 3, padding=1,
                                        activation="relu", layout=layout))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu", layout=layout))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu", layout=layout))
            self.features.add(nn.MaxPool2D(3, 2, layout=layout))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def alexnet(**kwargs):
    kwargs.pop("pretrained", None)
    return AlexNet(**kwargs)
