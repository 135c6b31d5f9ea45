"""Vision models (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet V1/V2, AlexNet, VGG,
MobileNet V1/V2, SqueezeNet, DenseNet and Inception V3, and
``get_model`` by the JAX package's names."""
from ....base import MXNetError
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .mobilenet import (MobileNet, MobileNetV2, get_mobilenet,
                        get_mobilenet_v2, mobilenet0_5, mobilenet0_25,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_5,
                        mobilenet_v2_0_25, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

__all__ = ["AlexNet", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
           "BottleneckV2", "DenseNet", "Inception3", "MobileNet",
           "MobileNetV2", "ResNetV1", "ResNetV2", "SqueezeNet", "VGG",
           "alexnet", "densenet121", "densenet161", "densenet169",
           "densenet201", "get_mobilenet", "get_mobilenet_v2", "get_model",
           "get_resnet", "get_vgg", "inception_v3", "mobilenet0_25",
           "mobilenet0_5", "mobilenet0_75", "mobilenet1_0",
           "mobilenet_v2_0_25", "mobilenet_v2_0_5", "mobilenet_v2_0_75",
           "mobilenet_v2_1_0", "resnet101_v1", "resnet101_v2",
           "resnet152_v1", "resnet152_v2", "resnet18_v1", "resnet18_v2",
           "resnet34_v1", "resnet34_v2", "resnet50_v1", "resnet50_v2",
           "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg11_bn", "vgg13",
           "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """The zoo net called ``name`` (case-insensitive), built with
    ``kwargs``; ``MXNetError`` for a name not in the zoo."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError("model %r not in zoo; available: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
