"""Vision models: ResNet V1/V2."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet18_v2", "resnet34_v1", "resnet34_v2", "resnet50_v1",
           "resnet50_v2", "resnet101_v1", "resnet101_v2", "resnet152_v1",
           "resnet152_v2"]
