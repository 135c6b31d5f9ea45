"""``mx.image`` (counterpart of ``mxnet_tpu/image``): host-side image
IO, the augmenters and ``ImageIter``, OpenCV first and PIL after."""
from .image import (CastAug, CenterCropAug, ColorJitterAug, CreateAugmenter,
                    HorizontalFlipAug, ImageIter, RandomCropAug, ResizeAug,
                    imdecode, imread, imresize)

__all__ = ["CastAug", "CenterCropAug", "ColorJitterAug", "CreateAugmenter",
           "HorizontalFlipAug", "ImageIter", "RandomCropAug", "ResizeAug",
           "imdecode", "imread", "imresize"]
