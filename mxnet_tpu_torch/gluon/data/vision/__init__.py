"""``gluon.data.vision`` (counterpart of ``mxnet_tpu/gluon/data/vision``)."""
from . import transforms
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST", "transforms"]
