"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, Fashion-MNIST,
CIFAR-10, CIFAR-100, ``ImageRecordDataset`` and ``ImageFolderDataset``.

Each reads the standard files under ``root`` when they are there and
otherwise falls back, with a warning, to the JAX package's deterministic
synthetic sample of the same shape and dtype (``.synthetic`` is set):
nothing is downloaded.  The synthetic data are byte for byte the JAX
package's.  Items are built on ``mx.cpu()``: an image NDArray in the
file's HWC uint8 layout, and its label as an int32 number (a record's
label as its header gives it, a folder's class index).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings

import numpy as np

from ....context import cpu
from ....ndarray import array
from ..dataset import Dataset, RecordFileDataset

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST"]


def _synthetic_images(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    return data, label


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self.synthetic = False
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        x = array(self._data[idx], ctx=cpu())
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST; reads the idx-ubyte files (or their ``.gz``) from root."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        base = "train" if self._train else "t10k"
        img = os.path.join(self._root, "%s-images-idx3-ubyte" % base)
        lbl = os.path.join(self._root, "%s-labels-idx1-ubyte" % base)
        for ext in ("", ".gz"):
            if os.path.exists(img + ext) and os.path.exists(lbl + ext):
                opener = gzip.open if ext else open
                with opener(lbl + ext, "rb") as f:
                    struct.unpack(">II", f.read(8))
                    label = np.frombuffer(f.read(), np.uint8).astype(np.int32)
                with opener(img + ext, "rb") as f:
                    _, n, h, w = struct.unpack(">IIII", f.read(16))
                    data = np.frombuffer(f.read(), np.uint8) \
                        .reshape(n, h, w, 1)
                self._data, self._label = data, label
                return
        warnings.warn("MNIST files not found under %s and no network; "
                      "using deterministic synthetic data" % self._root)
        self.synthetic = True
        n = 60000 if self._train else 10000
        self._data, self._label = _synthetic_images(
            n, (28, 28, 1), 10, seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10; reads the python pickle batches from root."""

    _nclass = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_batches(self, names):
        data, label = [], []
        for name in names:
            path = None
            for cand in (os.path.join(self._root, name),
                         os.path.join(self._root, "cifar-10-batches-py",
                                      name)):
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                return None, None
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="latin1")
            data.append(np.asarray(d["data"], np.uint8)
                        .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            key = "labels" if "labels" in d else "fine_labels"
            label.append(np.asarray(d[key], np.int32))
        return np.concatenate(data), np.concatenate(label)

    def _get_data(self):
        names = ["data_batch_%d" % i for i in range(1, 6)] if self._train \
            else ["test_batch"]
        data, label = self._load_batches(names)
        if data is None:
            warnings.warn("CIFAR10 files not found under %s and no network; "
                          "using deterministic synthetic data" % self._root)
            self.synthetic = True
            n = 50000 if self._train else 10000
            data, label = _synthetic_images(
                n, (32, 32, 3), self._nclass, seed=44 if self._train else 45)
        self._data, self._label = data, label


class CIFAR100(CIFAR10):
    _nclass = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=False, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        names = ["train"] if self._train else ["test"]
        data, label = self._load_batches(names)
        if data is None:
            warnings.warn("CIFAR100 files not found; synthetic fallback")
            self.synthetic = True
            n = 50000 if self._train else 10000
            data, label = _synthetic_images(
                n, (32, 32, 3), 100, seed=46 if self._train else 47)
        self._data, self._label = data, label


class ImageRecordDataset(RecordFileDataset):
    """Images in an indexed RecordIO file: item ``i`` is the decoded HWC
    uint8 image of record ``i`` and its header's label."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = super().__getitem__(idx)
        header, img = unpack_img(record)
        label = header.label
        img = array(img, ctx=cpu())
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """A folder per class under ``root``, in sorted order (``synsets``);
    items are ``(image, class index)`` over the image files (and
    ``.npy`` arrays) of each folder, sorted by name."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = (".jpg", ".jpeg", ".png", ".bmp", ".npy")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        from ....image.image import _decode_np
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = array(np.load(path), ctx=cpu())
        else:
            with open(path, "rb") as f:
                img = array(_decode_np(f.read(), self._flag), ctx=cpu())
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
