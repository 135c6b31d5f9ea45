"""The port's ``gluon.data`` against the JAX package's on the CPU: the
behaviour of ``tests/test_gluon_data.py`` (recordio, image records and
the resizing and random transforms excepted: not ported yet), the
synthetic MNIST byte for byte, and the same shuffled batches under one
``np.random.seed``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.gluon.data import (ArrayDataset, BatchSampler,
                                        DataLoader, IntervalSampler,
                                        RandomSampler, SequentialSampler,
                                        SimpleDataset)
from mxnet_tpu_torch.gluon.data.vision import transforms


def test_array_dataset():
    X = np.random.rand(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    ds = ArrayDataset(X, y)
    assert len(ds) == 10
    x0, y0 = ds[3]
    assert (x0 == X[3]).all() and y0 == 3
    with pytest.raises(MXNetError):
        ArrayDataset(X, y[:4])


def test_dataset_transform_filter_take():
    ds = ArrayDataset(np.arange(5, dtype=np.float32))
    t = ds.transform(lambda x: x * 2)
    assert t[2] == 4
    ds2 = ArrayDataset(np.arange(4, dtype=np.float32),
                       np.arange(4, dtype=np.float32))
    tf = ds2.transform_first(lambda x: x + 100)
    x, y = tf[1]
    assert x == 101 and y == 1
    f = SimpleDataset(list(range(10))).filter(lambda v: v % 3 == 0)
    assert [f[i] for i in range(len(f))] == [0, 3, 6, 9]
    k = SimpleDataset(list(range(10))).take(3)
    assert len(k) == 3
    with pytest.raises(IndexError):
        k[3]


def test_samplers():
    assert list(SequentialSampler(4)) == [0, 1, 2, 3]
    assert sorted(RandomSampler(5)) == list(range(5))
    bs = BatchSampler(SequentialSampler(5), 2, "keep")
    assert list(bs) == [[0, 1], [2, 3], [4]]
    bs2 = BatchSampler(SequentialSampler(5), 2, "discard")
    assert list(bs2) == [[0, 1], [2, 3]]
    roll = BatchSampler(SequentialSampler(5), 2, "rollover")
    assert list(roll) == [[0, 1], [2, 3]]
    assert list(roll) == [[4, 0], [1, 2], [3, 4]]
    assert list(IntervalSampler(6, 2)) == [0, 2, 4, 1, 3, 5]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_shuffled_batches_equal_the_jax_packages(last_batch):
    X = np.random.RandomState(1).rand(23, 3).astype(np.float32)
    y = np.arange(23, dtype=np.int32)
    got, want = [], []
    for pkg, out in ((mx, got), (jmx, want)):
        np.random.seed(5)
        loader = pkg.gluon.data.DataLoader(
            pkg.gluon.data.ArrayDataset(X, y), batch_size=4, shuffle=True,
            last_batch=last_batch)
        for _ in range(2):
            out.extend((b.asnumpy(), lab.asnumpy(), lab.dtype)
                       for b, lab in loader)
    assert len(got) == len(want) > 0
    for (gx, gy, gdt), (wx, wy, wdt) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gdt == wdt == np.int32


def test_dataloader_basic():
    X = np.random.rand(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    loader = DataLoader(ArrayDataset(X, y), batch_size=4)
    batches = list(loader)
    assert len(batches) == 3 == len(loader)
    xb, yb = batches[0]
    assert xb.shape == (4, 3)
    assert yb.asnumpy().tolist() == [0, 1, 2, 3]
    assert xb.context == mx.cpu()


def test_dataloader_builds_on_the_cpu_without_cuda(monkeypatch):
    """Batches never touch the default context (the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = gluon.data.vision.MNIST(root="/nonexistent-path", train=False)
    loader = DataLoader(ds.transform_first(
        lambda d: mx.nd.array(d.asnumpy().reshape(1, 28, 28) / 255.0,
                              ctx=mx.cpu())), batch_size=8,
        pin_memory=True)
    data, label = next(iter(loader))
    assert data.shape == (8, 1, 28, 28) and data.dtype == np.float32
    assert label.dtype == np.int32 and data.context == mx.cpu()


def test_dataloader_shuffle_lastbatch():
    ds = ArrayDataset(np.arange(10, dtype=np.float32))
    loader = DataLoader(ds, batch_size=3, shuffle=True, last_batch="discard")
    batches = list(loader)
    assert len(batches) == 3
    seen = np.concatenate([b.asnumpy() for b in batches])
    assert len(set(seen.tolist())) == 9


def test_dataloader_workers():
    X = np.random.rand(20, 3).astype(np.float32)
    loader = DataLoader(ArrayDataset(X), batch_size=5, num_workers=2)
    batches = list(loader)
    assert len(batches) == 4
    got = np.concatenate([b.asnumpy() for b in batches])
    np.testing.assert_allclose(got, X)  # order preserved


def test_dataloader_worker_error_reaches_the_consumer():
    def bad(x):
        raise ValueError("bad sample")
    loader = DataLoader(ArrayDataset(np.zeros((8, 2), np.float32))
                        .transform(bad), batch_size=4, num_workers=2)
    with pytest.raises(ValueError, match="bad sample"):
        list(loader)


def test_transforms_match_the_jax_package():
    img = (np.random.rand(8, 6, 3) * 255).astype(np.uint8)
    t = transforms.ToTensor()(mx.nd.array(img, dtype="uint8",
                                          ctx=mx.cpu()))
    jt = jgluon.data.vision.transforms.ToTensor()(
        jmx.nd.array(img, dtype="uint8"))
    assert t.shape == (3, 8, 6) and t.asnumpy().max() <= 1.0
    np.testing.assert_allclose(t.asnumpy(), jt.asnumpy(), rtol=1e-6)
    kw = dict(mean=(0.5, 0.4, 0.3), std=(0.5, 0.2, 0.25))
    n = transforms.Normalize(**kw)(t)
    jn = jgluon.data.vision.transforms.Normalize(**kw)(jt)
    np.testing.assert_allclose(n.asnumpy(), jn.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    c = transforms.Cast("float16")(t)
    assert c.dtype == np.float16
    comp = transforms.Compose([transforms.ToTensor(),
                               transforms.Normalize(0.5, 0.5)])
    out = comp(mx.nd.array(img, dtype="uint8", ctx=mx.cpu()))
    assert out.shape == (3, 8, 6) and out.asnumpy().min() >= -1.001


@pytest.mark.parametrize("train", [True, False])
def test_mnist_synthetic_equals_the_jax_packages(train):
    ds = gluon.data.vision.MNIST(root="/nonexistent-path", train=train)
    jds = jgluon.data.vision.MNIST(root="/nonexistent-path", train=train)
    assert ds.synthetic and jds.synthetic
    assert len(ds) == len(jds) == (60000 if train else 10000)
    assert ds._data.tobytes() == jds._data.tobytes()
    assert ds._label.tobytes() == jds._label.tobytes()
    for i in (0, 17, len(ds) - 1):
        (x, y), (jx, jy) = ds[i], jds[i]
        assert x.shape == (28, 28, 1) and x.dtype == np.uint8
        assert x.context == mx.cpu()
        np.testing.assert_array_equal(x.asnumpy(), jx.asnumpy())
        assert int(y) == int(jy) and 0 <= int(y) < 10


@pytest.mark.parametrize("name", ["FashionMNIST", "CIFAR10", "CIFAR100"])
def test_other_synthetic_vision_datasets_equal_the_jax_packages(name):
    ds = getattr(gluon.data.vision, name)(root="/nonexistent-path",
                                          train=False)
    jds = getattr(jgluon.data.vision, name)(root="/nonexistent-path",
                                            train=False)
    assert ds.synthetic and len(ds) == len(jds)
    assert ds._data.tobytes() == jds._data.tobytes()
    assert ds._label.tobytes() == jds._label.tobytes()
