"""The port's ``gluon.data.vision`` transforms and record/folder datasets
against the JAX package's.

Each of the ten transforms runs on the same HWC image (uint8 and
float32) in both packages under one ``np.random`` seed: the random ones
draw the same numbers, so crops, flips and factors agree exactly.
``Resize`` (and so ``RandomResizedCrop``) is ``jax.image.resize``'s
bilinear resampling rebuilt in numpy: the same float32 weights, but XLA
sums the products in another order, so float32 outputs agree within
1e-6 of the largest value (measured ~3e-7) and uint8 outputs, rounded
half to even from those sums, within one level where a sum lands on a
half, at most 2% of the elements (measured under 1%).  A pipeline that
ends in ``ToTensor`` and ``Normalize(0.5, 0.25)`` carries that level as
1/255/0.25.  The other transforms are numpy arithmetic in both packages
and equal exactly.  ``RecordFileDataset``,
``ImageRecordDataset`` and ``ImageFolderDataset`` read files the test
writes, item for item the JAX package's items."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrecordio
from mxnet_tpu.gluon.data import RecordFileDataset as JRecordFileDataset
from mxnet_tpu.gluon.data.vision import ImageFolderDataset as JFolder
from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JRecDataset
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.data import RecordFileDataset
from mxnet_tpu_torch.gluon.data.vision import (ImageFolderDataset,
                                               ImageRecordDataset)
from mxnet_tpu_torch.gluon.data.vision import transforms as T

TRANSFORMS = {
    "Resize": ((20,), {}),
    "Resize_wh_up": (((45, 33),), {}),
    "CenterCrop": ((24,), {}),
    "CenterCrop_larger": (((40, 50),), {}),
    "RandomResizedCrop": ((24,), {}),
    "RandomResizedCrop_narrow": ((16,), {"scale": (0.5, 0.6),
                                         "ratio": (0.5, 0.7)}),
    "RandomCrop": ((24,), {}),
    "RandomCrop_pad": ((24,), {"pad": 4}),
    "RandomFlipLeftRight": ((), {}),
    "RandomFlipTopBottom": ((), {}),
    "RandomBrightness": ((0.4,), {}),
    "RandomContrast": ((0.4,), {}),
    "RandomSaturation": ((0.4,), {}),
    "RandomColorJitter": ((), {"brightness": 0.3, "contrast": 0.3,
                               "saturation": 0.3}),
    "RandomLighting": ((0.1,), {}),
}


def _image(dtype, seed=0, hw=(30, 38)):
    a = np.random.RandomState(seed).randint(0, 256, hw + (3,), np.uint8)
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_matches_the_jax_package(case, dtype):
    name = case.split("_")[0]
    args, kw = TRANSFORMS[case]
    x = _image(dtype)
    for seed in range(4):
        np.random.seed(seed)
        got = getattr(T, name)(*args, **kw)(mx.nd.array(x, ctx=mx.cpu()))
        after = np.random.rand()
        np.random.seed(seed)
        want = getattr(jT, name)(*args, **kw)(jmx.nd.array(x)).asnumpy()
        assert np.random.rand() == after, "another count of draws"
        assert got.context == mx.cpu()
        got = got.asnumpy()
        assert got.shape == want.shape and got.dtype == want.dtype, case
        if name not in ("Resize", "RandomResizedCrop"):
            np.testing.assert_array_equal(got, want)
        elif dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        else:
            off = got.astype(int) - want
            assert np.abs(off).max() <= 1 and (off != 0).mean() <= 0.02


def test_the_random_transforms_draw():
    """Over seeds the random transforms take both branches / many
    values: a flip happens about half the time."""
    x = _image("uint8")
    flips = 0
    for seed in range(200):
        np.random.seed(seed)
        out = T.RandomFlipLeftRight()(mx.nd.array(x, ctx=mx.cpu()))
        flips += not np.array_equal(out.asnumpy(), x)
    assert 70 < flips < 130
    sizes = set()
    for seed in range(20):
        np.random.seed(seed)
        sizes.add(T.RandomResizedCrop(24)(x).shape)
    assert sizes == {(24, 24, 3)}


def test_compose_with_the_new_transforms():
    x = _image("uint8", hw=(40, 44))
    pipe = T.Compose([T.RandomResizedCrop(32), T.RandomFlipLeftRight(),
                      T.RandomColorJitter(0.2, 0.2, 0.2), T.ToTensor(),
                      T.Normalize(0.5, 0.25)])
    jpipe = jT.Compose([jT.RandomResizedCrop(32), jT.RandomFlipLeftRight(),
                        jT.RandomColorJitter(0.2, 0.2, 0.2), jT.ToTensor(),
                        jT.Normalize(0.5, 0.25)])
    np.random.seed(3)
    got = pipe(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    np.random.seed(3)
    want = jpipe(jmx.nd.array(x)).asnumpy()
    assert got.shape == (3, 32, 32)
    off = np.abs(got - want)
    assert off.max() <= 1 / 255 / 0.25 + 1e-5 and (off > 1e-5).mean() <= 0.02


def _write_rec(tmp_path, n=6):
    prefix = str(tmp_path / "imgs")
    rng = np.random.RandomState(0)
    w = jrecordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 255, (20, 24, 3), np.uint8)
        w.write_idx(i, jrecordio.pack_img(jrecordio.IRHeader(0, float(i),
                                                             i, 0), img))
    w.close()
    return prefix + ".rec"


def test_record_file_dataset(tmp_path):
    rec = _write_rec(tmp_path)
    ds, jds = RecordFileDataset(rec), JRecordFileDataset(rec)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        assert ds[i] == jds[i]


def test_image_record_dataset(tmp_path):
    rec = _write_rec(tmp_path)
    ds = ImageRecordDataset(rec)
    jds = JRecDataset(rec)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        (img, label), (jimg, jlabel) = ds[i], jds[i]
        assert img.context == mx.cpu() and img.shape == (20, 24, 3)
        np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())
        assert label == jlabel == float(i)
    tf = ImageRecordDataset(rec, transform=lambda x, y: (x.shape, y + 1))
    assert tf[2] == ((20, 24, 3), 3.0)
    loader = mx.gluon.data.DataLoader(
        ImageRecordDataset(rec).transform_first(T.ToTensor()), batch_size=3)
    x, y = next(iter(loader))
    assert x.shape == (3, 3, 20, 24) and x.context == mx.cpu()


def test_image_folder_dataset(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for j in range(3):
            arr = rng.randint(0, 255, (12, 10, 3), np.uint8)
            Image.fromarray(arr).save(str(tmp_path / cls / ("%d.png" % j)))
        np.save(str(tmp_path / cls / "x.npy"),
                rng.rand(4, 4, 3).astype(np.float32))
        (tmp_path / cls / "notes.txt").write_text("skipped")
    (tmp_path / "stray.png").write_bytes(b"not a folder")
    ds, jds = ImageFolderDataset(str(tmp_path)), JFolder(str(tmp_path))
    assert ds.synsets == jds.synsets == ["cat", "dog"]
    assert [(p, lab) for p, lab in ds.items] == \
        [(p, lab) for p, lab in jds.items]
    assert len(ds) == 8
    for i in range(len(ds)):
        (img, label), (jimg, jlabel) = ds[i], jds[i]
        assert label == jlabel and img.context == mx.cpu()
        np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())
    gray = ImageFolderDataset(str(tmp_path), flag=0)[0][0]
    np.testing.assert_array_equal(
        gray.asnumpy(), JFolder(str(tmp_path), flag=0)[0][0].asnumpy())
