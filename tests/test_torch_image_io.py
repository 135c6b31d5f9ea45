"""The port's ``mx.image`` and ``mx.io`` against the JAX package's.

These mirror ``tests/test_io_image.py``'s seven tests and extend them:
``ImageIter`` batches are bit for bit the JAX package's under one
``np.random`` seed with ``preprocess_threads=0`` (shuffle,
``num_parts``/``part_index``, a padded last batch, ``dtype="uint8"``,
raw and JPEG records), the thread pool gives the same multiset of
samples, the process pool runs, the augmenters, ``imdecode`` and
``imresize`` match, and ``ImageRecordIter``'s host route matches.  Both
packages decode with the same OpenCV (or PIL) and draw from numpy's
global state, so every comparison is exact except the mean/std
normalization, held to 1e-6 relative (float32 in both)."""
import io as _pyio

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrecordio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, io, recordio


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _make_rec(tmp_path, n=12, hw=(32, 36), fmt="jpg", name="ds",
              label=lambda i: float(i % 3)):
    prefix = str(tmp_path / name)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,), dtype=np.uint8)
        header = recordio.IRHeader(0, label(i), i, 0)
        if fmt == "raw":
            rec.write_idx(i, recordio.pack(header, img[:24, :24].tobytes()))
        else:
            rec.write_idx(i, recordio.pack_img(header, img))
    rec.close()
    return prefix


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(a, b):
    assert len(a) == len(b)
    for (x, y, p), (jx, jy, jp) in zip(a, b):
        assert x.dtype == jx.dtype and x.shape == jx.shape
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert p == jp


def test_ndarray_iter_pad_and_discard():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    for handle, n in (("pad", 3), ("discard", 2)):
        got = list(io.NDArrayIter(x, x[:, 0], batch_size=4,
                                  last_batch_handle=handle))
        want = list(jio.NDArrayIter(x, x[:, 0], batch_size=4,
                                    last_batch_handle=handle))
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g.pad == w.pad
            np.testing.assert_array_equal(g.data[0].asnumpy(),
                                          w.data[0].asnumpy())
            np.testing.assert_array_equal(g.label[0].asnumpy(),
                                          w.label[0].asnumpy())
    assert got[0].data[0].context == mx.cpu()
    it = io.NDArrayIter({"a": x}, batch_size=5, shuffle=True)
    assert it.provide_data == [io.DataDesc("a", (5, 1))]


def test_resize_iter():
    x = np.zeros((8, 2), np.float32)
    it = io.ResizeIter(io.NDArrayIter(x, batch_size=4), size=5)
    assert len(list(it)) == 5
    it.reset()
    assert len(list(it)) == 5


def test_image_record_iter(tmp_path):
    prefix = _make_rec(tmp_path)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 24, 24),
              batch_size=4, mean_r=128, mean_g=128, mean_b=128,
              preprocess_threads=2)
    it = io.ImageRecordIter(**kw)
    batch = next(iter(it))
    assert batch.data[0].shape == (4, 3, 24, 24)
    assert batch.label[0].shape[0] == 4
    assert batch.data[0].asnumpy().min() < 0   # normalized, not uint8
    it.close()


@pytest.mark.parametrize("fmt", ["jpg", "raw"])
def test_image_record_iter_host_route_matches_the_jax_package(tmp_path, fmt):
    prefix = _make_rec(tmp_path, n=10, fmt=fmt)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 24, 24),
              batch_size=4, shuffle=True, rand_mirror=True,
              rand_crop=fmt == "jpg", mean_r=123.68, mean_g=116.779,
              mean_b=103.939, std_r=58.393, std_g=57.12, std_b=57.375,
              preprocess_threads=0)
    np.random.seed(5)
    got = _epoch(io.ImageRecordIter(**kw))
    np.random.seed(5)
    want = _epoch(jio.ImageRecordIter(**kw))
    assert len(got) == len(want) == 3 and got[-1][2] == 2
    for (x, y, p), (jx, jy, jp) in zip(got, want):
        np.testing.assert_allclose(x, jx, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(y, jy)
        assert p == jp


def test_image_iter_sharding(tmp_path):
    prefix = _make_rec(tmp_path, label=float)
    parts = []
    for pi in range(2):
        it = image.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                             num_parts=2, part_index=pi)
        labels = []
        for b in it:
            labels.extend(b.label[0].asnumpy().tolist())
        parts.append(set(labels))
        it.close()
    assert parts[0].isdisjoint(parts[1])
    assert parts[0] | parts[1] == set(float(i) for i in range(12))


CASES = {
    "plain": dict(),
    "shuffle": dict(shuffle=True),
    "part1of3": dict(num_parts=3, part_index=1, shuffle=True),
    "uint8": dict(dtype="uint8", shuffle=True),
    "augmented": dict(shuffle=True, augment=True),
}


@pytest.mark.parametrize("fmt", ["jpg", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_image_iter_batches_are_the_jax_packages_bit_for_bit(tmp_path, fmt,
                                                             case):
    """11 records in batches of 4: the last batch pads by wrapping."""
    prefix = _make_rec(tmp_path, n=11, fmt=fmt)
    kw = dict(CASES[case])
    augment = kw.pop("augment", False)
    runs = []
    for mod in (image, jimage):
        if augment:
            kw["aug_list"] = mod.CreateAugmenter(
                (3, 24, 24), rand_crop=fmt == "jpg", rand_mirror=True,
                brightness=0.2, contrast=0.2, saturation=0.2)
        np.random.seed(11)
        it = mod.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                           preprocess_threads=0, **kw)
        runs.append(_epoch(it) + (it.reset() or _epoch(it)))
        it.close()
    got, want = runs
    assert got[-1][2] == want[-1][2] > 0 or "part" in case
    if kw.get("dtype") == "uint8":
        assert got[0][0].dtype == np.uint8
    _same(got, want)


def test_image_iter_next_np_fills_the_callers_buffer(tmp_path):
    prefix = _make_rec(tmp_path, n=8, fmt="raw")
    it = image.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                         preprocess_threads=0, dtype="uint8")
    out = np.zeros((4, 3, 24, 24), np.uint8)
    data, labels, pad = it.next_np(out=out)
    assert data is out and pad == 0 and out.any()
    jit = jimage.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                           preprocess_threads=0, dtype="uint8")
    jdata, jlabels, _ = jit.next_np()
    np.testing.assert_array_equal(out, jdata)
    np.testing.assert_array_equal(labels, jlabels)
    it.close()
    jit.close()


@pytest.mark.parametrize("fmt", ["jpg", "raw"])
def test_the_thread_pool_gives_the_same_multiset(tmp_path, fmt):
    prefix = _make_rec(tmp_path, n=12, fmt=fmt, label=float)

    def samples(threads):
        it = image.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                             preprocess_threads=threads, shuffle=True)
        np.random.seed(2)
        it.reset()
        out = sorted((float(y), x.tobytes()) for b in it
                     for x, y in zip(b.data[0].asnumpy(),
                                     b.label[0].asnumpy()))
        it.close()
        return out
    assert samples(4) == samples(0)


def test_the_process_pool_runs(tmp_path):
    prefix = _make_rec(tmp_path, n=12, fmt="raw", label=float)
    it = image.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                         preprocess_procs=2, dtype="uint8")
    try:
        got = [it.next_np() for _ in range(3)]
    finally:
        it.close()
    jit = jimage.ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                           preprocess_threads=0, dtype="uint8")
    want = [jit.next_np() for _ in range(3)]
    jit.close()
    for (x, y, p), (jx, jy, jp) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert p == jp
    assert it._shm is None and it._proc_pool is None


def test_augmenters():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 255, (40, 50, 3), dtype=np.uint8)
    img = mx.nd.array(src.astype(np.float32))
    jimg = jmx.nd.array(src.astype(np.float32))
    cases = [("ResizeAug", (32,)), ("CenterCropAug", ((24, 24),)),
             ("RandomCropAug", ((24, 24),)), ("HorizontalFlipAug", (1.0,)),
             ("HorizontalFlipAug", (0.5,)), ("CastAug", ("float16",)),
             ("ColorJitterAug", (0.3, 0.3, 0.3))]
    for name, args in cases:
        for x, jx in ((img, jimg), (src, src)):
            np.random.seed(4)
            out = getattr(image, name)(*args)(x)
            np.random.seed(4)
            want = getattr(jimage, name)(*args)(jx)
            out = out.asnumpy() if isinstance(out, mx.nd.NDArray) else out
            want = want.asnumpy() if isinstance(want, jmx.nd.NDArray) \
                else want
            assert out.dtype == want.dtype, name
            np.testing.assert_array_equal(out, want, err_msg=name)
    assert min(image.ResizeAug(32)(img).shape[:2]) == 32
    np.testing.assert_array_equal(image.HorizontalFlipAug(1.0)(img)
                                  .asnumpy(), src[:, ::-1])
    auglist = image.CreateAugmenter((3, 24, 24), resize=32, rand_mirror=True,
                                    brightness=0.1)
    jaug = jimage.CreateAugmenter((3, 24, 24), resize=32, rand_mirror=True,
                                  brightness=0.1)
    assert [type(a).__name__ for a in auglist] == \
        [type(a).__name__ for a in jaug] and len(auglist) >= 4


def test_imdecode_imresize():
    from PIL import Image
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (20, 30, 3), dtype=np.uint8)
    buf = _pyio.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    img = image.imdecode(buf.getvalue())
    assert img.shape == (20, 30, 3) and img.context == mx.cpu()
    np.testing.assert_array_equal(img.asnumpy(), arr)
    np.testing.assert_array_equal(
        img.asnumpy(), jimage.imdecode(buf.getvalue()).asnumpy())
    gray = image.imdecode(buf.getvalue(), flag=0)
    np.testing.assert_array_equal(
        gray.asnumpy(), jimage.imdecode(buf.getvalue(), flag=0).asnumpy())
    for a in (img, arr.astype(np.float32)):
        small = image.imresize(a, 10, 8)
        jsmall = jimage.imresize(a if isinstance(a, np.ndarray)
                                 else a.asnumpy(), 10, 8)
        assert small.shape[:2] == (8, 10)
        np.testing.assert_array_equal(small.asnumpy(), jsmall.asnumpy())


def test_imread(tmp_path):
    from PIL import Image
    arr = np.random.RandomState(1).randint(0, 255, (9, 7, 3), np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(image.imread(path).asnumpy(), arr)


def test_csv_iter(tmp_path):
    path = str(tmp_path / "d.csv")
    np.savetxt(path, np.arange(12).reshape(4, 3), delimiter=",")
    lpath = str(tmp_path / "l.csv")
    np.savetxt(lpath, np.arange(4), delimiter=",")
    got = list(io.CSVIter(data_csv=path, data_shape=(3,), label_csv=lpath,
                          batch_size=2))
    want = list(jio.CSVIter(data_csv=path, data_shape=(3,), label_csv=lpath,
                            batch_size=2))
    assert got[0].data[0].shape == (2, 3) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())


def test_mnist_iter(tmp_path):
    import struct
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (6, 28, 28), np.uint8)
    lbls = rng.randint(0, 10, 6).astype(np.uint8)
    with open(str(tmp_path / "img"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 28, 28) + imgs.tobytes())
    with open(str(tmp_path / "lbl"), "wb") as f:
        f.write(struct.pack(">II", 2049, 6) + lbls.tobytes())
    kw = dict(image=str(tmp_path / "img"), label=str(tmp_path / "lbl"),
              batch_size=4, shuffle=False, flat=True)
    got, want = next(io.MNISTIter(**kw)), next(jio.MNISTIter(**kw))
    assert got.data[0].shape == (4, 784)
    np.testing.assert_array_equal(got.data[0].asnumpy(),
                                  want.data[0].asnumpy())
    np.testing.assert_array_equal(got.label[0].asnumpy(),
                                  want.label[0].asnumpy())


def test_prefetching_iter_order_errors_and_close():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    pf = io.PrefetchingIter(io.NDArrayIter(x, batch_size=4,
                                           last_batch_handle="discard"))
    got = [b.data[0].asnumpy() for b in pf]
    np.testing.assert_array_equal(np.concatenate(got), x[:8])
    assert got and pf.provide_data[0].shape == (4, 2)
    pf.reset()
    assert len(list(pf)) == 2
    pf.close()

    class Broken(io.DataIter):
        def next(self):
            raise ValueError("decode failed")
    with pytest.raises(ValueError, match="decode failed"):
        next(io.PrefetchingIter(Broken()))
    with pytest.raises(mx.MXNetError):
        io.PrefetchingIter([Broken(), Broken()])
