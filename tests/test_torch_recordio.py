"""The port's ``recordio`` against the JAX package's: the files each
writes are byte for byte the other's (raw and JPEG records, ``.rec`` and
``.idx``, from the native engine and from the Python route), each reads
the other's, the two routes agree, and a corrupt record raises.  These
mirror ``tests/test_recordio_native.py``'s four tests and extend them.
Records are made from seed 0 with numpy; nothing here is approximate,
so every comparison is exact."""
import os

import numpy as np
import pytest

from mxnet_tpu import recordio as jrecordio

from mxnet_tpu_torch import MXNetError, _native
from mxnet_tpu_torch import recordio


@pytest.fixture
def native():
    """The native engine, built here; the test skips without g++."""
    lib = _native.load()
    if lib is None:
        pytest.skip("native library unavailable (no g++)")
    return lib


@pytest.fixture
def route(request, monkeypatch):
    """The port's recordio forced onto the native engine or onto the
    Python route; the engine's loader is put back afterwards."""
    want = request.param
    monkeypatch.setenv("MXNET_TPU_NATIVE", "1" if want == "native" else "0")
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    if want == "native" and _native.load() is None:
        pytest.skip("native library unavailable (no g++)")
    yield want
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)


def _images(n=10, hw=(30, 34), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, hw + (3,), dtype=np.uint8) for _ in range(n)]


def _write(mod, prefix, fmt, images):
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(images):
        header = mod.IRHeader(0, float(i % 1000), i, 0)
        if fmt == "raw":
            w.write_idx(i, mod.pack(header, img[:24, :24].tobytes()))
        elif fmt == "jpg":
            w.write_idx(i, mod.pack_img(header, img, quality=90))
        else:   # a label vector and a PNG
            w.write_idx(i, mod.pack_img(
                mod.IRHeader(3, [i, 2.5, -1.0], i, 7), img, img_fmt=".png"))
    w.close()
    return prefix + ".rec"


def _payloads(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return [bytes(rng.bytes(rng.randint(1, 4096))) for _ in range(n)]


@pytest.mark.parametrize("route", ["native", "python"], indirect=True)
@pytest.mark.parametrize("fmt", ["raw", "jpg", "png_vector_label"])
def test_files_are_byte_equal_to_the_jax_packages(tmp_path, route, fmt):
    images = _images()
    _write(recordio, str(tmp_path / "port"), fmt, images)
    _write(jrecordio, str(tmp_path / "jax"), fmt, images)
    for ext in (".rec", ".idx"):
        got = (tmp_path / ("port" + ext)).read_bytes()
        want = (tmp_path / ("jax" + ext)).read_bytes()
        assert got == want, ext


@pytest.mark.parametrize("route", ["native", "python"], indirect=True)
@pytest.mark.parametrize("fmt", ["raw", "jpg", "png_vector_label"])
def test_each_package_reads_the_others_files(tmp_path, route, fmt):
    images = _images()
    port_rec = _write(recordio, str(tmp_path / "port"), fmt, images)
    jax_rec = _write(jrecordio, str(tmp_path / "jax"), fmt, images)
    for reader, writer, rec in ((recordio, jrecordio, jax_rec),
                                (jrecordio, recordio, port_rec)):
        r = reader.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
        assert r.keys == list(range(len(images)))
        for i in (0, 7, 3, len(images) - 1):
            s = r.read_idx(i)
            h, body = reader.unpack(s)
            jh, jbody = writer.unpack(s)
            assert body == jbody and h.id == jh.id == i
            np.testing.assert_array_equal(np.asarray(h.label),
                                          np.asarray(jh.label))
            if fmt != "raw":
                _, img = reader.unpack_img(s)
                _, jimg = writer.unpack_img(s)
                np.testing.assert_array_equal(img, jimg)
                if fmt == "png_vector_label":
                    np.testing.assert_array_equal(img, images[i])
        assert r.read_batch(list(range(len(images))), nthreads=4) == \
            [r.read_idx(k) for k in range(len(images))]
        r.close()


def test_native_round_trip(tmp_path, native):
    payloads = _payloads()
    w = recordio.MXIndexedRecordIO(str(tmp_path / "f.idx"),
                                   str(tmp_path / "f.rec"), "w")
    assert w._nh is not None
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    r = recordio.MXIndexedRecordIO(str(tmp_path / "f.idx"),
                                   str(tmp_path / "f.rec"), "r")
    assert r._nh is not None
    for i in (0, 63, 31, 1):
        assert r.read_idx(i) == payloads[i]
    assert r.read_batch(list(range(64)), nthreads=4) == payloads
    assert r.read_batch([5, 2, 5], nthreads=1) == [payloads[5], payloads[2],
                                                   payloads[5]]
    r.close()


@pytest.mark.parametrize("route", ["native", "python"], indirect=True)
def test_the_routes_agree_with_each_other_and_the_jax_package(
        tmp_path, monkeypatch, route):
    """Sequential writes and reads on either route of the port against
    the JAX package's Python route, both directions."""
    payloads = [b"a" * 7, b"bb", b"c" * 1000, b"", b"\x0a\x23\xd7\xce" * 9]
    rec = str(tmp_path / "port.rec")
    w = recordio.MXRecordIO(rec, "w")
    assert (w._nh is not None) == (route == "native")
    for p in payloads:
        w.write(p)
    w.close()
    import mxnet_tpu._native as jnat
    monkeypatch.setattr(jnat, "_TRIED", True)
    monkeypatch.setattr(jnat, "_LIB", None)
    jw = jrecordio.MXRecordIO(str(tmp_path / "jax.rec"), "w")
    for p in payloads:
        jw.write(p)
    jw.close()
    assert open(rec, "rb").read() == open(str(tmp_path / "jax.rec"),
                                          "rb").read()
    for path in (rec, str(tmp_path / "jax.rec")):
        r = recordio.MXRecordIO(path, "r")
        got = []
        while True:
            x = r.read()
            if x is None:
                break
            got.append(x)
        assert got == payloads
        r.reset()
        assert r.read() == payloads[0]
        r.close()


@pytest.mark.parametrize("route", ["native", "python"], indirect=True)
def test_a_corrupt_record_raises(tmp_path, route):
    bad = str(tmp_path / "bad.rec")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 16)
    r = recordio.MXRecordIO(bad, "r")
    with pytest.raises(MXNetError, match="corrupt"):
        r.read()
    r.close()
    # a good file whose second record's magic is broken: read_idx and
    # read_batch (native or Python) both raise, the first record reads
    prefix = str(tmp_path / "f")
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, p in enumerate(_payloads(4)):
        w.write_idx(i, p)
    w.close()
    r = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    off = r.idx[1]
    r.close()
    with open(prefix + ".rec", "r+b") as f:
        f.seek(off)
        f.write(b"\xde\xad\xbe\xef")
    r = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert r.read_idx(0) == _payloads(4)[0]
    with pytest.raises(MXNetError, match="corrupt"):
        r.read_idx(1)
    with pytest.raises(MXNetError, match="corrupt"):
        r.read_batch([0, 1, 2], nthreads=2)
    r.close()


def test_pack_unpack_headers():
    hdr = recordio.IRHeader(0, 3.5, 42, 0)
    s = recordio.pack(hdr, b"payload")
    assert s == jrecordio.pack(jrecordio.IRHeader(0, 3.5, 42, 0), b"payload")
    h2, body = recordio.unpack(s)
    assert body == b"payload"
    assert h2.label == 3.5 and h2.id == 42
    vec = recordio.pack(recordio.IRHeader(0, [1.0, 2.0], 3, 4), b"x")
    assert vec == jrecordio.pack(jrecordio.IRHeader(0, [1.0, 2.0], 3, 4),
                                 b"x")
    h3, body = recordio.unpack(vec)
    assert h3.flag == 2 and body == b"x"
    np.testing.assert_array_equal(h3.label, np.float32([1, 2]))
    h4, view = recordio._unpack_view(vec)
    assert isinstance(view, memoryview) and bytes(view) == b"x"


def test_native_library_builds_beside_the_checkout(native):
    so = _native.so_path()
    assert so.name == "librecordio_native.so" and so.exists()
    if not os.environ.get("MXNET_TPU_NATIVE_CACHE"):
        pkg_root = os.path.dirname(os.path.dirname(_native.__file__))
        assert str(so.parent) == os.path.join(
            os.path.dirname(pkg_root), "build", "torch_native")
    assert _native.available()
