"""The port's ``.params`` container (``mxnet_tpu_torch.nd.save/load``)
against the JAX package's, on the CPU: the same numpy arrays written by
both give the same bytes, for every dtype of the flag table (bfloat16
as flag 100) and for 0-d and empty shapes; each package reads the
other's file bit for bit; and the port reads the spec fixture and
reproduces the golden bytes of ``tests/test_params_format.py``, whose
independent spec writer builds the fixture here too.

Values are compared exactly: the format moves bytes, it computes
nothing."""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError

from test_params_format import _GOLDEN_HEX, _spec_write

DTYPES = ["float32", "float64", "float16", "uint8", "int8", "int32",
          "int64", "bfloat16"]
SHAPES = {"matrix": (3, 4), "scalar": (), "empty": (0, 3),
          "rank4": (2, 1, 3, 2)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _array(dtype, shape, seed=0):
    rng = np.random.RandomState(seed)
    a = np.asarray(rng.randn(*shape) * 50)
    if dtype == "bfloat16":
        return a.astype(np.float32).astype(ml_dtypes.bfloat16)
    return a.astype(dtype)


def _bits(a):
    """The raw bit patterns of an array (bfloat16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _as_torch(a):
    """The port's form of a host array: bf16 as a torch bf16 tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return a


def _port_bits(t):
    t = t._data if isinstance(t, mx.NDArray) else t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _payloads(dtype, shape):
    a, b = _array(dtype, shape, 0), _array(dtype, shape, 1)
    return {"dict": {"a": a, "b": b}, "list": [a, b], "single": a}


@pytest.mark.parametrize("container", ["dict", "list", "single"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_save_matches_the_jax_writer_byte_for_byte(tmp_path, dtype, shape,
                                                   container):
    data = _payloads(dtype, SHAPES[shape])[container]
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    if container == "single":        # one NDArray (64-bit narrowed)
        jmx.nd.save(jpath, jmx.nd.array(data))
        mx.nd.save(tpath, mx.nd.array(data))
    else:
        jmx.nd.save(jpath, data)
        mx.nd.save(tpath, data)
    want = open(jpath, "rb").read()
    assert open(tpath, "rb").read() == want
    # torch tensors and NDArrays (bf16 as a torch bf16 tensor) write the
    # same bytes as the host arrays they hold
    if container == "dict":
        as_t = {k: _as_torch(v) for k, v in data.items()}
        mx.nd.save(tpath, as_t)
        assert open(tpath, "rb").read() == want
        mx.nd.save(tpath, {k: mx.nd.NDArray(torch.as_tensor(v))
                           for k, v in as_t.items()})
        assert open(tpath, "rb").read() == want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_package_reads_the_other(tmp_path, dtype, shape):
    data = _payloads(dtype, SHAPES[shape])["dict"]
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, data)
    mx.nd.save(tpath, data)
    # the port reads the JAX file at the file's own dtypes
    got = mx.nd.ndarray.load_tensors(jpath)
    assert sorted(got) == ["a", "b"]
    for k, v in data.items():
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(_port_bits(got[k]), _bits(v))
    # both loads land 64-bit types at 32 bits, as each package's arrays
    narrow = {"float64": np.float32, "int64": np.int32}.get(dtype)
    for k, v in data.items():
        jv = jmx.nd.load(tpath)[k].asnumpy()
        tv = mx.nd.load(jpath)[k]
        want = v.astype(narrow) if narrow else v
        np.testing.assert_array_equal(_bits(jv), _bits(want))
        np.testing.assert_array_equal(_port_bits(tv), _bits(want))
        assert tv.context == mx.cpu()


def test_list_file_loads_as_a_list(tmp_path):
    path = str(tmp_path / "l.params")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    jmx.nd.save(path, [a, a * 2])
    got = mx.nd.load(path)
    assert isinstance(got, list) and len(got) == 2
    np.testing.assert_array_equal(got[1].asnumpy(), a * 2)


def test_spec_fixture_loads_into_the_ports_resnet50(tmp_path):
    """A container hand-written from the spec (``_spec_write``, not
    ``mx.nd.save``) loads into the port's zoo ResNet-50 and installs
    exactly the written weights; the loaded net runs."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1()
    net.initialize(device="cpu")
    x = mx.nd.ones((1, 3, 32, 32))
    net(x)                                   # materialize all shapes
    params = net._collect_params_with_prefix()
    rng = np.random.RandomState(7)
    fixture = {}
    for name, p in params.items():
        a = p.data().asnumpy()
        v = rng.randn(*a.shape) * 0.01
        if "var" in name:        # BN variances must stay positive
            v = np.abs(v) + 1.0
        fixture[name] = v.astype(a.dtype)
    path = str(tmp_path / "spec_resnet50.params")
    with open(path, "wb") as f:
        _spec_write(f, fixture)

    tensors = {k: p._data for k, p in params.items()}
    net.load_parameters(path, ctx=mx.cpu())
    for name, p in net._collect_params_with_prefix().items():
        np.testing.assert_array_equal(p.data().asnumpy(), fixture[name],
                                      err_msg=name)
        if p.grad_req != "null":          # values copied in, not rebound
            assert p._data is tensors[name], name
    out = net(x)
    assert out.shape == (1, 1000)
    assert np.isfinite(out.asnumpy()).all()


def test_spec_fixture_mixed_dtypes(tmp_path):
    """``mx.nd.load`` reads a spec-written file across dtypes and ranks;
    64-bit values land at 32 bits, as in the JAX package."""
    fixture = {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "idx": np.array([3, 1, 2], dtype=np.int64),
        "bytes": np.arange(8, dtype=np.uint8).reshape(2, 2, 2),
        "scalar": np.array(2.5, dtype=np.float64).reshape(()),
    }
    path = str(tmp_path / "mixed.params")
    with open(path, "wb") as f:
        _spec_write(f, fixture)
    loaded = mx.nd.load(path)
    assert set(loaded) == set(fixture)
    canon = {np.dtype("int64"): np.dtype("int32"),
             np.dtype("float64"): np.dtype("float32")}
    for k, v in fixture.items():
        got = loaded[k].asnumpy()
        assert got.dtype == canon.get(v.dtype, v.dtype), k
        np.testing.assert_array_equal(got, v.astype(got.dtype), err_msg=k)


def test_save_matches_the_spec_writer(tmp_path):
    fixture = {
        "w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": np.array([0.5, -1.5], dtype=np.float32),
    }
    lib_path = str(tmp_path / "lib.params")
    mx.nd.save(lib_path, {k: mx.nd.array(v) for k, v in fixture.items()})
    spec_path = str(tmp_path / "spec.params")
    with open(spec_path, "wb") as f:
        _spec_write(f, fixture)
    assert open(lib_path, "rb").read() == open(spec_path, "rb").read()


def test_golden_bytes(tmp_path):
    arr = np.array([[1.0, 2.0]], dtype=np.float32)
    path = str(tmp_path / "g.params")
    mx.nd.save(path, {"g": mx.nd.array(arr)})
    assert open(path, "rb").read().hex() == _GOLDEN_HEX
    gpath = str(tmp_path / "golden.params")
    open(gpath, "wb").write(bytes.fromhex(_GOLDEN_HEX))
    np.testing.assert_array_equal(mx.nd.load(gpath)["g"].asnumpy(), arr)


@pytest.mark.parametrize("damage", ["magic", "truncated", "name", "flag"])
def test_bad_files_raise(tmp_path, damage):
    path = str(tmp_path / "g.params")
    raw = bytearray.fromhex(_GOLDEN_HEX)
    if damage == "magic":
        raw[0] ^= 0xFF
    elif damage == "truncated":
        raw = raw[:60]
    elif damage == "name":
        raw = raw[:-1]                      # the name's last byte
    else:
        raw[24 + 4 + 4 + 4 + 16 + 8] = 99   # the dtype flag
    open(path, "wb").write(bytes(raw))
    with pytest.raises(MXNetError):
        mx.nd.load(path)


def test_save_refuses_a_dtype_without_a_flag(tmp_path):
    with pytest.raises(MXNetError, match="no .params flag"):
        mx.nd.save(str(tmp_path / "b.params"), {"m": np.array([True])})
