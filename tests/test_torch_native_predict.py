"""The C predict runtime built from the port's copy of
``predict_native.cc`` (``mxnet_tpu_torch/_native``) against the JAX
package's build of its own (``tests/test_native_predict.py``).

Both libraries come from the same source with the same flags, so on the
same ONNX file (the port's export) their logits are bitwise equal, and
within 1e-4 relative / 1e-5 absolute of the port's net.  The C example
``examples/cpp_predict/main.cc`` builds against the port's library and
runs as a plain process; the ``MXNDList*`` ABI reads a ``.params`` file
the port wrote; without the library ``NativePredictor`` raises.
"""
import ctypes
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.predictor import NativePredictor as JNativePredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, _native
from mxnet_tpu_torch.predictor import NativePredictor

from test_native_predict import _repack_tensor_dims
from test_torch_export import pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_matmul_precision("highest"), mx.cpu():
        yield


@pytest.fixture(scope="module")
def lib():
    lib = _native.load_predict()
    if lib is None:
        pytest.skip("no C++ toolchain")
    return lib


def lenet(pkg):
    net = pkg.nn.HybridSequential(prefix="lenet_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, kernel_size=5, activation="relu"),
                pkg.nn.MaxPool2D(2, 2),
                pkg.nn.Conv2D(16, kernel_size=5, activation="relu"),
                pkg.nn.MaxPool2D(2, 2), pkg.nn.Flatten(),
                pkg.nn.Dense(32, activation="relu"), pkg.nn.Dense(10))
    return net


def bn_block(pkg):
    """``test_native_predictor_batchnorm_resnet_block``'s net."""
    net = pkg.nn.HybridSequential(prefix="bnblock_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, 3, padding=1, use_bias=False),
                pkg.nn.BatchNorm(), pkg.nn.Activation("relu"),
                pkg.nn.GlobalAvgPool2D(), pkg.nn.Flatten(),
                pkg.nn.Dense(4))
    return net


NETS = {"lenet": (lenet, (2, 1, 28, 28)), "bn_block": (bn_block,
                                                       (2, 3, 16, 16))}


def export_onnx(make, shape, tmp_path, name, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    _jnet, tnet, _jout, want = pair(make, x)
    sym_file, params_file = tnet.export(str(tmp_path / name))
    path = str(tmp_path / (name + ".onnx"))
    mx.onnx.export_model(sym_file, params_file, in_shapes=[x.shape],
                         onnx_file_path=path)
    return path, x, want


@pytest.mark.parametrize("name", sorted(NETS))
def test_native_predictor_matches_the_jax_one_bitwise(lib, name, tmp_path):
    path, x, want = export_onnx(*NETS[name], tmp_path, name)
    pred = NativePredictor(path)
    got = pred.forward(mx.nd.array(x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jpred = JNativePredictor(path)
    np.testing.assert_array_equal(got, jpred.forward(x))
    np.testing.assert_array_equal(pred.forward(torch.from_numpy(x)), got)
    pred.close()
    jpred.close()


def test_native_predictor_reads_packed_dims(lib, tmp_path):
    path, x, want = export_onnx(lenet, (2, 1, 28, 28), tmp_path, "packed",
                                seed=3)
    with open(path, "rb") as f:
        raw = f.read()
    repacked = _repack_tensor_dims(raw)
    assert repacked != raw
    packed = tmp_path / "packed2.onnx"
    packed.write_bytes(repacked)
    got = NativePredictor(str(packed)).forward(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpp_example_builds_against_the_ports_library(lib, tmp_path):
    path, _x, _want = export_onnx(lenet, (1, 1, 28, 28), tmp_path, "c",
                                  seed=2)
    so = _native.predict_so_path()
    assert so.is_relative_to(os.path.join(REPO, "build")) \
        or "MXNET_TPU_NATIVE_CACHE" in os.environ
    exe = str(tmp_path / "cpp_predict")
    build = subprocess.run(
        ["g++", "-O2", "-std=c++17",
         os.path.join(REPO, "examples", "cpp_predict", "main.cc"), "-o",
         exe, str(so), "-Wl,-rpath," + str(so.parent)],
        capture_output=True, text=True, timeout=180)
    assert build.returncode == 0, build.stderr[-2000:]
    params_file = str(tmp_path / "weights.params")
    mx.nd.save(params_file, {"w": mx.nd.array(np.full((2, 2), 7.0,
                                                      np.float32))})
    run = subprocess.run([exe, path, "1", "1", "28", "28", params_file],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "output shape: (1, 10)" in run.stdout
    assert "params: 1 arrays" in run.stdout
    assert "w rank=2 first=7.0" in run.stdout


def test_ndlist_reads_params_the_port_wrote(lib, tmp_path):
    rng = np.random.RandomState(0)
    fixture = {"w": rng.randn(3, 4).astype(np.float32),
               "idx": np.array([5, 1, 9], np.int32),
               "bytes": np.arange(6, dtype=np.uint8).reshape(2, 3),
               "half": np.array([0.5, -2.25, 64.0], np.float16)}
    arrays = {k: mx.nd.array(v, dtype=v.dtype) for k, v in fixture.items()}
    arrays["bf"] = mx.nd.array(np.array([1.5, -3.0], np.float32)).astype(
        "bfloat16")
    fixture["bf"] = np.array([1.5, -3.0], np.float32)
    path = str(tmp_path / "mixed.params")
    mx.nd.save(path, arrays)
    lib.MXNDListCreateFromFile.restype = ctypes.c_int
    lib.MXNDListGet.restype = ctypes.c_int
    h, count = ctypes.c_void_p(), ctypes.c_int64()
    assert lib.MXNDListCreateFromFile(path.encode(), ctypes.byref(h),
                                      ctypes.byref(count)) == 0
    seen = {}
    for i in range(count.value):
        key = ctypes.c_char_p()
        data = ctypes.POINTER(ctypes.c_float)()
        shape = ctypes.POINTER(ctypes.c_int64)()
        ndim = ctypes.c_int()
        assert lib.MXNDListGet(h, ctypes.c_int64(i), ctypes.byref(key),
                               ctypes.byref(data), ctypes.byref(shape),
                               ctypes.byref(ndim)) == 0
        shp = tuple(shape[d] for d in range(ndim.value))
        seen[key.value.decode()] = np.array(
            [data[j] for j in range(int(np.prod(shp)))],
            np.float32).reshape(shp)
    lib.MXNDListFree(h)
    assert set(seen) == set(fixture)
    for k, v in fixture.items():
        np.testing.assert_allclose(seen[k], v.astype(np.float32),
                                   rtol=1e-3, err_msg=k)


def test_native_predictor_raises_without_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_PRED_TRIED", False)
    monkeypatch.setattr(_native, "_PRED_LIB", None)
    monkeypatch.setenv("MXNET_TPU_NATIVE", "0")
    with pytest.raises(MXNetError, match="unavailable"):
        NativePredictor(str(tmp_path / "missing.onnx"))
