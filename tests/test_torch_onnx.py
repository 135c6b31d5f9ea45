"""``mx.onnx`` against the JAX package's (``tests/test_onnx.py``).

Both exporters write the same bytes from the same graph and weights
(LeNet, and ResNet-50 v1 NCHW at 64²); the port imports the JAX
package's file and answers as the JAX net does; the wire codec gives
the JAX package's bytes and values; the importer's third-party idioms,
its ``auto_pad`` and garbage rejections and the exporter's ``dot`` rank
guard behave as the JAX package's, case by case; and a channels-last
graph does not convert, with the JAX package's errors.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import onnx as jonnx
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock
from mxnet_tpu.onnx import wire as jwire

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.onnx import wire

from test_torch_export import export_both, max_rel, pair, resnet_pair

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_matmul_precision("highest"), mx.cpu():
        yield


def lenet(pkg):
    net = pkg.nn.HybridSequential(prefix="lenet_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, kernel_size=5, activation="relu"),
                pkg.nn.MaxPool2D(2, 2),
                pkg.nn.Conv2D(16, kernel_size=5, activation="relu"),
                pkg.nn.MaxPool2D(2, 2), pkg.nn.Flatten(),
                pkg.nn.Dense(32, activation="relu"), pkg.nn.Dense(10))
    return net


def onnx_both(jfiles, tfiles, shape, tmp_path, tag):
    """Each package's ONNX file of its own export; returns the paths."""
    jpath = jonnx.export_model(jfiles[0], jfiles[1], in_shapes=[shape],
                               in_types=[np.float32],
                               onnx_file_path=str(tmp_path / ("j%s.onnx"
                                                              % tag)))
    tpath = mx.onnx.export_model(tfiles[0], tfiles[1], in_shapes=[shape],
                                 in_types=[np.float32],
                                 onnx_file_path=str(tmp_path / ("t%s.onnx"
                                                                % tag)))
    return jpath, tpath


def read(path):
    with open(path, "rb") as f:
        return f.read()


def port_forward(path, x):
    """The port's import of an ONNX file run on ``x`` as a SymbolBlock."""
    sym, arg_params, aux_params = mx.onnx.import_model(path)
    assert all(v.context.device_type == "cpu"
               for v in list(arg_params.values())
               + list(aux_params.values()))
    sb = gluon.SymbolBlock(sym, ["data"], {**arg_params, **aux_params})
    with torch.no_grad():
        return sb(torch.from_numpy(x)).numpy()


def test_lenet_onnx_matches_the_jax_package(tmp_path):
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    jnet, tnet, jout, _ = pair(lenet, x)
    jfiles, tfiles = export_both(jnet, tnet, tmp_path, "lenet")
    jpath, tpath = onnx_both(jfiles, tfiles, x.shape, tmp_path, "lenet")
    assert read(tpath) == read(jpath)
    assert mx.onnx.get_model_metadata(tpath) \
        == jonnx.get_model_metadata(jpath)
    # the port reads the JAX package's file, and the JAX package the port's
    assert max_rel(port_forward(jpath, x), jout) <= TOL
    jsym, jarg, jaux = jonnx.import_model(tpath)
    jsb = JSymbolBlock(jsym, ["data"], {**jarg, **jaux})
    assert max_rel(jsb(jmx.nd.array(x)).asnumpy(), jout) <= TOL


def test_resnet50_onnx_matches_the_jax_package(tmp_path):
    jnet, tnet = resnet_pair("NCHW", image=64)
    jfiles, tfiles = export_both(jnet, tnet, tmp_path, "r50")
    jpath, tpath = onnx_both(jfiles, tfiles, (1, 3, 64, 64), tmp_path, "r50")
    jbytes = read(jpath)
    assert read(tpath) == jbytes
    ops = [n["op_type"] for n in wire.parse_model(jbytes)["graph"]["nodes"]]
    assert {"BatchNormalization", "GlobalAveragePool", "Add"} <= set(ops)
    x = np.random.RandomState(1).randn(1, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    assert max_rel(port_forward(jpath, x), want) <= TOL


WIRE_VALUES = [1.5, 7, "hello", [1, 2, 3], [1.0, 2.5], ["a", "b"]]


@pytest.mark.parametrize("value", WIRE_VALUES + ["tensor"],
                         ids=[type(v).__name__ + str(i)
                              for i, v in enumerate(WIRE_VALUES)]
                         + ["tensor"])
def test_wire_codec_matches_the_jax_package(value):
    if value == "tensor":
        for arr in (np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                    np.asarray([3, -1, 0], np.int64)):
            buf = wire.make_tensor("t", arr)
            assert buf == jwire.make_tensor("t", arr)
            name, back = wire.parse_tensor(buf)
            assert name == "t"
            np.testing.assert_array_equal(back, arr)
        return
    buf = wire.make_attr("k", value)
    assert buf == jwire.make_attr("k", value)
    k, v = wire.parse_attr(buf)
    assert k == "k"
    assert (list(v) if isinstance(value, list) else v) == value


def third_party_graph():
    """``tests/test_onnx.py :: test_third_party_graph_idioms``' model."""
    rng = np.random.RandomState(0)
    weights = [("W", rng.randn(4, 3, 3, 3) * 0.1),
               ("gamma", rng.rand(4) + 0.5), ("beta", rng.randn(4) * 0.1),
               ("mean", rng.randn(4) * 0.1), ("var", rng.rand(4) + 0.5),
               ("Wfc", rng.randn(5, 4) * 0.1), ("bfc", rng.randn(5) * 0.1)]
    weights = [(n, v.astype(np.float32)) for n, v in weights]
    nodes = [
        wire.make_node("Conv", ["data", "W"], ["c1"], "c1",
                       {"auto_pad": "SAME_UPPER"}),
        wire.make_node("BatchNormalization",
                       ["c1", "gamma", "beta", "mean", "var"], ["bn1"],
                       "bn1", {"epsilon": 1e-5, "spatial": 1,
                               "momentum": 0.9}),
        wire.make_node("Relu", ["bn1"], ["r1"], "r1"),
        wire.make_node("MaxPool", ["r1"], ["p1"], "p1",
                       {"kernel_shape": [2, 2], "strides": [2, 2]}),
        wire.make_node("ReduceMean", ["p1"], ["gap"], "gap",
                       {"axes": [2, 3], "keepdims": 0}),
        wire.make_node("Constant", [], ["shape_c"], "shape_c",
                       {"value": np.asarray([0, -1], np.int64)}),
        wire.make_node("Reshape", ["gap", "shape_c"], ["flat"], "flat"),
        wire.make_node("Gemm", ["flat", "Wfc", "bfc"], ["out"], "out",
                       {"alpha": 1.0, "beta": 1.0, "transB": 1})]
    inputs = [wire.make_value_info("data", wire.DT_FLOAT, (1, 3, 8, 8))]
    inputs += [wire.make_value_info(n, wire.DT_FLOAT, v.shape)
               for n, v in weights]
    return wire.make_model(wire.make_graph(
        nodes, "tp", inputs, [wire.make_value_info("out", wire.DT_FLOAT,
                                                   ())],
        [wire.make_tensor(n, v) for n, v in weights])), (2, 3, 8, 8)


def attr_idioms():
    """``test_third_party_attr_idioms``' model."""
    nodes = [
        wire.make_node("AveragePool", ["data"], ["ap"], "ap",
                       {"kernel_shape": [3, 3], "strides": [1, 1],
                        "pads": [1, 1, 1, 1]}),
        wire.make_node("Reshape", ["ap"], ["rs"], "rs", {"shape": [1, 32]}),
        wire.make_node("Unsqueeze", ["rs"], ["un"], "un", {"axes": [0, 3]}),
        wire.make_node("Squeeze", ["un"], ["out"], "out", {"axes": [0, 3]})]
    inputs = [wire.make_value_info("data", wire.DT_FLOAT, (1, 2, 4, 4))]
    return wire.make_model(wire.make_graph(
        nodes, "attrs", inputs,
        [wire.make_value_info("out", wire.DT_FLOAT, ())], [])), (1, 2, 4, 4)


def auto_pad_stride():
    """``test_auto_pad_stride_rejected``' model: SAME_* with stride 2."""
    nodes = [wire.make_node("Conv", ["data", "W"], ["c"], "c",
                            {"auto_pad": "SAME_UPPER", "strides": [2, 2]})]
    inputs = [wire.make_value_info("data", wire.DT_FLOAT, (1, 1, 8, 8))]
    return wire.make_model(wire.make_graph(
        nodes, "g", inputs, [wire.make_value_info("c", wire.DT_FLOAT, ())],
        [wire.make_tensor("W", np.zeros((2, 1, 3, 3), np.float32))])), None


def garbage():
    return b"\xff\xff\xff\xff", None


IMPORT_CASES = {"third_party_graph": third_party_graph,
                "attr_idioms": attr_idioms,
                "auto_pad_stride": auto_pad_stride, "garbage": garbage}


@pytest.mark.parametrize("case", sorted(IMPORT_CASES))
def test_import_case_matches_the_jax_package(case, tmp_path):
    model, shape = IMPORT_CASES[case]()
    path = tmp_path / (case + ".onnx")
    path.write_bytes(model)
    try:
        jsym, jarg, jaux = jonnx.import_model(str(path))
    except JMXNetError as e:
        with pytest.raises(MXNetError) as got:
            mx.onnx.import_model(str(path))
        assert str(got.value) == str(e)
        assert shape is None
        return
    tsym, targ, taux = mx.onnx.import_model(str(path))
    assert tsym.tojson() == jsym.tojson()
    assert sorted(taux) == sorted(jaux) and sorted(targ) == sorted(jarg)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = JSymbolBlock(jsym, ["data"], {**jarg, **jaux})(
        jmx.nd.array(x)).asnumpy()
    got = gluon.SymbolBlock(tsym, ["data"], {**targ, **taux})
    with torch.no_grad():
        assert max_rel(got(torch.from_numpy(x)).numpy(), want) <= TOL


@pytest.mark.parametrize("rhs,in_shape", [((4, 5), (3, 4)),
                                          ((2, 4, 5), (3, 2, 4)),
                                          ((4, 5), None)],
                         ids=["rank2", "rank3", "unknown_rank"])
def test_dot_export_matches_the_jax_package(rhs, in_shape, tmp_path):
    b = np.random.RandomState(0).randn(*rhs).astype(np.float32)
    jout = jmx.sym.dot(jmx.sym.Variable("a"), jmx.sym.Variable("b"),
                       name="dot")
    tout = mx.sym.dot(mx.sym.Variable("a"), mx.sym.Variable("b"),
                      name="dot")
    shapes = [in_shape] if in_shape else None
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    try:
        jonnx.export_model(jout, {"b": jmx.nd.array(b)} if in_shape
                           else {}, in_shapes=shapes, onnx_file_path=jpath)
    except JMXNetError as e:
        with pytest.raises(MXNetError) as got:
            mx.onnx.export_model(tout, {"b": mx.nd.array(b)} if in_shape
                                 else {}, in_shapes=shapes,
                                 onnx_file_path=tpath)
        assert str(got.value) == str(e)
        return
    mx.onnx.export_model(tout, {"b": mx.nd.array(b)}, in_shapes=shapes,
                         onnx_file_path=tpath)
    assert read(tpath) == read(jpath)


def test_channels_last_graphs_do_not_convert(tmp_path):
    """The JAX package's exporter stops at a channels-last convolution,
    and has no converter for ``fused_batch_norm_relu``: the port's
    raises the same errors."""
    x = np.random.RandomState(2).randn(1, 6, 6, 3).astype(np.float32)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, 3, layout="NHWC", in_channels=3),
            gluon.nn.BatchNorm(axis=3), gluon.nn.Activation("relu"))
    net.initialize(device="cpu")
    with torch.no_grad():
        net(torch.from_numpy(x))
    sym_file, params_file = net.export(str(tmp_path / "nhwc"))
    jmsgs, tmsgs = [], []
    for pkg, msgs, err in ((jmx, jmsgs, JMXNetError),
                           (mx, tmsgs, MXNetError)):
        fused = pkg.sym.fused_batch_norm_relu(
            pkg.sym.var("data"), pkg.sym.var("gamma"), pkg.sym.var("beta"),
            pkg.sym.var("mean"), pkg.sym.var("var"), axis=3)
        if len(fused) > 1:
            fused = fused[0]
        for call in (
                lambda: pkg.onnx.export_model(
                    sym_file, params_file, in_shapes=[x.shape],
                    onnx_file_path=str(tmp_path / "a.onnx")),
                lambda: pkg.onnx.export_model(
                    fused, {}, in_shapes=[(1, 4, 4, 8)] + [(8,)] * 4,
                    onnx_file_path=str(tmp_path / "b.onnx"))):
            with pytest.raises(err) as e:
                call()
            msgs.append(str(e.value))
    assert tmsgs == jmsgs
    assert "channels-last Convolution" in tmsgs[0]
    assert "fused_batch_norm_relu" in tmsgs[1]
