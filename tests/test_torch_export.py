"""``HybridBlock.export``, ``Parameter.var``, ``optimize_for`` and
``SymbolBlock`` against the JAX package (``tests/test_export.py``).

The same net is built in both packages with the same weights (drawn
from a seed with numpy, carried by name with ``params_from_numpy``),
exported under a fresh ``NameManager`` each, and the files compared:
the ``-symbol.json`` byte for byte, the ``.params`` keys and values
exactly.  Each package's ``SymbolBlock.imports`` of the other's files
answers within 1e-5 of the largest output.  The nets: the two of
``tests/test_export.py``, ResNet-50 v1 NCHW (the JAX kernel tier unset:
no fused node in either package) and ResNet-50 v1 channels-last, whose
JAX graph is traced with ``MXNET_TPU_KERNELS=1``.  The JAX package's
symbol trace of a fused site unpacks three outputs from a node its
probe counts as one (``mxnet_tpu/gluon/nn/basic_layers.py:209``,
``mxnet_tpu/symbol/symbol.py :: _probe_num_outputs``) and raises; the
channels-last case counts three there, as the port's node has, so the
JAX package writes the graph its plan describes.  The ResNets are held
by their files only (no JAX forward): the JAX net's deferred shapes are
set from the port's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet50_v1 as jresnet50
from mxnet_tpu.symbol import symbol as jsymbol

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.ndarray.ndarray import load_tensors

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_matmul_precision("highest"), mx.cpu():
        yield


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def seeded_weights(net, seed=0):
    """A numpy draw for every parameter of a JAX net (running variances
    positive, every other value off its default), set on it; returns
    ``{name: array}``."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in sorted(net.collect_params().items()):
        shape = tuple(p.shape)
        if name.endswith("running_var"):
            a = rng.rand(*shape) + 0.5
        elif name.endswith("gamma"):
            a = rng.rand(*shape) + 0.5
        else:
            a = 0.2 * rng.randn(*shape)
        arrays[name] = a.astype(np.float32)
        p.set_data(jmx.nd.array(arrays[name]))
    return arrays


def pair(make, x):
    """The JAX net run once on ``x`` (sizing its deferred parameters)
    with seeded weights, and the port's net with the same weights;
    returns ``(jax net, port net, jax output, port output)``."""
    jnet = make(jgluon)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    arrays = seeded_weights(jnet)
    tnet = make(gluon)
    tnet.initialize(device="cpu")
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    params_from_numpy(tnet, arrays, prefix=jnet.prefix)
    jnet.hybridize()
    tnet.hybridize()
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x)).numpy()
    return jnet, tnet, jnet(jmx.nd.array(x)).asnumpy(), tout


def export_both(jnet, tnet, tmp_path, tag, epoch=0):
    """Each package's export under a fresh ``NameManager``; returns the
    JAX and the port files."""
    with jmx.name.NameManager():
        jfiles = jnet.export(str(tmp_path / ("jax-" + tag)), epoch)
    with mx.name.NameManager():
        tfiles = tnet.export(str(tmp_path / ("port-" + tag)), epoch)
    return jfiles, tfiles


def assert_same_files(jfiles, tfiles):
    with open(jfiles[0]) as f:
        jjson = f.read()
    with open(tfiles[0]) as f:
        tjson = f.read()
    assert tjson == jjson
    jp = {k: v.asnumpy() for k, v in jmx.nd.load(jfiles[1]).items()}
    tp = load_tensors(tfiles[1])
    assert list(tp) == list(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)


def export_net(pkg):
    """``tests/test_export.py``'s round-trip net."""
    net = pkg.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(4, kernel_size=3, padding=1,
                              activation="relu"),
                pkg.nn.BatchNorm(), pkg.nn.MaxPool2D(2), pkg.nn.Flatten(),
                pkg.nn.Dense(10))
    return net


def mlp(pkg):
    """``tests/test_export.py``'s ``Module`` net."""
    net = pkg.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.nn.Dense(8, activation="relu"), pkg.nn.Dense(3))
    return net


NETS = {"export_net": (export_net, (2, 3, 8, 8)), "mlp": (mlp, (4, 6))}


@pytest.mark.parametrize("name", sorted(NETS))
def test_export_matches_the_jax_package(name, tmp_path):
    make, shape = NETS[name]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jnet, tnet, jout, tout = pair(make, x)
    assert max_rel(tout, jout) <= TOL
    jfiles, tfiles = export_both(jnet, tnet, tmp_path, name, epoch=3)
    assert tfiles == (str(tmp_path / ("port-%s-symbol.json" % name)),
                      str(tmp_path / ("port-%s-0003.params" % name)))
    assert_same_files(jfiles, tfiles)
    keys = list(load_tensors(tfiles[1]))
    assert {k.split(":")[0] for k in keys} <= {"arg", "aux"}
    assert any(k.startswith("aux:") for k in keys) == (name == "export_net")

    # each package's SymbolBlock reads the other's files
    jsb = jgluon.SymbolBlock.imports(tfiles[0], ["data"], tfiles[1])
    tsb = gluon.SymbolBlock.imports(jfiles[0], ["data"], jfiles[1],
                                    ctx=mx.cpu())
    assert max_rel(jsb(jmx.nd.array(x)).asnumpy(), jout) <= TOL
    with torch.no_grad():
        assert max_rel(tsb(torch.from_numpy(x)).numpy(), jout) <= TOL
        tsb.hybridize()
        for _ in range(2):
            got = tsb(mx.nd.array(x))
    assert isinstance(got, mx.NDArray)
    assert max_rel(got.asnumpy(), jout) <= TOL


def resnet_pair(layout, image=32):
    """Port ResNet-50 v1 run once at ``image``; the JAX net sized from
    it (no JAX forward) and both given the same seeded weights."""
    tnet = resnet50_v1(layout=layout, prefix="r50_")
    tnet.initialize(device="cpu")
    shape = (1, image, image, 3) if layout == "NHWC" \
        else (1, 3, image, image)
    with torch.no_grad():
        tnet(torch.zeros(shape))
    jnet = jresnet50(layout=layout, prefix="r50_")
    jnet.initialize()
    sizes = {p.name: tuple(p.shape) for p in tnet.collect_params().values()}
    for p in jnet.collect_params().values():
        if p._data is None:
            p.shape = sizes[p.name]
            p._finish_deferred_init()
    params_from_numpy(tnet, seeded_weights(jnet), prefix="r50_")
    return jnet, tnet


@pytest.fixture(scope="module")
def resnet_nchw():
    return resnet_pair("NCHW")


def test_resnet50_nchw_export_matches_the_jax_package(resnet_nchw, tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("MXNET_TPU_KERNELS", raising=False)
    jnet, tnet = resnet_nchw
    jfiles, tfiles = export_both(jnet, tnet, tmp_path, "r50")
    assert_same_files(jfiles, tfiles)
    with open(tfiles[0]) as f:
        ops = [n["op"] for n in json.load(f)["nodes"]]
    assert ops.count("BatchNorm") == 53
    assert "fused_batch_norm_relu" not in ops


def test_resnet50_channels_last_export_matches_the_jax_package(tmp_path,
                                                               monkeypatch):
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    probe = jsymbol._probe_num_outputs
    monkeypatch.setattr(jsymbol, "_probe_num_outputs", lambda op, node: (
        3 if op.name == "fused_batch_norm_relu" else probe(op, node)))
    jnet, tnet = resnet_pair("NHWC")
    jfiles, tfiles = export_both(jnet, tnet, tmp_path, "r50nhwc")
    assert_same_files(jfiles, tfiles)
    with open(tfiles[0]) as f:
        nodes = json.load(f)["nodes"]
    ops = [n["op"] for n in nodes]
    assert ops.count("fused_batch_norm_relu") == 33
    assert ops.count("BatchNorm") == 20
    # the port's graph computes what its tensor forward computes
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    sb = gluon.SymbolBlock.imports(tfiles[0], ["data"], tfiles[1],
                                   ctx=mx.cpu())
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
        assert max_rel(sb(torch.from_numpy(x)).numpy(), want) <= TOL


def test_jax_package_cannot_trace_a_fused_site_itself(monkeypatch):
    """The reference fault the channels-last case works round: with the
    tier armed, the JAX package's own trace of a fused site raises."""
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.BatchNorm(axis=-1, in_channels=4),
            jgluon.nn.Activation("relu"))
    net.initialize()
    with pytest.raises(ValueError, match="unpack"):
        net(jmx.sym.var("data"))
    tnet = gluon.nn.HybridSequential()
    tnet.add(gluon.nn.BatchNorm(axis=-1, in_channels=4),
             gluon.nn.Activation("relu"))
    tnet.initialize(device="cpu")
    out = tnet(mx.sym.var("data"))
    assert [n["op"] for n in json.loads(out.tojson())["nodes"]
            if n["op"] != "null"] == ["fused_batch_norm_relu"]


def test_parameter_var_matches_the_jax_package():
    jp = jgluon.Parameter("w", shape=(3, 4), dtype="float16")
    tp = gluon.Parameter("w", shape=(3, 4), dtype="float16")
    assert tp.var().tojson() == jp.var().tojson()
    assert json.loads(tp.var().tojson())["nodes"][0]["attrs"] == {
        "__shape__": "(3, 4)", "__dtype__": "float16"}


def test_exported_json_loads_as_module(tmp_path):
    """``tests/test_export.py``'s case on the port's export, and a
    ResNet-style net whose running statistics come as ``aux:``."""
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    jnet, tnet, jout, _ = pair(mlp, x)
    prefix = str(tmp_path / "m")
    tnet.export(prefix)
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=(),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 6))], for_training=False)
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)]), is_train=False)
    assert max_rel(mod.get_outputs()[0].asnumpy(), jout) <= TOL

    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype(np.float32)
    _jnet, tnet, jout, _ = pair(export_net, x)
    tnet.export(prefix)
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    assert sorted(k.rsplit("_", 2)[1:] for k in aux_params) == [
        ["running", "mean"], ["running", "var"]]
    mod = mx.mod.Module(sym, data_names=("data",), label_names=(),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)]), is_train=False)
    assert max_rel(mod.get_outputs()[0].asnumpy(), jout) <= TOL


def test_optimize_for_is_hybridize_and_call():
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    _jnet, tnet, jout, tout = pair(export_net, x)
    tnet.hybridize(False)
    with torch.no_grad():
        got = tnet.optimize_for(torch.from_numpy(x))
    assert tnet._active and tnet._cached_entries
    np.testing.assert_array_equal(got.numpy(), tout)
    assert max_rel(got.numpy(), jout) <= TOL


def test_symbol_block_from_symbols_and_its_parameters():
    data = mx.sym.var("data")
    out = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    rng = np.random.RandomState(4)
    w = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    sb = gluon.SymbolBlock(out, data, {"fc_weight": mx.nd.array(w),
                                       "aux:fc_bias": torch.from_numpy(b)})
    params = sb.collect_params()
    assert sorted(params.keys()) == ["fc_bias", "fc_weight"]
    assert params["fc_weight"].grad_req == "write"
    assert params["fc_bias"].grad_req == "null"
    x = rng.randn(2, 5).astype(np.float32)
    with torch.no_grad():
        got = sb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ w.T + b, rtol=1e-6, atol=1e-6)
    with pytest.raises(MXNetError, match="SymbolBlock"):
        sb(mx.sym.var("other"))


def test_export_of_an_untraceable_layer_names_it(tmp_path):
    class ShapeReader(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x.reshape(x.shape[0], -1)

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=3), ShapeReader())
    net.initialize(device="cpu")
    with pytest.raises(MXNetError, match="ShapeReader"):
        net.export(str(tmp_path / "bad"))


def test_a_fused_pair_needs_the_rank_the_net_last_ran_at():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.BatchNorm(axis=3, in_channels=4),
            gluon.nn.Activation("relu"))
    net.initialize(device="cpu")
    with pytest.raises(MXNetError, match="run the block once"):
        net(mx.sym.var("data"))
    with torch.no_grad():
        net(torch.zeros(1, 2, 2, 4))
    ops = [n["op"] for n in json.loads(net(mx.sym.var("data")).tojson())
           ["nodes"] if n["op"] != "null"]
    assert ops == ["fused_batch_norm_relu"]
    with torch.no_grad():
        net(torch.zeros(1, 2, 2, 4, 1))    # axis 3 is not the last now
    ops = [n["op"] for n in json.loads(net(mx.sym.var("data")).tojson())
           ["nodes"] if n["op"] != "null"]
    assert ops == ["BatchNorm", "Activation"]


def test_deployment_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """With no ``with mx.cpu():`` in force the deployment entry points
    land on the card, and raise without one."""
    net = mlp(gluon)
    net.initialize(device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 6))
    sym_file, params_file = net.export(str(tmp_path / "m"))
    mx.predictor.export_compiled(net, str(tmp_path / "m.mxa"), [(1, 6)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from mxnet_tpu_torch.context import Context
    monkeypatch.setattr(Context._default_ctx, "stack", [], raising=False)
    for call in (
            lambda: gluon.SymbolBlock.imports(sym_file, ["data"],
                                              params_file),
            lambda: mx.Predictor(sym_file, params_file),
            lambda: mx.CompiledPredictor(str(tmp_path / "m.mxa")),
            lambda: mx.serving.ModelRegistry().register(
                "m", symbol=sym_file, params=params_file,
                input_shape=(6,))):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            call()
    assert os.path.exists(sym_file)
