"""Post-training int8 quantization in the port
(``mx.contrib.quantization``) against the JAX package's on the CPU:
every case of ``tests/test_quantization.py`` through the port, the
``naive`` and ``entropy`` thresholds of ``calibrate`` within 1e-6 of the
JAX package's on the same weights and batches (the layers between
differ by float32 rounding), and for the same graph and thresholds the
quantized ``-symbol.json`` byte for byte the JAX package's, its int8
parameters equal, and every value of the graph equal to the JAX
package's on LeNet and on a small convolutional net.

Both packages' nets take one prefix, so their parameters and nodes have
the same names; weights carry from the port's net to the JAX net by
name.  The int8 ops are exact (``tests/test_torch_contrib_ops.py`` holds
each bitwise), but a graph's float32 layers are not: the JAX package
compiles a graph whole, and XLA reassociates a dequantize's scale with
the range computed before it (one ulp), and the convolutional net's
stem stays float32 (excluded, as the ResNet-50 recipe excludes its
stem).  So LeNet, whose float32 ops between the int8 ones are exact
(relu, max pooling, flatten), is held bitwise in every int8 and int32
value and to 1e-6 in every float32 one; the convolutional net to one
int8 step in under 1% of an int8 tensor's entries and every other value
to 2% of its tensor's largest magnitude (what one step moves).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.contrib import quantization as jq

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.contrib.quantization import (calibrate, quantize_graph,
                                                  quantize_model)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _export_sym(net, x):
    """A port block traced to ``(sym, arg_params, aux_params)`` (under a
    fresh ``NameManager``, as the JAX block is, so the auto-named nodes
    agree)."""
    net(tmx.nd.array(x))
    with tmx.name.NameManager():
        sym = net(tmx.sym.var("data"))
    arg, aux = {}, {}
    for p in net.collect_params().values():
        (aux if p.grad_req == "null" else arg)[p.name] = p.data()
    return sym, arg, aux


def _jax_export(jnet, net, x):
    """The JAX block with the port block's weights, traced."""
    jnet(jmx.nd.array(x))
    for p in jnet.collect_params().values():
        p.set_data(jmx.nd.array(net.collect_params()[p.name].data()
                                .asnumpy()))
    with jmx.name.NameManager():
        sym = jnet(jmx.sym.var("data"))
    arg, aux = {}, {}
    for p in jnet._all_params():
        (aux if p._grad_req == "null" else arg)[p.name] = p.data()
    return sym, arg, aux


def _eval(sym, arg, aux, x, pkg=tmx, all_outputs=False):
    feeds = dict(arg)
    feeds.update(aux)
    feeds["data"] = pkg.nd.array(x)
    out = sym.eval(**feeds)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    if all_outputs:
        return [o.asnumpy() for o in out]
    return out[0].asnumpy()


def _lenet(gl, prefix="lenet_"):
    net = gl.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gl.nn.Conv2D(8, kernel_size=3, activation="relu"),
                gl.nn.MaxPool2D(2, 2),
                gl.nn.Flatten(),
                gl.nn.Dense(16, activation="relu"),
                gl.nn.Dense(4))
    return net


def _convnet(gl, prefix="conv_"):
    net = gl.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gl.nn.Conv2D(8, kernel_size=3, padding=1, activation="relu"),
                gl.nn.Conv2D(16, kernel_size=3, strides=2, use_bias=False),
                gl.nn.Activation("relu"),
                gl.nn.MaxPool2D(2, 2),
                gl.nn.Conv2D(8, kernel_size=1),
                gl.nn.Flatten(),
                gl.nn.Dense(5))
    return net


def _port_net(make, shape=(2, 1, 12, 12)):
    """The port's net with a JAX-initialized net's weights (the JAX
    tests' draws, from a fixed seed whatever ran before in the process),
    hybridized."""
    jmx.random.seed(0)
    jnet = make(jgluon)
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.zeros(shape))
    net = make(gluon)
    net.initialize(device="cpu")
    net(tmx.nd.zeros(shape))
    for p in net.collect_params().values():
        p.set_data(tmx.nd.array(jnet.collect_params()[p.name].data()
                                .asnumpy()))
    net.hybridize()
    return net


def _jax_net(make):
    net = make(jgluon)
    net.initialize(ctx=jmx.cpu())
    net.hybridize()
    return net


# -- tests/test_quantization.py, on the port -------------------------------

def test_quantized_graph_close_to_fp32():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 1, 12, 12).astype(np.float32)
    sym, arg, aux = _export_sym(_port_net(_lenet), x)
    want = _eval(sym, arg, aux, x)
    for mode in ("naive", "entropy"):
        qsym, qarg, qaux = quantize_model(
            sym, arg, aux, calib_mode=mode,
            calib_data=[x, rng.randn(4, 1, 12, 12).astype(np.float32)])
        got = _eval(qsym, qarg, qaux, x)
        assert got.shape == want.shape
        scale = np.abs(want).max() or 1.0
        assert np.abs(got - want).max() / scale < 0.1, mode


def test_calibrate_thresholds():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 1, 12, 12).astype(np.float32)
    sym, arg, aux = _export_sym(_port_net(_lenet), x)
    th = calibrate(sym, arg, aux, [x], calib_mode="naive")
    assert th, "no thresholds collected"
    for lo, hi in th.values():
        assert lo == -hi and hi > 0
    th_e = calibrate(sym, arg, aux, [x], calib_mode="entropy")
    assert set(th_e) == set(th)
    for k in th:
        assert 0 < th_e[k][1] <= th[k][1] * 1.001


def test_excluded_sym_names():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 1, 12, 12).astype(np.float32)
    sym, arg, aux = _export_sym(_port_net(_lenet), x)
    conv_names = [n.name for n in sym._topo() if n.op == "Convolution"]
    qsym, qarg, _ = quantize_graph(sym, arg, aux, {},
                                   excluded_sym_names=tuple(conv_names))
    ops = [n.op for n in qsym._topo()]
    assert "Convolution" in ops
    assert "quantized_fully_connected" in ops
    assert "quantized_conv" not in ops


def test_quantize_model_validations():
    x = np.zeros((2, 1, 12, 12), np.float32)
    sym, arg, aux = _export_sym(_port_net(_lenet), x)
    with pytest.raises(MXNetError):
        quantize_model(sym, arg, aux, calib_mode="entropy", calib_data=None)
    with pytest.raises(MXNetError):
        quantize_model(sym, arg, aux, quantized_dtype="uint8",
                       calib_mode="none")
    with pytest.raises(MXNetError, match="calib_mode"):
        calibrate(sym, arg, aux, [x], calib_mode="kl")
    with pytest.raises(MXNetError, match="no batches"):
        calibrate(sym, arg, aux, [], calib_mode="naive")


def test_mnist_accuracy_drop_below_1pct():
    """The reference's acceptance bar: int8 accuracy within 1% of fp32
    on synthetic separable digits."""
    rng = np.random.RandomState(3)
    n_class, n, d = 4, 256, (1, 12, 12)
    protos = rng.randn(n_class, *d).astype(np.float32) * 2.0
    ys = rng.randint(0, n_class, (n,))
    xs = protos[ys] + rng.randn(n, *d).astype(np.float32) * 0.7
    net = _port_net(_lenet)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3}, kvstore=None)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    bs = 32
    net(tmx.nd.array(xs[:bs]))
    for _ in range(6):
        for i in range(0, n, bs):
            xb = tmx.nd.array(xs[i:i + bs])
            yb = tmx.nd.array(ys[i:i + bs].astype(np.float32))
            with autograd.record():
                loss = loss_fn(net(xb), yb).mean()
            loss.backward()
            trainer.step(bs)
    sym, arg, aux = _export_sym(net, xs[:bs])
    fp32_acc = float((_eval(sym, arg, aux, xs).argmax(1) == ys).mean())
    assert fp32_acc > 0.9, "fp32 net failed to train (acc %.2f)" % fp32_acc
    qsym, qarg, qaux = quantize_model(
        sym, arg, aux, calib_mode="entropy",
        calib_data=[xs[i:i + bs] for i in range(0, 128, bs)])
    q_acc = float((_eval(qsym, qarg, qaux, xs).argmax(1) == ys).mean())
    assert fp32_acc - q_acc < 0.01, \
        "int8 accuracy dropped %.3f -> %.3f" % (fp32_acc, q_acc)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("make", [_lenet, _convnet],
                         ids=["lenet", "convnet"])
@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_thresholds_json_and_outputs_equal_the_jax_package(make, mode):
    rng = np.random.RandomState(4)
    shape = (4, 1, 12, 12) if make is _lenet else (4, 3, 16, 16)
    x = rng.randn(*shape).astype(np.float32)
    calib = [x, rng.randn(*shape).astype(np.float32) * 1.5]
    net = _port_net(make, shape)
    sym, arg, aux = _export_sym(net, x)
    jsym, jarg, jaux = _jax_export(_jax_net(make), net, x)
    assert sym.tojson() == jsym.tojson()

    th = calibrate(sym, arg, aux, calib, calib_mode=mode)
    jth = jq.calibrate(jsym, jarg, jaux, calib, calib_mode=mode)
    assert sorted(th) == sorted(jth) and th
    for k in th:
        np.testing.assert_allclose(th[k], jth[k], rtol=1e-6, atol=0)

    # the same graph and thresholds give the same quantized graph: the
    # thresholds above differ by float32 rounding of the layers between
    stem = [n.name for n in sym._topo() if n.op == "Convolution"][:1]
    qsym, qarg, qaux = quantize_graph(sym, arg, aux, jth,
                                      excluded_sym_names=stem)
    jqsym, jqarg, jqaux = jq.quantize_graph(jsym, jarg, jaux, jth,
                                            excluded_sym_names=stem)
    assert qsym.tojson() == jqsym.tojson()
    ops = [n["op"] for n in json.loads(qsym.tojson())["nodes"]]
    assert "quantized_conv" in ops or make is _lenet
    assert sorted(qarg) == sorted(jqarg)
    for k in qarg:
        np.testing.assert_array_equal(qarg[k].asnumpy(), jqarg[k].asnumpy())
        assert qarg[k].dtype == jqarg[k].dtype, k
    got = _eval(qsym.get_internals(), qarg, qaux, x, all_outputs=True)
    want = _eval(jqsym.get_internals(), jqarg, jqaux, x, pkg=jmx,
                 all_outputs=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if make is _lenet and g.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(g, w)
        elif g.dtype == np.int8:
            # a float32 input one ulp apart may round to the next step
            diff = np.abs(g.astype(np.int32) - w)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        elif make is _lenet:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2e-2 * np.abs(w).max())


def test_quantize_graph_ties_weights_and_keeps_fp32_users():
    """A weight shared by a quantized node and an excluded one keeps its
    float32 entry beside its int8 one, in both packages; a bias-less
    node gets the zero-range bias inputs."""
    def graph(sym):
        data = sym.var("data")
        w = sym.var("shared_weight")
        a = sym.FullyConnected(data, weight=w, num_hidden=4, no_bias=True,
                               name="fc_a")
        b = sym.FullyConnected(data, weight=w, num_hidden=4, no_bias=True,
                               name="fc_b")
        return sym.Group([a, b])
    wv = np.random.RandomState(5).randn(4, 6).astype(np.float32)
    x = np.random.RandomState(6).randn(3, 6).astype(np.float32)
    res = []
    for pkg, quant in ((tmx, quantize_graph), (jmx, jq.quantize_graph)):
        qsym, qarg, _ = quant(graph(pkg.sym),
                              {"shared_weight": pkg.nd.array(wv)}, {},
                              {"data": (-3.0, 3.0)},
                              excluded_sym_names=("fc_b",))
        feeds = dict(qarg)
        feeds["data"] = pkg.nd.array(x)
        res.append((qsym.tojson(), sorted(qarg),
                    [o.asnumpy() for o in qsym.eval(**feeds)]))
    assert res[0][0] == res[1][0]
    assert res[0][1] == res[1][1]
    assert {"shared_weight", "shared_weight_quantized",
            "fc_a_nobias"} <= set(res[0][1])
    for g, w in zip(res[0][2], res[1][2]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dist", ["normal", "laplace", "sparse", "zeros"])
def test_entropy_threshold_equals_the_jax_package(dist):
    from mxnet_tpu_torch.contrib.quantization import \
        _optimal_threshold_entropy
    rng = np.random.RandomState(7)
    arr = {"normal": rng.randn(5000),
           "laplace": rng.laplace(size=5000),
           "sparse": rng.randn(5000) * (rng.rand(5000) < 0.05),
           "zeros": np.zeros(10)}[dist].astype(np.float32)
    assert _optimal_threshold_entropy(arr) == \
        jq._optimal_threshold_entropy(arr)
