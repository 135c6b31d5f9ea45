"""``mx.Predictor``, ``export_compiled`` and ``mx.CompiledPredictor``
against the JAX package's (``tests/test_predictor.py``).

The same exported files (the port's export of a net carrying the JAX
net's weights) go through both packages' ``Predictor``: outputs within
1e-5 of the largest, the LRU of shape classes bounded alike, its
evictions counted in ``serving.compile_evictions`` alike.  The port's
``.mxa`` archive carries the block's symbol graph where the JAX
package's carries StableHLO (a fifth deviation: CUDA graphs have no
portable serialized form); it round-trips with no model code, and a
JAX archive raises naming that.
"""
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtelemetry

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, telemetry

from test_torch_export import max_rel, pair

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_matmul_precision("highest"), mx.cpu():
        yield


def convnet(pkg):
    """``tests/test_predictor.py``'s net."""
    net = pkg.nn.HybridSequential(prefix="pred_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(4, 3, padding=1, activation="relu"),
                pkg.nn.BatchNorm(), pkg.nn.Flatten(), pkg.nn.Dense(5))
    return net


@pytest.fixture
def exported(tmp_path):
    x = np.random.RandomState(0).randn(3, 3, 8, 8).astype(np.float32)
    jnet, tnet, jout, tout = pair(convnet, x)
    prefix = str(tmp_path / "m")
    tnet.export(prefix)
    return jnet, tnet, x, prefix


def test_predictor_matches_the_jax_predictor(exported):
    jnet, _tnet, x, prefix = exported
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    jpred = jmx.Predictor(*files)
    tpred = mx.Predictor(*files, ctx=mx.cpu())
    assert tpred._input_names == jpred._input_names == ["data"]
    assert tpred.output_count == jpred.output_count == 1
    jpred.forward(data=x)
    outs = tpred.forward(data=x)
    assert isinstance(outs[0], mx.NDArray) and outs[0].context.device_type \
        == "cpu"
    want = jpred.get_output(0).asnumpy()
    assert max_rel(tpred.get_output(0).asnumpy(), want) <= TOL
    assert max_rel(want, jnet(jmx.nd.array(x)).asnumpy()) <= TOL
    # the graph as JSON bytes, inputs as a tensor
    with open(files[0], "rb") as f:
        again = mx.Predictor(f.read(), files[1], ctx=mx.cpu())
    again.set_input("data", torch.from_numpy(x))
    assert max_rel(again.forward()[0].asnumpy(), want) <= TOL
    for pred, err in ((jpred, jmx.MXNetError), (tpred, MXNetError)):
        with pytest.raises(err, match="unknown input"):
            pred.set_input("not_an_input", x)
    with pytest.raises(MXNetError, match="forward"):
        mx.Predictor(*files, ctx=mx.cpu()).get_output(0)
    with pytest.raises(MXNetError, match="not set"):
        mx.Predictor(*files, ctx=mx.cpu()).forward()


def test_predictor_lru_matches_the_jax_predictor(exported):
    jnet, _tnet, _x, prefix = exported
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    shapes = [(1, 3, 8, 8), (2, 3, 8, 8), (3, 3, 8, 8)]
    data = {s: np.random.RandomState(s[0]).randn(*s).astype(np.float32)
            for s in shapes}
    counts = {}
    for name, tel, pred in (
            ("jax", jtelemetry,
             jmx.Predictor(*files, jit_cache_size=2)),
            ("port", telemetry,
             mx.Predictor(*files, ctx=mx.cpu(), jit_cache_size=2))):
        was_on = tel.enabled()
        tel.enable()
        tel.reset("serving.")
        try:
            seen = []
            for s in shapes:
                pred.forward(data=data[s])
            seen.append((len(pred._jit_cache),
                         tel.counter("serving.compile_evictions").value))
            xs = data[shapes[0]]        # evicted, then back
            got = pred.forward(data=xs)[0].asnumpy()
            seen.append(tel.counter("serving.compile_evictions").value)
            pred.forward(data=xs)       # resident: no eviction
            seen.append(tel.counter("serving.compile_evictions").value)
            counts[name] = seen
        finally:
            tel.reset("serving.")
            if not was_on:
                tel.disable()
        assert max_rel(got, jnet(jmx.nd.array(xs)).asnumpy()) <= TOL
    assert counts["port"] == counts["jax"] == [(2, 1), 2, 2]


def test_predictor_cache_bound_reads_the_environment(exported, monkeypatch):
    _jnet, _tnet, x, prefix = exported
    monkeypatch.setenv("MXNET_TPU_SERVING_PREDICTOR_CACHE", "1")
    pred = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                        ctx=mx.cpu())
    for b in (1, 2):
        pred.forward(data=x[:b])
    assert len(pred._jit_cache) == 1


def test_compiled_artifact_round_trip(exported, tmp_path):
    jnet, tnet, x, _prefix = exported
    path = str(tmp_path / "model.mxa")
    assert mx.predictor.export_compiled(tnet, path, [x.shape]) == path
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        meta = json.loads(z.read("meta.json"))
    assert names == {"meta.json", "forward-symbol.json", "weights.params"}
    assert sorted(meta) == ["input_dtype", "input_shapes", "num_outputs",
                            "param_names", "version"]
    assert meta["input_shapes"] == [list(x.shape)]
    assert meta["num_outputs"] == 1
    assert sorted(meta["param_names"]) == sorted(
        p.name for p in tnet.collect_params().values())
    served = mx.CompiledPredictor(path, ctx=mx.cpu())
    want = jnet(jmx.nd.array(x)).asnumpy()
    for inp in (mx.nd.array(x), x, torch.from_numpy(x)):
        outs = served(inp)
        assert isinstance(outs, list) and len(outs) == 1
        assert max_rel(outs[0].asnumpy(), want) <= TOL
    with pytest.raises(MXNetError, match="archive takes"):
        served(x[:1])


def test_compiled_artifact_of_the_jax_package_raises(tmp_path):
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(3, in_units=4))
    net.initialize()
    path = str(tmp_path / "jax.mxa")
    jmx.predictor.export_compiled(net, path, [(2, 4)])
    with pytest.raises(MXNetError, match="StableHLO"):
        mx.CompiledPredictor(path, ctx=mx.cpu())


def test_export_compiled_sizes_deferred_parameters(tmp_path):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(3))
    net.initialize(device="cpu")
    path = str(tmp_path / "deferred.mxa")
    mx.predictor.export_compiled(net, path, [(2, 4)])
    assert net[0].weight.shape == (3, 4)
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    got = mx.CompiledPredictor(path, ctx=mx.cpu())(x)[0].asnumpy()
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(MXNetError, match="HybridBlock"):
        mx.predictor.export_compiled(mx.gluon.nn.Sequential(), path, [(1,)])
