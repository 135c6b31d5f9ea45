"""The port's compiled paths on the CPU, where a cache entry is the
eager call under the key the card's captured graph would have
(``mxnet_tpu_torch.gluon.block.HybridBlock``, ``parallel.TrainStep``),
against the JAX package's hybridized blocks and ``TrainStep``: the same
numpy inputs through both.

Tolerances: forwards and gradients 1e-5 relative / 1e-6 absolute (fp32
products summed in another order by two libraries); BatchNorm running
statistics 1e-6 (a handful of fp32 operations a step); the LAMB
``TrainStep`` trajectory 2e-5 relative / 2e-6 absolute, the bound of
``tests/test_torch_lamb.py`` (trust-ratio norms summed in another
order).  The host-read and non-finite checks are exact."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.parallel import TrainStep as JTrainStep

from mxnet_tpu_torch import amp, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.parallel import TrainStep


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _mlp(pkg, prefix="mlp_"):
    net = pkg.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu"), pkg.nn.Dense(4))
    return net


def _pair(prefix="mlp_", make=_mlp, size=(2, 10), seed=0):
    """A JAX net and a port net with the same weights, both sized."""
    np.random.seed(seed)
    jnet = make(jgluon, prefix)
    jnet.initialize(ctx=mx.cpu())
    x = np.random.default_rng(seed).standard_normal(size).astype(np.float32)
    with jautograd.pause():
        jnet(mx.nd.array(x))
    tnet = make(gluon, prefix)
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    return jnet, tnet


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_cache_keys_match_the_jax_block():
    """One call sequence -- two shapes, predict and train, AMP off and
    on -- makes the same entries, in the same order, under the same
    keys (the port's keys end with the device)."""
    jnet, tnet = _pair()
    jnet.hybridize()
    tnet.hybridize()
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 10)).astype(np.float32)
    b = rng.standard_normal((5, 10)).astype(np.float32)
    seq = [(a, "predict", None), (b, "predict", None), (a, "predict", None),
           (a, "record", None), (b, "record", None), (a, "predict",
                                                      "bfloat16"),
           (a, "record", "bfloat16"), (b, "predict", None)]
    for x, mode, dtype in seq:
        for pkg_amp, pkg_ag, net, arr in (
                (jamp, jautograd, jnet, mx.nd.array(x)),
                (amp, autograd, tnet, torch.from_numpy(x))):
            scope = pkg_ag.record() if mode == "record" \
                else pkg_ag.predict_mode()
            if dtype is None:
                with scope:
                    net(arr)
            else:
                with pkg_amp.scope(dtype), scope:
                    net(arr)
    jkeys = list(jnet._cached_entries)
    tkeys = list(tnet._cached_entries)
    assert len(jkeys) == 6
    assert [k[-1] for k in tkeys] == ["cpu"] * len(tkeys)
    assert [k[:-1] for k in tkeys] == jkeys
    # children of a hybridized parent run inside its entry: no entries
    for child in list(tnet._children.values()):
        assert child._cached_entries == {}


def test_hybridize_matches_imperative():
    """``tests/test_gluon.py :: test_hybridize_matches_imperative``
    against the port: the hybridized port net's forward equals the JAX
    net's, hybridized and not."""
    jnet, tnet = _pair()
    x = np.random.default_rng(2).standard_normal((8, 10)).astype(np.float32)
    y_imp = jnet(mx.nd.array(x)).asnumpy()
    jnet.hybridize()
    tnet.hybridize()
    y_jhyb = jnet(mx.nd.array(x)).asnumpy()
    for _ in range(2):
        got = tnet(mx_port_nd(x)).asnumpy()
        _close(got, y_imp)
        _close(got, y_jhyb)


def mx_port_nd(x):
    import mxnet_tpu_torch as tmx
    return tmx.nd.array(x, ctx=tmx.cpu())


def test_hybridize_shape_respecialization():
    """``tests/test_gluon.py :: test_hybridize_shape_respecialization``:
    a second input shape is a second entry, in both packages."""
    jnet = jgluon.nn.Dense(4, in_units=3)
    jnet.initialize()
    jnet.hybridize()
    tnet = gluon.nn.Dense(4, in_units=3)
    tnet.initialize(device="cpu")
    tnet.hybridize()
    for n in (2, 5):
        assert jnet(mx.nd.ones((n, 3))).shape == (n, 4)
        assert tuple(tnet(torch.ones(n, 3)).shape) == (n, 4)
    assert len(jnet._cached_entries) == len(tnet._cached_entries) == 2


def test_hybrid_training_gradients():
    """``tests/test_gluon.py :: test_hybrid_training_gradients``: the
    gradients of a hybridized net under ``record()`` equal the JAX
    hybridized net's."""
    jnet, tnet = _pair(seed=3)
    jnet.hybridize()
    tnet.hybridize()
    rng = np.random.default_rng(3)
    for _ in range(2):
        x = rng.standard_normal((8, 10)).astype(np.float32)
        with jautograd.record():
            jl = jnet(mx.nd.array(x)).sum()
        jl.backward()
        tx = mx_port_nd(x)
        with autograd.record():
            tl = tnet(tx).sum()
        tl.backward()
        _close(tl.asnumpy(), jl.asnumpy())
        for (jn, jp), (tn, tp) in zip(jnet.collect_params().items(),
                                      tnet.collect_params().items()):
            assert jn == tn
            _close(tp.grad().asnumpy(), jp.data()._grad.asnumpy(), msg=tn)


def _bn(pkg, prefix="bnnet_"):
    net = pkg.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.nn.Dense(4, in_units=6), pkg.nn.BatchNorm(in_channels=4))
    return net


def test_batchnorm_statistics_update_in_place():
    """Three training forwards of a hybridized net: the running
    statistics are the JAX package's, in the tensors they started in
    (a captured graph keeps reading and updating them)."""
    jnet, tnet = _pair("bnnet_", _bn, (2, 6), seed=4)
    jnet.hybridize()
    tnet.hybridize()
    bn = list(tnet._children.values())[1]
    ptrs = (bn.running_mean._data.data_ptr(),
            bn.running_var._data.data_ptr())
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = (rng.standard_normal((16, 6)) * 2 + 1).astype(np.float32)
        with jautograd.record():
            jnet(mx.nd.array(x))
        with autograd.record():
            tnet(torch.from_numpy(x))
    assert (bn.running_mean._data.data_ptr(),
            bn.running_var._data.data_ptr()) == ptrs
    jbn = list(jnet._children.values())[1]
    for name in ("running_mean", "running_var"):
        _close(getattr(bn, name).data().asnumpy(),
               getattr(jbn, name).data().asnumpy(), rtol=1e-6, atol=1e-6,
               msg=name)
    assert not np.allclose(bn.running_mean.data().asnumpy(), 0.0)


def _step_of(net, opt, params):
    tr = gluon.Trainer(net.collect_params(), opt, dict(params))
    return TrainStep(net, gluon.loss.L2Loss(), tr)


def _xy(seed, n=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 10)).astype(np.float32),
            rng.standard_normal((n, 4)).astype(np.float32))


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01})])
def test_train_step_body_makes_no_host_read(monkeypatch, opt, params):
    """Inside ``TrainStep._step`` (no fp16 scaler) no tensor is read on
    the host: ``item``, ``__bool__``, ``tolist``, ``cpu``, ``__float__``
    and ``__int__`` raise there."""
    _jnet, tnet = _pair(seed=5)
    step = _step_of(tnet, opt, params)
    x, y = _xy(5)
    step(x, y)
    inner = step._step

    def guarded(*a, **k):
        def refuse(name):
            def f(*_a, **_k):
                raise AssertionError("host read: Tensor.%s" % name)
            return f
        with monkeypatch.context() as m:
            for name in ("item", "__bool__", "tolist", "cpu", "__float__",
                         "__int__"):
                m.setattr(torch.Tensor, name, refuse(name))
            return inner(*a, **k)

    monkeypatch.setattr(step, "_step", guarded)
    losses = [step(x, y) for _ in range(2)]
    assert all(np.isfinite(float(v)) for v in losses)


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01})])
def test_nan_gradient_step_keeps_weights_and_state(opt, params):
    _jnet, tnet = _pair(seed=6)
    step = _step_of(tnet, opt, params)
    x, y = _xy(6)
    step(x, y)
    tr = step._trainer
    before = {n: p.data()._data.detach().clone()
              for n, p in tnet.collect_params().items()}
    states = {i: [t.clone() for t in (s if isinstance(s, tuple) else (s,))]
              for i, s in tr._updater.states.items()}
    counts = dict(tr.optimizer._index_update_count)
    bad = x.copy()
    bad[0, 0] = np.nan
    assert not np.isfinite(float(step(bad, y)))
    assert step.last_step_finite is False
    assert {i: c + 1 for i, c in counts.items()} \
        == tr.optimizer._index_update_count
    for n, p in tnet.collect_params().items():
        assert torch.equal(p.data()._data, before[n]), n
    for i, s in tr._updater.states.items():
        for a, b in zip(states[i], s if isinstance(s, tuple) else (s,)):
            assert torch.equal(a, b), i
    assert np.isfinite(float(step(x, y)))
    assert step.last_step_finite is True


def test_lamb_step_takes_new_rates_and_advancing_t_like_jax(monkeypatch):
    """Four LAMB ``TrainStep``s with the lr changed between the second
    and third, against the JAX ``TrainStep`` (bucketed LAMB, Pallas in
    interpret mode): the bias corrections follow each step's ``t`` and
    the new lr takes effect at once."""
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    jnet, tnet = _pair(seed=7)
    params = {"learning_rate": 0.01, "wd": 0.01}
    jtr = jgluon.Trainer(jnet.collect_params(), "lamb", dict(params),
                         kvstore=None)
    jstep = JTrainStep(jnet, jgluon.loss.L2Loss(), jtr, mesh=None)
    tstep = _step_of(tnet, "lamb", params)
    for k in range(4):
        if k == 2:
            jtr.set_learning_rate(0.05)
            tstep._trainer.set_learning_rate(0.05)
        x, y = _xy(10 + k)
        jl = float(jstep(mx.nd.array(x), mx.nd.array(y)).asscalar())
        tl = float(tstep(x, y))
        _close(tl, jl, rtol=2e-5, atol=2e-6, msg="loss %d" % k)
    assert tstep._trainer.optimizer._index_update_count[0] == 4
    for (jn, jp), (tn, tp) in zip(jnet.collect_params().items(),
                                  tnet.collect_params().items()):
        _close(tp.data().asnumpy(), jp.data().asnumpy(), rtol=2e-5,
               atol=2e-6, msg=tn)
