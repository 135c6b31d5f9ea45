"""The port's optimizer module (``mxnet_tpu_torch.optimizer``) against the
JAX package's on the CPU, the same seeded numpy inputs through both:

- every optimizer of the JAX registry, three updates through
  ``Updater`` of a weight and a bias with weight decay,
  ``clip_gradient``, ``rescale_grad``, an ``lr_mult`` on the bias (set
  by index, by name, or through ``param_dict``) and a ``FactorScheduler``:
  weights and every state;
- multi-precision fp16 (SGD with and without momentum, Adam): the fp32
  master copy and the fp16 weight;
- ``Updater.get_states`` blobs of Adam and of multi-precision SGD,
  written by one package and loaded by the other;
- ``gluon.Trainer(params, name)`` for every registered name: three
  ``record``/``backward``/``Trainer.step`` steps of a small Dense net.

Tolerance: 1e-6 relative and 1e-7 absolute for fp32 (the same
elementwise fp32 arithmetic, summed norms aside); the fp16 weight is the
cast of a master copy that agrees to that, so it may sit one fp16 step
(2^-10 relative) away where the copy lies on a rounding boundary; the
Trainer steps 1e-5 relative (a matmul in each package's order).
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.optimizer.optimizer import _OPT_REGISTRY as JAX_REGISTRY

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.optimizer.optimizer import _OPT_REGISTRY

RTOL, ATOL = 1e-6, 1e-7
FP16_RTOL = 2.0 ** -10
COMMON = {"wd": 0.01, "clip_gradient": 0.8, "rescale_grad": 0.5}

CASES = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    "adam": ("adam", {"learning_rate": 0.01}),
    "adamw": ("adamw", {"learning_rate": 0.01, "beta1": 0.8}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True, "gamma1": 0.95,
                                     "clip_weights": 0.9}),
    "adagrad": ("adagrad", {"learning_rate": 0.1}),
    "ftrl": ("ftrl", {"learning_rate": 0.1, "lamda1": 0.001}),
    "signum": ("signum", {"learning_rate": 0.01, "wd_lh": 0.05}),
    "signsgd": ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    "lars": ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    "lamb": ("lamb", {"learning_rate": 0.01}),
}


def _values(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = [rng.uniform(-1, 1, (4, 5)).astype(dtype),
         rng.uniform(-1, 1, (5,)).astype(dtype)]
    grads = [[rng.uniform(-3, 3, a.shape).astype(dtype) for a in w]
             for _ in range(3)]
    return w, grads


def _states_np(s):
    """An optimizer state as a flat list of numpy arrays (None kept)."""
    if s is None:
        return [None]
    if isinstance(s, (tuple, list)):
        return [a for x in s for a in _states_np(x)]
    if isinstance(s, torch.Tensor):
        return [s.detach().float().numpy()]
    return [s.asnumpy().astype(np.float32)]


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        if w is None:
            assert g is None, what
            continue
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _run(pkg, name, hyper, mult, w0, grads, dtype):
    """Three updates of ``w0`` by ``Updater`` in ``pkg`` (``"jax"`` or
    ``"port"``): ``(weights, states, optimizer, updater)``."""
    jax_side = pkg == "jax"
    mod = jmx if jax_side else mx
    kw = dict(hyper, **COMMON)
    kw["lr_scheduler"] = mod.lr_scheduler.FactorScheduler(step=1,
                                                          factor=0.9)
    kw["param_idx2name"] = {0: "net_weight", 1: "net_bias"}
    if jax_side:
        params = [jgluon.Parameter("net_weight"), jgluon.Parameter("net_bias")]
    else:
        params = [gluon.Parameter("net_weight"), gluon.Parameter("net_bias")]
    params[1].lr_mult, params[1].wd_mult = 0.5, 2.0
    if mult == "param_dict":
        kw["param_dict"] = {0: params[0], 1: params[1]}
    opt = mod.optimizer.create(name, **kw)
    if mult == "index":
        opt.set_lr_mult({1: 0.5})
        opt.set_wd_mult({1: 2.0})
    elif mult == "name":
        opt.set_lr_mult({"net_bias": 0.5})
        opt.set_wd_mult({"net_bias": 2.0})
    upd = mod.optimizer.get_updater(opt)
    if jax_side:
        ws = [jmx.nd.array(a, dtype=dtype) for a in w0]
        for gs in grads:
            for i, g in enumerate(gs):
                upd(i, jmx.nd.array(g, dtype=dtype), ws[i])
        weights = [w.asnumpy().astype(np.float32) for w in ws]
    else:
        tdt = getattr(torch, np.dtype(dtype).name)
        ws = [torch.tensor(a, dtype=tdt) for a in w0]
        for gs in grads:
            for i, g in enumerate(gs):
                upd(i, torch.tensor(g, dtype=tdt), ws[i])
        weights = [w.float().numpy() for w in ws]
    return weights, [_states_np(upd.states[i]) for i in range(2)], opt, upd


@pytest.mark.parametrize("mult", ["index", "name", "param_dict"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match_the_jax_package(case, mult):
    name, hyper = CASES[case]
    w0, grads = _values()
    jw, js, jopt, _ = _run("jax", name, hyper, mult, w0, grads, np.float32)
    tw, ts, topt, _ = _run("port", name, hyper, mult, w0, grads,
                           np.float32)
    _close(tw, jw, what="weights")
    for i in range(2):
        _close(ts[i], js[i], what="state %d" % i)
    assert topt.num_update == jopt.num_update == 3
    assert topt._index_update_count == jopt._index_update_count
    assert abs(topt.learning_rate - jopt.learning_rate) <= 1e-12
    for a, b in zip(tw, w0):
        assert not np.allclose(a, b)


@pytest.mark.parametrize("case", ["sgd", "sgd_momentum", "adam"])
def test_multi_precision_fp16_matches_the_jax_package(case):
    """An fp16 weight with ``multi_precision=True``: the update runs on
    an fp32 master copy (the state's last entry) and the weight is its
    cast; without ``multi_precision`` the fp16 weight takes the plain
    update, and a bf16 weight never takes the master copy."""
    name, hyper = CASES[case]
    hyper = dict(hyper, multi_precision=True)
    w0, grads = _values(1, np.float16)
    jw, js, _, _ = _run("jax", name, hyper, "index", w0, grads, np.float16)
    tw, ts, _, _ = _run("port", name, hyper, "index", w0, grads,
                        np.float16)
    for i in range(2):
        assert len(ts[i]) == len(js[i]) >= 2
        _close(ts[i], js[i], what="state %d" % i)
        master = ts[i][-1]
        assert master.dtype == np.float32
        np.testing.assert_allclose(tw[i], master.astype(np.float16),
                                   rtol=FP16_RTOL, atol=0)
    _close(tw, jw, rtol=FP16_RTOL, atol=0, what="fp16 weights")
    from mxnet_tpu_torch.parallel.data_parallel import _tensors
    opt = mx.optimizer.create(name, **hyper)
    bf = torch.zeros(3, dtype=torch.bfloat16)
    assert {t.dtype for t in _tensors(
        opt.create_state_multi_precision(0, bf))} <= {torch.bfloat16}
    state = opt.create_state_multi_precision(0, torch.zeros(
        3, dtype=torch.half))
    assert isinstance(state, tuple) and state[-1].dtype == torch.float32


BLOBS = {"adam": ("adam", {"learning_rate": 0.01}, np.float32),
         "sgd_mp": ("sgd", {"learning_rate": 0.1, "multi_precision": True},
                    np.float16),
         "sgd_momentum_mp": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                     "multi_precision": True}, np.float16)}


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("case", sorted(BLOBS))
def test_state_blobs_cross_packages(case, src, dst):
    """``get_states`` of one package's ``Updater`` after three updates,
    loaded by the other's ``set_states``: the same structure (Adam's
    ``(mean, var)``, multi-precision SGD's ``(momentum or None,
    weight32)``) and values."""
    name, hyper, dtype = BLOBS[case]
    w0, grads = _values(2, dtype)
    _w, states, _o, upd = _run(src, name, hyper, "index", w0, grads, dtype)
    other = (mx if dst == "port" else jmx).optimizer
    loaded = other.get_updater(other.create(name, **hyper))
    loaded.set_states(upd.get_states())
    assert sorted(loaded.states) == [0, 1]
    for i in range(2):
        assert isinstance(loaded.states[i], tuple)
        _close(_states_np(loaded.states[i]), states[i], rtol=0, atol=0,
               what="state %d" % i)


def test_trainer_places_master_copies_in_fp32():
    """``Trainer.set_states`` puts each state at its parameter's dtype,
    but a multi-precision fp16 parameter's master copy and the states
    made from it in fp32."""
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    net.cast("float16")
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9,
                        "multi_precision": True})
    x = torch.ones(2, 4, dtype=torch.float16)
    with autograd.record():
        loss = net(x).float().sum()
    loss.backward()
    tr.step(2)
    blob = tr.get_states()
    tr2 = gluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9,
                         "multi_precision": True})
    tr2.set_states(blob)
    for i, (mom, w32) in tr2._updater.states.items():
        assert mom.dtype == w32.dtype == torch.float32
        want_mom, want_w32 = tr._updater.states[i]
        assert torch.equal(mom, want_mom) and torch.equal(w32, want_w32)
        assert torch.equal(w32.half(), tr._params[i].data()._data)


def _dense_nets(name_scope):
    np.random.seed(0)
    jnet = jgluon.nn.HybridSequential(prefix=name_scope)
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(8, activation="relu", in_units=5),
                 jgluon.nn.Dense(3, in_units=8))
    jnet.initialize(ctx=jmx.cpu())
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = gluon.nn.HybridSequential(prefix=name_scope)
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(8, activation="relu", in_units=5),
                 gluon.nn.Dense(3, in_units=8))
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, arrays)
    return jnet, tnet


def test_every_jax_optimizer_name_is_registered():
    assert sorted(_OPT_REGISTRY) == sorted(JAX_REGISTRY)
    assert {"sgd", "nag", "adam", "adamw", "rmsprop", "adagrad", "ftrl",
            "signum", "lars", "lamb"} <= set(_OPT_REGISTRY)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_trainer_steps_match_the_jax_package(name):
    """``gluon.Trainer(params, name)``: three ``record``/``backward``/
    ``step(batch)`` steps of a small Dense net in each package from the
    same weights on the same batch, with weight decay and a
    ``FactorScheduler``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)
    jnet, tnet = _dense_nets("trainer_")
    hyper = {"learning_rate": 0.05, "wd": 0.01}
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(
        hyper, lr_scheduler=jmx.lr_scheduler.FactorScheduler(2, 0.5)),
        kvstore=None)
    ttr = gluon.Trainer(tnet.collect_params(), name, dict(
        hyper, lr_scheduler=mx.lr_scheduler.FactorScheduler(2, 0.5)))
    jlf, tlf = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            with jautograd.record():
                jl = jlf(jnet(jmx.nd.array(x)), jmx.nd.array(y))
            jl.backward()
            jtr.step(6)
            with autograd.record():
                tl = tlf(tnet(torch.tensor(x)), torch.tensor(y))
            tl.sum().backward()
            ttr.step(6)
            np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                       rtol=1e-5)
    assert abs(ttr.learning_rate - jtr.learning_rate) <= 1e-12
    for (jn, jp), (tn, tp) in zip(jnet.collect_params().items(),
                                  tnet.collect_params().items()):
        assert jn == tn
        np.testing.assert_allclose(tp.data()._data.detach().numpy(),
                                   jp.data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=tn)


def test_run_steps_holds_the_block_starts_scheduled_lr():
    """``TrainStep.run_steps`` reads lr once a block, at the count of the
    block's first step, as the JAX package's scan does: two blocks of
    three steps under a ``FactorScheduler`` that halves the lr every
    update, against the JAX ``run_steps``."""
    from mxnet_tpu.parallel import TrainStep as JTrainStep
    from mxnet_tpu_torch.parallel import TrainStep
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    y = rng.standard_normal((3, 6, 3)).astype(np.float32)
    jnet, tnet = _dense_nets("blocks_")
    hyper = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(
        hyper, lr_scheduler=jmx.lr_scheduler.FactorScheduler(1, 0.5)),
        kvstore=None)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(
        hyper, lr_scheduler=mx.lr_scheduler.FactorScheduler(1, 0.5)))
    jstep = JTrainStep(jnet, jgluon.loss.L2Loss(), jtr, mesh=None)
    tstep = TrainStep(tnet, gluon.loss.L2Loss(), ttr)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            jl = jstep.run_steps(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
            tl = tstep.run_steps(x, y).numpy()
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 6
    for (jn, jp), (tn, tp) in zip(jnet.collect_params().items(),
                                  tnet.collect_params().items()):
        np.testing.assert_allclose(tp.data()._data.detach().numpy(),
                                   jp.data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=tn)
