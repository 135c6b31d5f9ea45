"""The port's non-finite sentinel (``mxnet_tpu_torch.analysis.numerics``,
armed by ``MXNET_TPU_NUMERICS_CHECK``) against the JAX package's on the
CPU: a ``TrainStep`` on a poisoned batch raises ``NonFiniteError``
naming the parameter and kind the JAX package names, at the same step,
with the weights and optimizer state bitwise at their pre-step values;
a clean step passes; and disarmed, the step reads nothing on the host
(``Tensor.__bool__``, ``item``, ``tolist``, ``cpu`` and ``numpy``
patched to raise)."""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.analysis import numerics as jnumerics
from mxnet_tpu.parallel import TrainStep as JTrainStep

from mxnet_tpu_torch import env, gluon
from mxnet_tpu_torch.analysis import numerics
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.parallel import TrainStep

SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _batch(kind):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.0, (4, 6)).astype(np.float32)
    y = rng.standard_normal((4, 3)).astype(np.float32)
    if kind == "nan":
        x[2, 1] = np.nan
    elif kind == "inf":     # products of 1e30 overflow, no inf - inf
        x[1, 0] = 1e30
    return x, y


def _nets():
    np.random.seed(0)
    jnet = jgluon.nn.HybridSequential(prefix="sentinel_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(5, in_units=6), jgluon.nn.Dense(3,
                                                                 in_units=5))
    jnet.initialize(ctx=jmx.cpu())
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = gluon.nn.HybridSequential(prefix="sentinel_")
    with net.name_scope():
        net.add(gluon.nn.Dense(5, in_units=6), gluon.nn.Dense(3, in_units=5))
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    return jnet, net


@pytest.fixture
def armed():
    prev, jprev = numerics._set_check(True), jnumerics._set_check(True)
    yield
    numerics._set_check(prev)
    jnumerics._set_check(jprev)


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poisoned_batch_raises_as_the_jax_package_does(armed, kind):
    jnet, net = _nets()
    jstep = JTrainStep(jnet, jgluon.loss.L2Loss(), jgluon.Trainer(
        jnet.collect_params(), "sgd", dict(SGD), kvstore=None), mesh=None)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    clean, bad = _batch(None), _batch(kind)
    jstep(*[jmx.nd.array(a) for a in clean])
    step(*clean)                                # one clean step first
    before = {p.name: p.data()._data.clone()
              for p in net.collect_params().values()}
    moms = {i: s.clone() for i, s in tr._updater.states.items()}
    seen = numerics._STATE["nonfinite"]
    with pytest.raises(jnumerics.NonFiniteError) as jerr:
        jstep(*[jmx.nd.array(a) for a in bad])
    with pytest.raises(numerics.NonFiniteError) as err:
        step(*bad)
    assert (err.value.param, err.value.kind, err.value.step) == \
        (jerr.value.param, jerr.value.kind, jerr.value.step)
    assert err.value.kind == kind and err.value.step == 2
    assert err.value.param == "sentinel_dense0_weight"
    assert numerics._STATE["nonfinite"] == seen + 1
    assert numerics._STATE["last"] == {"param": err.value.param,
                                       "step": 2, "kind": kind}
    for p in net.collect_params().values():
        assert torch.equal(p.data()._data, before[p.name]), p.name
        assert p.data()._data.grad is None
    for i, s in tr._updater.states.items():
        assert torch.equal(s, moms[i])
    step(*clean)                                # and training goes on
    w = net.collect_params()["sentinel_dense0_weight"].data()._data
    assert not torch.equal(w, before["sentinel_dense0_weight"])


def test_attribution_reports_nan_before_inf():
    inf = torch.tensor([1.0, float("inf")])
    nan = torch.tensor([float("nan"), 1.0])
    named = [("a", torch.ones(2)), ("b", inf), ("c", nan)]
    assert numerics.attribute_nonfinite(named) == ("c", "nan")
    assert jnumerics.attribute_nonfinite(
        [(n, t.numpy()) for n, t in named]) == ("c", "nan")
    assert numerics.attribute_nonfinite(named[:2]) == ("b", "inf")
    assert numerics.attribute_nonfinite(named[:1]) is None
    assert numerics.attribute_nonfinite([("i", torch.arange(3))]) is None


@contextlib.contextmanager
def _host_reads_raise():
    def refuse(*_a, **_k):
        raise AssertionError("host read")
    mp = pytest.MonkeyPatch()
    try:
        for name in ("__bool__", "item", "tolist", "cpu", "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        yield
    finally:
        mp.undo()


def _sgd_step():
    _jnet, net = _nets()
    return net, TrainStep(net, gluon.loss.L2Loss(), gluon.Trainer(
        net.collect_params(), "sgd", dict(SGD)))


@pytest.mark.parametrize("kind", [None, "nan"])
def test_disarmed_step_reads_nothing_on_the_host(kind):
    """Disarmed, the default: a clean and a poisoned step run with every
    host read refused; the poisoned one keeps the weights."""
    assert not numerics.check_enabled()
    net, step = _sgd_step()
    x, y = (torch.from_numpy(a) for a in _batch(kind))
    step(x, y)          # the first call makes the state, outside the patch
    before = [p.data()._data.clone() for p in net.collect_params().values()]
    with _host_reads_raise():
        step(x, y)
    after = [p.data()._data for p in net.collect_params().values()]
    assert all(torch.equal(a, b) for a, b in zip(after, before)) \
        == (kind == "nan")


def test_armed_step_reads_the_finite_flag(armed):
    """Armed, the step reads its finite flag on the host: the patched
    reads raise."""
    _net, step = _sgd_step()
    x, y = (torch.from_numpy(a) for a in _batch(None))
    step(x, y)
    with _host_reads_raise(), pytest.raises(AssertionError,
                                            match="host read"):
        step(x, y)


def test_the_switch_is_the_jax_package_variable(monkeypatch):
    from mxnet_tpu import env as jax_env
    for raw, want in (("0", False), ("1", True)):
        monkeypatch.setenv("MXNET_TPU_NUMERICS_CHECK", raw)
        assert env.get("MXNET_TPU_NUMERICS_CHECK") is want
        assert jax_env.get("MXNET_TPU_NUMERICS_CHECK") is want
    assert numerics._set_check(True) is False
    assert numerics.check_enabled()
    assert numerics._set_check(False) is True


# -- the eager twins ---------------------------------------------------

def _poisoned(kind, dtype):
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    if kind is not None:
        arrays[1][3] = np.nan if kind == "nan" else np.inf
    return [torch.tensor(a).to(dtype if k != 2 else torch.float32)
            for k, a in enumerate(arrays)], arrays


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", [None, "nan", "inf"])
def test_finite_tree_and_finite_all_match_the_jax_package(kind, dtype):
    """One device flag over a set of arrays (mixed dtypes, an integer
    counter skipped), as the JAX twins give it; no host read."""
    import jax.numpy as jnp
    tensors, arrays = _poisoned(kind, dtype)
    counter = torch.tensor(7)
    with _host_reads_raise():
        tree = numerics.finite_tree(tensors + [counter])
        both = numerics.finite_all(tensors)
    assert tree.dim() == 0 and tree.dtype == torch.bool
    want = bool(jnumerics.finite_tree([jnp.asarray(a) for a in arrays]
                                      + [jnp.int32(7)]))
    assert bool(tree) == bool(both) == want == (kind is None)
    assert bool(jnumerics.finite_all([jnp.asarray(a) for a in arrays])) \
        == want
    assert bool(numerics.finite_tree([counter]))
    from mxnet_tpu_torch import NDArray
    assert bool(numerics.finite_all([NDArray(t) for t in tensors])) == want


@pytest.mark.parametrize("kind", [None, "nan", "inf"])
def test_finite_sentinel_matches_the_jax_package(armed, kind):
    tensors, arrays = _poisoned(kind, torch.float32)
    named = list(zip(("w0", "w1", "w2"), tensors))
    jnamed = list(zip(("w0", "w1", "w2"), arrays))
    checks, jchecks = numerics._STATE["checks"], jnumerics._STATE["checks"]
    if kind is None:
        assert numerics.finite_sentinel(named, step=4) is True
        assert jnumerics.finite_sentinel(jnamed, step=4) is True
    else:
        with pytest.raises(numerics.NonFiniteError) as err:
            numerics.finite_sentinel(named, step=4)
        with pytest.raises(jnumerics.NonFiniteError) as jerr:
            jnumerics.finite_sentinel(jnamed, step=4)
        assert (err.value.param, err.value.kind, err.value.step) == \
            (jerr.value.param, jerr.value.kind, jerr.value.step) == \
            ("w1", kind, 4)
        assert numerics._STATE["last"] == {"param": "w1", "step": 4,
                                           "kind": kind}
    assert numerics._STATE["checks"] == checks + 1
    assert jnumerics._STATE["checks"] == jchecks + 1


def test_disarmed_sentinel_touches_nothing():
    assert not numerics.check_enabled()
    checks = numerics._STATE["checks"]
    seconds = numerics._STATE["check_seconds"]
    with _host_reads_raise():
        assert numerics.finite_sentinel([("w", torch.tensor([np.nan]))])
    numerics.note_check(0.25)
    assert numerics._STATE["checks"] == checks + 1
    assert numerics._STATE["check_seconds"] == seconds + 0.25


def test_the_loss_scaler_checks_through_finite_all(monkeypatch):
    """``LossScaler.has_overflow`` calls ``numerics.finite_all``, as the
    JAX one does; ``amp.loss_scaler.all_finite`` is that function."""
    from mxnet_tpu_torch.amp import loss_scaler
    calls = []
    real = numerics.finite_all
    monkeypatch.setattr(loss_scaler, "finite_all",
                        lambda a: calls.append(len(a)) or real(a))
    scaler = loss_scaler.LossScaler()
    assert scaler.has_overflow([torch.ones(2), torch.tensor([np.inf])])
    assert not scaler.has_overflow([torch.ones(2), None])
    assert calls == [2, 1]
    assert loss_scaler.all_finite is numerics.finite_all
