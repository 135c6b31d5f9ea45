"""The port's engine and runtime helpers against the JAX package's on
the CPU: ``mx.engine`` (the bulk controls and the naive-engine switch),
``tests/test_bulk.py``'s behaviours that do not depend on deferral, run
inside ``mx.engine.bulk(64)`` (bulking is the port's sixth deviation:
it defers no op, so each run must be bitwise the run outside the
scope), ``mx.runtime`` (``Features``, ``env_vars``), ``mx.env``'s
``describe``/``generate_doc``, ``mx.viz`` and ``mx.test_utils``.

Tolerances: printed text and returned values equal; arrays bitwise
where one package's run is held against itself, 1e-5 relative / 1e-6
absolute where the port is held against the JAX package.
"""
import importlib
import threading

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import runtime as jruntime
from mxnet_tpu import test_utils as jtu

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, engine, env, gluon
from mxnet_tpu_torch import runtime, test_utils as tu


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


# -- mx.engine -----------------------------------------------------------

def _bulk_script(eng):
    """The values ``set_bulk_size`` and ``bulk`` give, and the sizes in
    force inside and after nested and failing scopes."""
    seen = []
    first = eng.set_bulk_size(16)
    try:
        seen.append(("first", first > 0))
        seen.append(("set", eng.set_bulk_size(7)))
        seen.append(("off", eng.set_bulk_size(1)))     # <= 1 turns it off
        seen.append(("was_off", eng.set_bulk_size(0)))
        seen.append(("on_again", eng.set_bulk_size(9)))
        with eng.bulk(64):
            seen.append(("inside", eng.set_bulk_size(64)))
            with eng.bulk(1):
                seen.append(("inner_off", eng.set_bulk_size(0)))
            seen.append(("after_inner", eng.set_bulk_size(64)))
        seen.append(("after", eng.set_bulk_size(9)))
        with pytest.raises(ValueError, match="boom"):
            with eng.bulk(32):
                raise ValueError("boom")
        seen.append(("after_raise", eng.set_bulk_size(9)))
        eng.set_bulk_size(1)
        with eng.bulk(5):
            seen.append(("from_off", eng.set_bulk_size(5)))
        seen.append(("restored_off", eng.set_bulk_size(1)))
    finally:
        eng.set_bulk_size(first if first > 1 else 1)
    return seen


def test_bulk_controls_match_the_jax_package():
    got = _bulk_script(engine)
    assert got == _bulk_script(jengine)
    assert dict(got)["set"] == 16 and dict(got)["off"] == 7
    assert dict(got)["was_off"] == 0 and dict(got)["after_raise"] == 9


def test_initial_bulk_size_is_the_jax_packages():
    prev, jprev = engine.set_bulk_size(8), jengine.set_bulk_size(8)
    try:
        assert prev == jprev == 512      # MXNET_TPU_EAGER_BULK_MAX
    finally:
        engine.set_bulk_size(prev)
        jengine.set_bulk_size(jprev)
    assert engine.waitall is mx.nd.waitall


@pytest.mark.parametrize("value,blocking", [
    ("NaiveEngine", True), ("ThreadedEnginePerDevice", False), (None, False)])
def test_is_blocking_follows_the_engine_type(monkeypatch, value, blocking):
    if value is None:
        monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    else:
        monkeypatch.setenv("MXNET_ENGINE_TYPE", value)
    try:
        assert importlib.reload(engine).is_blocking() is blocking
        assert importlib.reload(jengine).is_blocking() is blocking
    finally:
        monkeypatch.undo()
        importlib.reload(engine)
        importlib.reload(jengine)


@pytest.mark.parametrize("value,size", [("0", 0), ("1", 48)])
def test_bulk_state_comes_from_the_environment(monkeypatch, value, size):
    monkeypatch.setenv("MXNET_TPU_EAGER_BULK", value)
    monkeypatch.setenv("MXNET_TPU_EAGER_BULK_MAX", "48")
    try:
        assert importlib.reload(engine).set_bulk_size(1) == size
    finally:
        monkeypatch.undo()
        importlib.reload(engine)


# -- tests/test_bulk.py's behaviours inside a bulk scope -----------------

def _threads_of_arithmetic():
    """Four threads of eager arithmetic, each checking its own values
    at mid-loop reads (``test_bulk_two_thread_stress``)."""
    errs, finals = [], {}

    def worker(seed):
        try:
            with mx.cpu():
                a = mx.nd.full((8,), float(seed))
                for i in range(60):
                    a = a + 1.0
                    if i % 13 == 0:
                        onp.testing.assert_allclose(a.asnumpy(),
                                                    seed + i + 1.0)
                finals[seed] = a.asnumpy()
        except Exception as e:  # noqa: BLE001 -- collected for assert
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return [finals[s] for s in range(4)]


def _foreach_cotangents():
    """Backward through ``contrib.foreach`` with eager ops downstream
    (``test_bulked_cotangents_through_control_flow``)."""
    grads = []
    for rep in range(3):
        data = mx.nd.array(
            onp.arange(20, dtype=onp.float32).reshape(5, 4) + rep)
        s0 = mx.nd.zeros((4,))
        data.attach_grad()
        with autograd.record():
            outs, fin = mx.nd.contrib.foreach(
                lambda d, s: (d * 2 + s, s + d), data, s0)
            tot = (outs * 3.0).sum() + (fin * 2.0).sum()
        tot.backward()
        grads.append(data.grad.asnumpy())
    rows_below = onp.arange(4, -1, -1)[:, None]
    onp.testing.assert_allclose(
        grads[-1], onp.broadcast_to(6.0 + 3.0 * rows_below + 2.0, (5, 4)),
        rtol=1e-5)
    return grads


def _threaded_loader_training():
    """``DataLoader`` worker threads feeding an imperative SGD loop
    (``test_bulk_with_threaded_dataloader_training``); the losses and
    the final weights."""
    import torch
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    rng = onp.random.RandomState(0)
    xs = rng.randn(64, 6).astype(onp.float32)
    w = rng.randn(6, 1).astype(onp.float32)
    ys = (xs @ w).astype(onp.float32)
    onp.random.seed(0)
    mx.random.seed(0)
    loader = DataLoader(ArrayDataset(xs, ys), batch_size=16,
                        shuffle=True, num_workers=2)
    net = gluon.nn.Dense(1)
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=None)
    loss_fn = gluon.loss.L2Loss()
    losses = []
    for _ in range(8):
        for bx, by in loader:
            with autograd.record():
                loss = loss_fn(net(bx), by).mean()
            loss.backward()
            tr.step(1)
            losses.append(float(loss.asnumpy()))
    assert onp.isfinite(losses[-1]) and losses[-1] < losses[0]
    return losses + [p.data().asnumpy()
                     for p in net.collect_params().values()]


@pytest.mark.parametrize("run", [_threads_of_arithmetic, _foreach_cotangents,
                                 _threaded_loader_training],
                         ids=lambda f: f.__name__.strip("_"))
def test_bulk_scope_changes_no_result(run):
    outside = run()
    with engine.bulk(64):
        inside = run()
    assert len(inside) == len(outside)
    for a, b in zip(inside, outside):
        onp.testing.assert_array_equal(a, b)


# -- mx.runtime ------------------------------------------------------------

def test_features_have_the_jax_packages_names():
    feats = runtime.Features()
    assert set(feats) == set(jruntime.Features()) and len(feats) == 26
    assert all(isinstance(f, runtime.Feature) and f.name == k
               for k, f in feats.items())
    assert feats.is_enabled("cpu") and not feats.is_enabled("CUDA")
    for name in ("TPU", "XLA", "PALLAS", "MKLDNN", "SHARD_CHECK", "GPU",
                 "CUDNN", "KERNELS"):
        assert not feats.is_enabled(name), name
    with pytest.raises(RuntimeError, match="unknown feature"):
        feats.is_enabled("NOPE")
    assert repr(feats).startswith("[✔ BF16, ")
    assert "✖ CUDA" in repr(feats)
    assert [f.name for f in runtime.feature_list()] == list(feats)


def test_live_rows_read_the_live_state():
    from mxnet_tpu_torch import chaos, profiling, telemetry
    assert not runtime.Features().is_enabled("TELEMETRY")
    telemetry.enable()
    try:
        assert runtime.Features().is_enabled("TELEMETRY")
    finally:
        telemetry.disable()
    profiling.enable()
    try:
        assert runtime.Features().is_enabled("PROFILING")
    finally:
        profiling.disable()
    with chaos.scenario([]):
        assert runtime.Features().is_enabled("CHAOS")
    assert not runtime.Features().is_enabled("CHAOS")


def test_env_vars_list_every_registered_variable(tmp_path):
    listed = runtime.env_vars()
    assert set(listed) == set(env.REGISTRY)
    assert {"MXNET_ENGINE_TYPE", "MXNET_TPU_EAGER_BULK",
            "MXNET_TPU_EAGER_BULK_MAX"} <= set(listed)
    jlisted = jruntime.env_vars()
    for name, (value, default, doc) in listed.items():
        assert default == env.REGISTRY[name].default and doc
        assert value == jlisted[name][0], name
    assert listed["MXNET_TPU_EAGER_BULK_MAX"][:2] == (512, 512)
    path = tmp_path / "env.md"
    text = env.generate_doc(str(path))
    assert path.read_text() == text and list(tmp_path.iterdir()) == [path]
    assert text.count("\n| `MXNET_") == len(env.REGISTRY)
    assert env.generate_doc() == text


# -- mx.viz ------------------------------------------------------------------

def _viz_net(s):
    data = s.var("data")
    net = s.FullyConnected(data, num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def test_print_summary_prints_the_jax_packages_table(capsys):
    with jmx.name.NameManager():
        jnet = _viz_net(jmx.sym)
    with mx.name.NameManager():
        net = _viz_net(mx.sym)
    jtotal = jmx.viz.print_summary(jnet, shape={"data": (2, 8)})
    want = capsys.readouterr().out
    total = mx.viz.print_summary(net, shape={"data": (2, 8)})
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert total == jtotal == 16 * 8 + 16 + 4 * 16 + 4
    assert "(2, 4)" in got
    mx.viz.print_summary(net)
    jmx.viz.print_summary(jnet)
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


def test_plot_network_works_or_names_graphviz():
    assert mx.visualization is mx.viz
    with mx.name.NameManager():
        net = _viz_net(mx.sym)
    try:
        dot = mx.viz.plot_network(net, shape={"data": (2, 8)})
        assert "fc1" in dot.source
    except MXNetError as e:
        assert "graphviz" in str(e)


# -- mx.test_utils -------------------------------------------------------

def test_default_context_is_the_cpu_without_a_card():
    import torch
    want = mx.gpu(0) if torch.cuda.is_available() else mx.cpu(0)
    assert tu.default_context() == want
    assert str(jtu.default_context()) == str(tu.default_context())


def test_assert_almost_equal_and_rand_ndarray():
    for m, t in ((mx, tu), (jmx, jtu)):
        onp.random.seed(3)
        a = t.rand_ndarray((3, 4), scale=2.0)
        assert a.shape == (3, 4) and a.dtype == onp.float32
        t.assert_almost_equal(a, a.asnumpy() * (1 + 1e-7))
        with pytest.raises(AssertionError, match="x vs y"):
            t.assert_almost_equal(a, a.asnumpy() + 1e-3, names=("x", "y"))
    onp.random.seed(3)
    want = jtu.rand_ndarray((3, 4), scale=2.0)
    onp.random.seed(3)
    got = tu.rand_ndarray((3, 4), scale=2.0, dtype="float16")
    assert got.dtype == onp.float16
    onp.random.seed(3)
    onp.testing.assert_array_equal(tu.rand_ndarray((3, 4), scale=2.0)
                                   .asnumpy(), want.asnumpy())


def test_check_numeric_gradient_passes_and_fails_as_the_jax_one():
    x = onp.random.default_rng(0).uniform(0.5, 1.5, (2, 3)).astype(
        onp.float32)
    w = onp.random.default_rng(1).uniform(-1, 1, (2, 3)).astype(onp.float32)
    for m, t in ((mx, tu), (jmx, jtu)):
        t.check_numeric_gradient(
            lambda a, b: (m.nd.exp(a) * b).sum(), [x, w])
        t.check_numeric_gradient(lambda a: (a * a).sum(), [x], wrt=[0])
        # BlockGrad hides half of d(a * a): the recorded gradient is a,
        # the numeric one 2a
        with pytest.raises(AssertionError, match="wrt input 0"):
            t.check_numeric_gradient(
                lambda a: (a * m.nd.BlockGrad(a)).sum(), [x])


def test_check_consistency_compares_contexts():
    x = onp.random.default_rng(2).standard_normal((4, 6)).astype(onp.float32)
    wt = onp.random.default_rng(3).standard_normal((5, 6)).astype(
        onp.float32)
    for m, t in ((mx, tu), (jmx, jtu)):
        t.check_consistency("FullyConnected", [x, wt, wt[:, 0]],
                            {"num_hidden": 5})
        t.check_consistency("softmax", [x], {"axis": 1},
                            ctx_list=[m.cpu(0), m.cpu(0)])
        t.check_consistency("split", [x], {"num_outputs": 2, "axis": 1},
                            ctx_list=[m.cpu(0), m.cpu(0)])


def test_dummy_iter_repeats_its_batch():
    batch = object()
    it = iter(tu.DummyIter(batch))
    assert [next(it) for _ in range(3)] == [batch] * 3
    jit = iter(jtu.DummyIter(batch))
    assert next(jit) is next(it)
