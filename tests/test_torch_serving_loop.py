"""The always-on train -> serve loop on the CPU, against the JAX
package on the same numpy weights: ``ContinuousTrainer`` publishes the
same parameters per step and ``RegistryWatcher`` serves the same
outputs per step (rtol 1e-5 on the scenario MLP); the whole slice on a
narrow channels-last ResNet at ``tests/test_torch_train_step.py``'s
tolerance; the two registry repairs (each servable reads its own copy
of the weights; ``ModelRegistry(cache_dir=, compile_cache=)``); and the
hot swap's zero-dropped contract, fingerprints, spans and the status
board.  Every thread is joined with a timeout and fails on expiry."""
import threading

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import serving as jserving
from mxnet_tpu.chaos import scenarios as jscenarios
from mxnet_tpu.serving.loop import ContinuousTrainer as JContinuousTrainer
from mxnet_tpu.serving.loop import RegistryWatcher as JRegistryWatcher

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, chaos, gluon, obs, telemetry
from mxnet_tpu_torch.chaos import scenarios
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.serving import (ContinuousTrainer, ModelRegistry,
                                     RegistryWatcher)

JOIN_S = 60
X = np.random.RandomState(3).rand(8).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    chaos.reset()
    with mx.cpu():
        yield
    chaos.disarm()
    chaos.reset()


def _structural(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _carried_fixtures(seed=0):
    """The scenario fixtures in both packages, the port's weights the
    JAX net's."""
    jfx = jscenarios.train_fixtures(seed=seed)
    fx = scenarios.train_fixtures(seed=seed, device="cpu")
    params_from_numpy(fx[0], _structural(jfx[0]))
    return jfx, fx


def _published(root, step):
    """The ``params`` item of ``step`` under ``root`` as numpy arrays,
    read by the port's manager (both packages write the same files)."""
    ck = CheckpointManager(root).restore(step=step)
    return {k: v.asnumpy() for k, v in ck.items["params"].items()}


def _join(*threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# ---------------------------------------------------------------------
# the loop against the JAX package
# ---------------------------------------------------------------------

def test_publishes_and_serves_like_the_jax_package(tmp_path):
    """Three steps, a publish and a swap after each: the published
    parameters and the served outputs equal the JAX loop's per step."""
    jfx, fx = _carried_fixtures()
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    jct = JContinuousTrainer(*jfx, jroot, publish_every=1)
    ct = ContinuousTrainer(*fx, root, publish_every=1)
    jreg = jserving.ModelRegistry(compile_cache=False)
    reg = ModelRegistry(compile_cache=False)
    jw = JRegistryWatcher(jreg, "m", jct.manager, jscenarios.make_mlp(),
                          input_shape=(8,), buckets=(1, 2),
                          max_wait_ms=1)
    w = RegistryWatcher(reg, "m", ct.manager,
                        scenarios.make_mlp(device="cpu"),
                        input_shape=(8,), buckets=(1, 2), max_wait_ms=1)
    try:
        for step in (1, 2, 3):
            jct.run_steps(1)
            ct.run_steps(1)
            assert jct.published_step == ct.published_step == step
            want, got = _published(jroot, step), _published(root, step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
            assert jw.poll_once() == w.poll_once() == step
            np.testing.assert_allclose(
                reg.infer("m", X, timeout=10),
                jreg.infer("m", X, timeout=10), rtol=1e-5, atol=1e-7)
    finally:
        for thing in (jct, ct, jw, w):
            thing.close()
        jreg.shutdown()
        reg.shutdown()


NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
SGD = {"learning_rate": 0.05, "momentum": 0.9}


def test_the_slice_on_a_narrow_resnet_against_the_jax_package(
        tmp_path, monkeypatch):
    """A narrow NHWC ResNet v1 (fused BatchNorm+ReLU sites on their
    plain versions) trained by ``ContinuousTrainer`` with SGD momentum
    and hot-swapped by ``RegistryWatcher`` after each publish, in both
    packages from the same weights: losses within 1e-5, published
    parameters and served logits within 1e-4 relative / 2e-6 absolute
    (the tolerance of tests/test_torch_train_step.py)."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import kernels as jkernels
    from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JB
    from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JR
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.float32)
    img = rng.standard_normal((16, 16, 3)).astype(np.float32)

    def jnet_():
        net = JR(JB, layout="NHWC", **NARROW)
        net.initialize(ctx=jmx.cpu())
        with jmx.autograd.pause():
            net(jmx.nd.array(x))
        return net

    def net_():
        net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
        net.initialize(device="cpu",
                       generator=torch.Generator().manual_seed(0))
        with autograd.pause():
            net(mx.nd.array(x))
        return net

    with jax.default_matmul_precision("highest"):
        np.random.seed(0)
        jnet = jnet_()
        net = net_()
        params_from_numpy(net, _structural(jnet))
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD,
                             kvstore=None)
        tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
        jct = JContinuousTrainer(
            jnet, jtr, jgluon.loss.SoftmaxCrossEntropyLoss(),
            (jmx.nd.array(x), jmx.nd.array(y)), str(tmp_path / "jax"))
        ct = ContinuousTrainer(
            net, tr, gluon.loss.SoftmaxCrossEntropyLoss(),
            (mx.nd.array(x), mx.nd.array(y)), str(tmp_path / "port"))
        jreg = jserving.ModelRegistry(compile_cache=False)
        reg = ModelRegistry()
        jw = JRegistryWatcher(jreg, "r", jct.manager, jnet_(),
                              input_shape=(16, 16, 3), buckets=(1,),
                              max_wait_ms=1)
        w = RegistryWatcher(reg, "r", ct.manager, net_(),
                            input_shape=(16, 16, 3), buckets=(1,),
                            max_wait_ms=1)
        try:
            for step in (1, 2):
                jloss = float(jct.run_steps(1).mean().asscalar())
                loss = float(ct.run_steps(1).mean().asscalar())
                assert abs(loss - jloss) <= 1e-5 * abs(jloss)
                want = _published(str(tmp_path / "jax"), step)
                got = _published(str(tmp_path / "port"), step)
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                               atol=2e-6, err_msg=k)
                assert jw.poll_once() == w.poll_once() == step
                np.testing.assert_allclose(
                    reg.infer("r", img, timeout=30),
                    jreg.infer("r", img, timeout=30), rtol=1e-4, atol=2e-6)
        finally:
            for thing in (jct, ct, jw, w):
                thing.close()
            jreg.shutdown()
            reg.shutdown()


# ---------------------------------------------------------------------
# repair (a): one parameter snapshot per servable
# ---------------------------------------------------------------------

def _two_published_steps(tmp_path):
    """A checkpoint root holding steps 1 and 2 of the scenario loop,
    written by the port from the JAX fixtures' weights."""
    _jfx, fx = _carried_fixtures()
    root = str(tmp_path / "ck")
    ct = ContinuousTrainer(*fx, root, publish_every=1)
    ct.run_steps(2)
    ct.close()
    return root


def _gated_swap(reg_mod, chaos_mod, make_block, root, n_requests):
    """Register step 1, queue ``n_requests`` behind a dispatch held at
    the ``serving.dispatch`` fail point, then register step 2 on the
    SAME block; the hold is released at the second registration's
    ``serving.swap`` point -- after step 2 was restored into the block,
    before the first servable drains.  Returns the first servable's
    answers and each step's own answer."""
    reg = reg_mod.ModelRegistry(compile_cache=False)
    block = make_block()
    kw = dict(input_shape=(8,), buckets=(1,), max_wait_ms=1)
    gate = threading.Event()

    def hold(ctx):
        assert gate.wait(JOIN_S)

    try:
        with chaos_mod.scenario(seed=0):
            chaos_mod.on("serving.dispatch", action=hold, times=1)
            chaos_mod.on("serving.swap", nth=2,
                         action=lambda ctx: gate.set())
            s1 = reg.register("m", block=block, checkpoint=root, step=1,
                              **kw)
            futs = [s1.submit(X) for _ in range(n_requests)]
            reg.register("m", block=block, checkpoint=root, step=2, **kw)
            old = [f.result(timeout=JOIN_S) for f in futs]
        step2 = reg.infer("m", X, timeout=10)
        reg.register("m", block=block, checkpoint=root, step=1, **kw)
        step1 = reg.infer("m", X, timeout=10)
    finally:
        gate.set()
        reg.shutdown()
    return old, step1, step2


def test_a_draining_servable_keeps_its_own_weights(tmp_path):
    """Repair (a): the first servable's in-flight and drained answers
    are step 1's although step 2 was restored into its block, as in the
    JAX package (whose servable holds immutable arrays)."""
    root = _two_published_steps(tmp_path)
    jold, jstep1, jstep2 = _gated_swap(jserving, jchaos,
                                       jscenarios.make_mlp, root, 4)
    old, step1, step2 = _gated_swap(
        mx.serving, chaos, lambda: scenarios.make_mlp(device="cpu"),
        root, 4)
    assert not np.allclose(jstep1, jstep2)
    for a, b in zip(old, jold):
        np.testing.assert_allclose(a, jstep1, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b, jstep1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(step1, jstep1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(step2, jstep2, rtol=1e-5, atol=1e-7)


def test_training_the_block_leaves_the_servable_alone():
    """Repair (a): an SGD step on the block after ``register(block=)``
    does not reach the servable's answers (the JAX servable's neither);
    a new registration serves the trained weights."""
    jfx, fx = _carried_fixtures()
    answers = {}
    for name, (net, trainer, loss_fn, (x, y)), reg, ag in (
            ("jax", jfx, jserving.ModelRegistry(compile_cache=False),
             jmx.autograd),
            ("port", fx, ModelRegistry(), autograd)):
        try:
            reg.register("m", block=net, input_shape=(8,), buckets=(1,),
                         max_wait_ms=1)
            before = reg.infer("m", X, timeout=10)
            with ag.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(8)
            after = reg.infer("m", X, timeout=10)
            reg.register("m", block=net, input_shape=(8,), buckets=(1,),
                         max_wait_ms=1)
            answers[name] = (before, after, reg.infer("m", X, timeout=10))
        finally:
            reg.shutdown()
    for got, want in zip(answers["port"], answers["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    before, after, trained = answers["port"]
    assert np.array_equal(before, after)
    assert not np.allclose(before, trained)


def test_generative_registration_takes_fresh_tensors(tmp_path):
    """``register_generative(params=)`` copies the caller's tensors and
    ``(checkpoint=)`` restores a fresh dict of fresh tensors: updating
    the caller's weights in place after registration changes nothing
    served."""
    from mxnet_tpu_torch.serving.decode import tiny_gpt
    model = tiny_gpt(vocab_size=32, units=16, num_layers=2, num_heads=2,
                     max_seq=32)
    params = model.init_params(0, device="cpu")
    kw = dict(prefill_buckets=(8,), decode_buckets=(1, 2), block_size=4,
              num_blocks=32, device="cpu")
    want = model.reference_decode(params, [3, 7, 1], 6)
    mgr = CheckpointManager(str(tmp_path / "g"))
    mgr.save(1, {"params": params})
    reg = ModelRegistry()
    try:
        for src in ({"params": params}, {"checkpoint": mgr}):
            sv = reg.register_generative("g", model, **src, **kw)
            ptrs = {t.data_ptr() for t in params.values()}
            assert not ptrs & {t.data_ptr()
                               for t in sv.engine.params.values()}
            saved = {k: v.clone() for k, v in params.items()}
            with torch.no_grad():
                for t in params.values():
                    t.mul_(-3.0)
            assert reg.generate("g", [3, 7, 1], 6).tokens() == want
            with torch.no_grad():
                for k, t in params.items():
                    t.copy_(saved[k])
    finally:
        reg.shutdown()


# ---------------------------------------------------------------------
# repair (b): the JAX constructor's arguments, no compile cache
# ---------------------------------------------------------------------

def test_registry_takes_cache_dir_and_compile_cache(tmp_path):
    """Repair (b): ``ModelRegistry(cache_dir=, compile_cache=)`` is
    accepted.  There is no portable artifact to cache, so every
    registration captures anew: each warmed bucket counts a miss and
    none a hit; the fingerprints match across re-registrations of one
    architecture and differ across buckets."""
    telemetry.enable()
    telemetry.reset("serving.")
    try:
        reg = ModelRegistry(cache_dir=str(tmp_path / "cc"),
                            compile_cache=True)
        kw = dict(input_shape=(8,), buckets=(1, 2), max_wait_ms=1)
        s1 = reg.register("m", block=scenarios.make_mlp(device="cpu"),
                          **kw)
        fps = [s1.fingerprint(1), s1.fingerprint(2)]
        s2 = reg.register("m", block=scenarios.make_mlp(device="cpu"),
                          **kw)
        assert [s2.fingerprint(1), s2.fingerprint(2)] == fps
        assert fps[0] and fps[1] and fps[0] != fps[1]
        assert s2.fingerprint(4) is None
        wider = reg.register("w", block=scenarios.make_mlp(
            hidden=32, device="cpu"), **kw)
        assert wider.fingerprint(1) != fps[0]
        assert telemetry.counter("serving.compile_cache_misses").value \
            == 6
        assert telemetry.counter("serving.compile_cache_hits").value == 0
        reg.shutdown()
        ModelRegistry(compile_cache=False).shutdown()
    finally:
        telemetry.disable()


def test_hbm_validation_is_skipped_on_the_cpu():
    reg = ModelRegistry()
    s = reg.register("m", block=scenarios.make_mlp(device="cpu"),
                     input_shape=(8,), buckets=(1, 2), max_wait_ms=1)
    assert reg._validate_hbm("m", s._pool) is None
    assert s._pool.warmup_peaks() == {}
    with pytest.raises(mx.MXNetError, match="hbm_plan"):
        s._pool.hbm_plan()
    reg.shutdown()


def test_hbm_plan_extrapolates_the_warmup_peaks():
    """The line through the two smallest buckets' peaks, the JAX plan's
    keys, and the largest bucket that fits a limit."""
    from mxnet_tpu_torch.serving.executor import BucketExecutorPool
    pool = BucketExecutorPool(lambda t: (t,), (8,), "float32",
                              (1, 2, 4, 8), torch.device("cpu"))
    pool._peaks = {1: 1100, 2: 1200}
    plan = pool.hbm_plan(device_hbm_bytes=1550)
    assert (plan["const_bytes"], plan["per_item_bytes"]) == (1000, 100)
    assert [b["predicted_peak_hbm_bytes"] for b in plan["buckets"]] == \
        [1100, 1200, 1400, 1800]
    assert [b["fits"] for b in plan["buckets"]] == [True, True, True,
                                                     False]
    assert plan["largest_fit_bucket"] == 4
    assert plan["largest_fit_batch"] == 5


# ---------------------------------------------------------------------
# the loop's own contract
# ---------------------------------------------------------------------

def test_background_loop_swaps_under_load_with_zero_dropped(tmp_path):
    """Trainer and watcher on their own threads, clients throughout:
    every request answers, the served step only grows, and each answer
    is one published step's output."""
    _jfx, (net, trainer, loss_fn, data) = _carried_fixtures()
    ct = ContinuousTrainer(net, trainer, loss_fn, data,
                           str(tmp_path / "ck"), publish_every=2)
    reg = ModelRegistry()
    w = RegistryWatcher(reg, "m", ct.manager,
                        scenarios.make_mlp(device="cpu"),
                        input_shape=(8,), buckets=(1, 2, 4),
                        max_wait_ms=1, poll_s=0.02)
    ct.run_steps(2)
    assert w.poll_once() == 2
    answers, errors, served = [], [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                answers.append(reg.infer("m", X, timeout=30))
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

    def sampler():
        while not stop.is_set():
            served.append(w.served_step)
            stop.wait(0.005)

    threads = [threading.Thread(target=client) for _ in range(3)] + \
        [threading.Thread(target=sampler)]
    w.start()
    for t in threads:
        t.start()
    ct.start(max_steps=6)
    try:
        for _ in range(int(JOIN_S / 0.02)):
            if w.served_step == 8:
                break
            stop.wait(0.02)
    finally:
        stop.set()
        _join(*threads)
        ct.close()
        w.close()
        reg.shutdown()
    assert w.served_step == 8 and not errors and answers
    assert served == sorted(served)
    outs = {}
    for step in (2, 4, 6, 8):
        blk = scenarios.make_mlp(device="cpu")
        CheckpointManager(ct.manager.root).restore_training(blk,
                                                            step=step)
        with autograd.pause():
            outs[step] = blk(mx.nd.array(X[None])).asnumpy()[0]
    for a in answers:
        assert any(np.allclose(a, o, rtol=1e-5, atol=1e-7)
                   for o in outs.values())


def test_status_board_and_spans(tmp_path):
    """statusz reads the watcher, trainer and servable; the traced loop
    records the JAX package's span names."""
    obs.trace.clear()
    obs.status.reset()      # registrations left by earlier tests
    obs.enable_tracing()
    telemetry.enable()
    telemetry.reset()
    try:
        _jfx, fx = _carried_fixtures()
        ct = ContinuousTrainer(*fx, str(tmp_path / "ck"), publish_every=1)
        reg = ModelRegistry()
        w = RegistryWatcher(reg, "m", ct.manager,
                            scenarios.make_mlp(device="cpu"),
                            input_shape=(8,), buckets=(1,), max_wait_ms=1)
        ct.run_steps(1)
        assert w.poll_once() == 1
        reg.infer("m", X, timeout=10)
        # the worker records a batch's spans after answering it
        for _ in range(500):
            if "serving.batch" in {s["name"] for s in obs.spans()}:
                break
            threading.Event().wait(0.01)
        snap = obs.status.statusz()
        assert snap["schema"] == "mxstatusz.v1" and snap["ready"]
        assert snap["served_step"] == 1 and snap["published_step"] == 1
        assert {"name": "m", "served_step": 1, "suspended": False,
                "bad_steps": []} in snap["watchers"]
        assert any(s["name"] == "m" for s in snap["servables"])
        assert snap["swap_history"][-1]["ok"] is True
        names = {s["name"] for s in obs.spans()}
        assert {"train.step", "train.publish", "checkpoint.commit",
                "serving.watcher.discover", "serving.swap",
                "serving.register.warm", "serving.register.install",
                "serving.request", "serving.queue_wait",
                "serving.batch", "serving.dispatch",
                "serving.device_get"} <= names
        doc = obs.export_chrome_trace()
        assert doc["traceEvents"] and doc["otherData"]["producer"] == \
            "mxnet_tpu_torch.obs.trace"
        ct.close()
        w.close()
        reg.shutdown()
    finally:
        obs.disable_tracing()
        telemetry.disable()


def test_unported_switches_raise(monkeypatch, tmp_path):
    _jfx, fx = _carried_fixtures()
    # the ops plane's switches are ported: they construct as in JAX
    for var in ("MXNET_TPU_OBS_GOODPUT", "MXNET_TPU_MEMORY_WATCH"):
        monkeypatch.setenv(var, "1")
        ContinuousTrainer(*fx, str(tmp_path / "ck"))
        monkeypatch.delenv(var)
    # the multi-process loop is ported (tests/test_torch_elastic.py): a
    # launch's variables alone, before distributed_init, build one
    monkeypatch.setenv("MXNET_TPU_NUM_PROCS", "2")
    assert ContinuousTrainer(*fx, str(tmp_path / "ck"))._lease_beat is None
    monkeypatch.delenv("MXNET_TPU_NUM_PROCS")
    with pytest.raises(mx.MXNetError, match="on_publish_error"):
        ContinuousTrainer(*fx, str(tmp_path / "ck"),
                          on_publish_error="ignore")
    with pytest.raises(mx.MXNetError, match="publish_every"):
        ContinuousTrainer(*fx, str(tmp_path / "ck"), publish_every=0)


def test_a_publish_never_waits_on_the_card_during_a_capture(monkeypatch):
    """A trainer's publish waits on the card (``waitall``) while a
    watcher may be capturing a servable on another thread: a device-wide
    wait on a capturing stream fails both, so the wait takes the capture
    lock and runs only after the capture."""
    from mxnet_tpu_torch import _capture
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: events.append("synchronize"))
    captured, holding = threading.Event(), threading.Event()

    def capture():
        with _capture._capture_lock:
            holding.set()
            captured.wait(JOIN_S)
            events.append("capture end")

    t = threading.Thread(target=capture)
    t.start()
    assert holding.wait(JOIN_S)
    waiter = threading.Thread(target=mx.nd.waitall)
    waiter.start()
    waiter.join(0.2)
    assert waiter.is_alive() and events == []
    captured.set()
    waiter.join(JOIN_S)
    t.join(JOIN_S)
    assert not waiter.is_alive() and not t.is_alive()
    assert events == ["capture end", "synchronize"]
