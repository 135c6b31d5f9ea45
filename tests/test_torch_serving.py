"""The port's fixed-shape serving tier on the CPU:
``ModelRegistry.register(block=, checkpoint=)`` -> ``DynamicBatcher``
-> ``BucketExecutorPool``, held against the JAX package's registry on
the same weights, and the cases of ``tests/test_serving.py`` that do
not test the compile cache, StableHLO fingerprints, ``symbol=``,
``onnx=`` or telemetry (the batcher's own counts stand in for the
telemetry counters).  Plus a narrow NHWC ResNet served from a
checkpoint, whose fused BatchNorm+ReLU sites run the plain
``bn_relu_apply`` version once per site per bucket forward, and
``register_generative(checkpoint=)`` against ``params=``.

Tolerances: the JAX file's own -- 1e-5 relative / 1e-6 absolute on a
block's outputs, 1e-4 on a checkpoint-restored convnet; the narrow
ResNet 1e-4 relative / 1e-5 absolute against the JAX package (fp32
convolutions summed in another order through twelve layers), and
1e-5 / 1e-6 against the port's own batch-1 forward of each image."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import serving as jserving
from mxnet_tpu.checkpoint import CheckpointManager as JCheckpointManager
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.serving.decode import tiny_gpt as jax_tiny_gpt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, serving
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.kernels import registry as kernel_registry
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.serving import (RequestTimeout, ServableClosed,
                                     ServingQueueFull)
from mxnet_tpu_torch.serving.decode import tiny_gpt

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _mlp(out=4, pkg=gluon):
    net = pkg.nn.HybridSequential()
    net.add(pkg.nn.Dense(16, activation="relu"), pkg.nn.Dense(out))
    if pkg is gluon:
        net.initialize(device="cpu")
        net(torch.zeros(1, 8))
    else:
        net.initialize(force_reinit=True)
        net(jmx.nd.array(np.zeros((1, 8), np.float32)))
    net.hybridize()
    return net


def _convnet(pkg=gluon):
    net = pkg.nn.HybridSequential()
    net.add(pkg.nn.Conv2D(4, 3, padding=1, activation="relu"),
            pkg.nn.BatchNorm(), pkg.nn.Flatten(), pkg.nn.Dense(5))
    if pkg is gluon:
        net.initialize(device="cpu")
        net(torch.zeros(1, 3, 8, 8))
    else:
        net.initialize(force_reinit=True)
        net(jmx.nd.array(np.zeros((1, 3, 8, 8), np.float32)))
    return net


def _forward(net, x):
    """The port net's own forward in predict mode, as numpy."""
    with autograd.pause():
        return net(torch.from_numpy(np.asarray(x))).numpy()


def _weights(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.fixture()
def registry():
    reg = serving.ModelRegistry()
    yield reg
    reg.shutdown(drain=True)


@pytest.fixture()
def jregistry():
    reg = jserving.ModelRegistry(compile_cache=False)
    yield reg
    reg.shutdown(drain=True)


# ---------------------------------------------------------------------
# registry sources, against the JAX package
# ---------------------------------------------------------------------

def test_register_block_numerics_match_the_jax_registry(registry,
                                                        jregistry):
    jnet = _mlp(pkg=jgluon)
    net = _mlp()
    params_from_numpy(net, _weights(jnet))
    kw = dict(input_shape=(8,), buckets=(1, 2), max_wait_ms=1)
    js = jregistry.register("mlp", block=jnet, **kw)
    s = registry.register("mlp", block=net, **kw)
    assert s.source == "block"
    x = np.random.RandomState(0).rand(8).astype(np.float32)
    got = s.infer(x, timeout=10)
    np.testing.assert_allclose(got, js.infer(x, timeout=10), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, _forward(net, x[None])[0], rtol=1e-5,
                               atol=1e-6)


def _exported_convnet(tmp_path):
    """The JAX convnet with its running statistics and scales off their
    defaults, the port's with the same weights, and the port's export of
    it; returns ``(jax net, port net, symbol file, params file)``."""
    jnet = _convnet(pkg=jgluon)
    rng = np.random.RandomState(7)
    for name, p in sorted(jnet.collect_params().items()):
        a = rng.rand(*p.shape) + 0.5 if name.endswith(("var", "gamma")) \
            else 0.3 * rng.randn(*p.shape)
        p.set_data(jmx.nd.array(a.astype(np.float32)))
    net = _convnet()
    params_from_numpy(net, _weights(jnet))
    files = net.export(str(tmp_path / "convnet"))
    return jnet, net, files[0], files[1]


@pytest.mark.parametrize("source", ["symbol", "onnx"])
def test_register_graph_sources_match_the_jax_registry(registry, jregistry,
                                                       tmp_path, source):
    """``register(symbol=, params=)`` and ``register(onnx=)`` on the
    port's export, against the JAX registry fed the same files: answers
    within 1e-4 of the largest, and of the net's own forward."""
    jnet, net, sym_file, params_file = _exported_convnet(tmp_path)
    if source == "onnx":
        onnx_file = mx.onnx.export_model(
            sym_file, params_file, in_shapes=[(1, 3, 8, 8)],
            onnx_file_path=str(tmp_path / "convnet.onnx"))
        kw = dict(onnx=onnx_file)
    else:
        kw = dict(symbol=sym_file, params=params_file)
    kw.update(input_shape=(3, 8, 8), buckets=(1, 2), max_wait_ms=1)
    js = jregistry.register("g", **kw)
    s = registry.register("g", **kw)
    assert s.source == js.source == source
    xs = np.random.RandomState(1).randn(3, 3, 8, 8).astype(np.float32)
    got = np.stack([f.result(timeout=10) for f in
                    [s.submit(x) for x in xs]])
    want = np.stack([js.infer(x, timeout=10) for x in xs])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - _forward(net, xs)).max() <= 1e-4 * scale
    jout = jnet(jmx.nd.array(xs)).asnumpy()
    assert np.abs(got - jout).max() <= 1e-4 * scale


def test_graph_source_inputs_aux_and_fingerprint(registry, tmp_path):
    _jnet, net, sym_file, params_file = _exported_convnet(tmp_path)
    from mxnet_tpu_torch.ndarray.ndarray import load_tensors
    params = load_tensors(params_file)
    # a Symbol and a dict with the reference's prefixes, input named
    sym = mx.sym.load(sym_file)
    s = registry.register("a", symbol=sym, params=params, input_name="data",
                          input_shape=(3, 8, 8), buckets=(1,))
    b = registry.register("b", block=net, input_shape=(3, 8, 8),
                          buckets=(1,))
    assert s.fingerprint(1) and s.fingerprint(1) != b.fingerprint(1)
    again = registry.register("c", symbol=sym_file, params=params_file,
                              input_shape=(3, 8, 8), buckets=(1,))
    assert again.fingerprint(1) == s.fingerprint(1)
    with pytest.raises(MXNetError, match="unknown input"):
        registry.register("d", symbol=sym, params=params, input_name="x",
                          input_shape=(3, 8, 8), buckets=(1,))
    # an aux state the graph marks (``__aux__``) must come with params
    data = mx.sym.var("data")
    with mx.AttrScope(__aux__="1"):
        mean = mx.sym.var("mean")
    graph = mx.sym.broadcast_sub(data, mean)
    with pytest.raises(MXNetError, match="aux states"):
        registry.register("e", symbol=graph, params={},
                          input_shape=(4,), buckets=(1,))
    x = np.ones((3, 8, 8), np.float32)
    np.testing.assert_allclose(s.infer(x, timeout=10),
                               _forward(net, x[None])[0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_register_checkpoint_manifest(registry, jregistry, tmp_path,
                                      writer):
    """The checkpoint source restores the newest intact manifest-
    verified step into the block before serving; a step written by
    either package serves the same answers in both."""
    jnet = _convnet(jgluon)
    net = _convnet()
    params_from_numpy(net, _weights(jnet))
    x = np.random.RandomState(3).randn(3, 8, 8).astype(np.float32)
    want = _forward(net, x[None])[0]
    root = str(tmp_path / "ckpts")
    if writer == "port":
        CheckpointManager(root).save_training(5, net)
    else:
        JCheckpointManager(root).save_training(5, jnet)

    fresh = _convnet()                      # different random params
    assert not np.allclose(_forward(fresh, x[None])[0], want, atol=1e-4)
    kw = dict(checkpoint=root, input_shape=(3, 8, 8), buckets=(1,),
              max_wait_ms=1)
    s = registry.register("ckpt", block=fresh, **kw)
    js = jregistry.register("ckpt", block=_convnet(jgluon), **kw)
    assert s.source == js.source == "checkpoint"
    np.testing.assert_allclose(s.infer(x, timeout=10), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(js.infer(x, timeout=10), want, rtol=1e-4,
                               atol=1e-4)


def test_register_checkpoint_needs_an_intact_step(registry, tmp_path):
    with pytest.raises(MXNetError, match="no intact checkpoint"):
        registry.register("a", block=_mlp(), input_shape=(8,),
                          checkpoint=str(tmp_path / "empty"))


def test_register_checkpoint_restores_a_deferred_block(registry, tmp_path):
    """A block never run forward (shapes deferred) takes the restored
    shapes; the probe forward is not needed."""
    net = _mlp()
    root = str(tmp_path / "ck")
    CheckpointManager(root).save_training(1, net)
    fresh = gluon.nn.HybridSequential()
    fresh.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    fresh.initialize(device="cpu")
    s = registry.register("m", block=fresh, checkpoint=root,
                          input_shape=(8,), buckets=(2,), max_wait_ms=1)
    x = np.ones(8, np.float32)
    np.testing.assert_array_equal(s.infer(x, timeout=10),
                                  _forward(net, np.stack([x, 0 * x]))[0])


@pytest.mark.parametrize("kwargs,match", [
    (dict(block="net"), "input_shape"),
    (dict(input_shape=(8,)), "exactly one"),
    (dict(block="net", onnx="x.onnx", input_shape=(8,)), "exactly one"),
    (dict(checkpoint="/nope", input_shape=(8,)), "needs block"),
    (dict(symbol="fc", input_shape=(8,)), "pass input_name"),
    (dict(onnx="garbage", input_shape=(8,)), "onnx"),
    (dict(block="plain", input_shape=(8,)), "HybridBlock"),
], ids=["no-input-shape", "no-source", "two-sources", "ckpt-no-block",
        "symbol", "onnx", "not-hybrid"])
def test_register_validation(registry, kwargs, match, tmp_path):
    kwargs = dict(kwargs)
    if kwargs.get("block") == "net":
        kwargs["block"] = _mlp()
    elif kwargs.get("block") == "plain":
        kwargs["block"] = gluon.Block()
    if kwargs.get("symbol") == "fc":
        # a graph whose weights are not given: three unbound inputs
        kwargs["symbol"] = mx.sym.FullyConnected(mx.sym.var("data"),
                                                 num_hidden=2)
    if kwargs.get("onnx") == "garbage":
        bad = tmp_path / "bad.onnx"
        bad.write_bytes(b"\xff\xff\xff\xff")
        kwargs["onnx"] = str(bad)
    with pytest.raises(MXNetError, match=match):
        registry.register("a", **kwargs)


def test_unknown_servable_raises(registry):
    with pytest.raises(MXNetError, match="no servable"):
        registry.servable("never-registered")
    with pytest.raises(MXNetError, match="no servable"):
        registry.infer("never-registered", np.ones(8, np.float32))


def test_multi_tenant_registry(registry):
    a, b = _mlp(out=3), _mlp(out=6)
    registry.register("a", block=a, input_shape=(8,), buckets=(1, 2),
                      max_wait_ms=1)
    registry.register("b", block=b, input_shape=(8,), buckets=(1, 2),
                      max_wait_ms=1)
    assert registry.names() == ["a", "b"] and len(registry) == 2
    x = np.random.RandomState(4).rand(8).astype(np.float32)
    assert registry.infer("a", x, timeout=10).shape == (3,)
    assert registry.infer("b", x, timeout=10).shape == (6,)
    registry.unregister("a")
    assert "a" not in registry and "b" in registry


def test_multi_output_model():
    class TwoHead(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.a = gluon.nn.Dense(3)
                self.b = gluon.nn.Dense(2)

        def hybrid_forward(self, F, x):
            return self.a(x), self.b(x)

    net = TwoHead()
    net.initialize(device="cpu")
    s = serving.ModelRegistry().register(
        "two", block=net, input_shape=(8,), buckets=(1,), max_wait_ms=1)
    try:
        out = s.infer(np.ones(8, np.float32), timeout=10)
        assert isinstance(out, tuple) and len(out) == 2
        assert out[0].shape == (3,) and out[1].shape == (2,)
        assert s._pool.num_outputs == 2
    finally:
        s.close()


# ---------------------------------------------------------------------
# executor pool: buckets and warm-up
# ---------------------------------------------------------------------

def test_warmup_runs_every_bucket_once(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(4, 1, 2, 2), max_wait_ms=1,
                          warmup=False)
    assert s.buckets == (1, 2, 4) and s._pool.warm_buckets() == []
    seen = []
    fn = s._pool._fn
    s._pool._fn = lambda x: seen.append(x.shape[0]) or fn(x)
    s._pool.warmup()
    assert seen == [1, 2, 4] and s._pool.warm_buckets() == [1, 2, 4]
    assert s.stats().get("batches", 0) == 0      # warm-up is not a batch
    assert s.infer(np.ones(8, np.float32), timeout=10).shape == (4,)
    assert s.stats()["batches"] == s.stats()["bucket_1"] == 1


def test_registration_warms_every_bucket(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(1, 2, 4), max_wait_ms=1)
    assert s._pool.warm_buckets() == [1, 2, 4]


@pytest.mark.parametrize("env,want", [(None, (1, 2, 4, 8, 16, 32)),
                                      ("2,4", (2, 4))])
def test_default_buckets_from_env(registry, monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv("MXNET_TPU_SERVING_BUCKETS", env)
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          max_wait_ms=1, warmup=False)
    assert s.buckets == want


def test_bucket_padding_matches_unpadded_numerics(registry):
    """A 3-request micro-batch pads to bucket 4; the pad row does not
    leak into the real rows' outputs."""
    net = _mlp()
    s = registry.register("mlp", block=net, input_shape=(8,),
                          buckets=(4,), max_wait_ms=100, max_queue=16)
    rng = np.random.RandomState(5)
    xs = [rng.rand(8).astype(np.float32) for _ in range(3)]
    futs = [s.submit(x, timeout=10) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(timeout=10),
                                   _forward(net, x[None])[0], rtol=1e-5,
                                   atol=1e-6)
    assert s.stats()["bucket_4"] == 1


def test_oversize_and_wrong_shape_rejected(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(1, 2), max_wait_ms=1)
    with pytest.raises(MXNetError):
        s.submit(np.ones((2, 8), np.float32))    # batched request
    with pytest.raises(MXNetError):
        s.submit(np.ones(9, np.float32))         # wrong sample shape
    with pytest.raises(MXNetError):
        s._pool.bucket_for(3)                    # beyond largest bucket
    with pytest.raises(MXNetError):
        s._pool.call(3, np.zeros((3, 8), np.float32))   # not a bucket


# ---------------------------------------------------------------------
# dynamic batcher semantics
# ---------------------------------------------------------------------

def test_concurrent_requests_batch_dynamically(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(1, 2, 4, 8), max_wait_ms=100,
                          max_queue=64)
    n = 8
    barrier = threading.Barrier(n)
    outs = [None] * n

    def client(i):
        barrier.wait()
        outs[i] = s.infer(np.full(8, i, np.float32), timeout=10)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in outs)
    stats = s.stats()
    assert stats["responses"] == n
    assert stats["responses"] / stats["batches"] > 1, \
        "no dynamic batching happened"
    assert sum(v for k, v in stats.items()
               if k.startswith("bucket_")) == stats["batches"]


def test_per_request_timeout_sheds_queued_request(registry):
    """A request whose deadline passes while still queued resolves with
    RequestTimeout and never occupies a batch slot."""
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(8,), max_wait_ms=500, max_queue=16)
    fut = s.submit(np.ones(8, np.float32), timeout=0.02)
    with pytest.raises(RequestTimeout):
        fut.result(timeout=10)
    assert s.stats().get("timeouts") == 1
    assert s.stats().get("batches", 0) == 0


def test_queue_full_sheds_with_backpressure(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(1,), max_wait_ms=1, max_queue=2)
    gate = threading.Event()
    started = threading.Event()
    orig = s._pool.call

    def slow(bucket, x):
        started.set()
        gate.wait(20)
        return orig(bucket, x)

    s._pool.call = slow
    x = np.ones(8, np.float32)
    first = s.submit(x, timeout=None)
    assert started.wait(10)        # worker is busy inside dispatch
    q1 = s.submit(x)               # queue: 1
    q2 = s.submit(x)               # queue: 2 == max_queue
    assert s.queue_depth() == 2 == s.queue_capacity
    with pytest.raises(ServingQueueFull):
        s.submit(x)                # shed
    assert s.stats()["shed"] == 1
    gate.set()
    for f in (first, q1, q2):      # backlogged requests still complete
        assert f.result(timeout=20) is not None


def test_graceful_drain_loses_no_responses(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(4,), max_wait_ms=2000, max_queue=64)
    futs = [s.submit(np.full(8, i, np.float32)) for i in range(10)]
    s.close(drain=True)            # returns after the queue is drained
    for f in futs:
        assert f.result(timeout=0.5) is not None
    with pytest.raises(ServableClosed):
        s.submit(np.ones(8, np.float32))


def test_close_without_drain_resolves_pending_as_closed(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(4,), max_wait_ms=2000, max_queue=64)
    futs = [s.submit(np.ones(8, np.float32)) for _ in range(3)]
    s.close(drain=False)
    resolved = 0
    for f in futs:
        try:
            f.result(timeout=0.5)
            resolved += 1
        except ServableClosed:
            resolved += 1
    assert resolved == 3           # every future resolved, none dropped


def test_reregister_replaces_and_drains_old(registry):
    net1, net2 = _mlp(), _mlp()
    registry.register("m", block=net1, input_shape=(8,), buckets=(1,),
                      max_wait_ms=1)
    old = registry.servable("m")
    pending = old.submit(np.ones(8, np.float32))
    registry.register("m", block=net2, input_shape=(8,), buckets=(1,),
                      max_wait_ms=1)
    assert old.closed
    assert pending.result(timeout=1) is not None
    x = np.random.RandomState(7).rand(8).astype(np.float32)
    np.testing.assert_allclose(registry.infer("m", x, timeout=10),
                               _forward(net2, x[None])[0], rtol=1e-5,
                               atol=1e-6)


def test_dispatch_error_fails_requests_not_worker(registry):
    s = registry.register("mlp", block=_mlp(), input_shape=(8,),
                          buckets=(1,), max_wait_ms=1, max_queue=8)

    def boom(bucket, x):
        raise RuntimeError("device fell over")

    orig = s._pool.call
    s._pool.call = boom
    with pytest.raises(RuntimeError):
        s.infer(np.ones(8, np.float32), timeout=10)
    s._pool.call = orig            # worker survived; serving resumes
    assert s.infer(np.ones(8, np.float32), timeout=10).shape == (4,)
    assert s.stats()["errors"] == 1


# ---------------------------------------------------------------------
# the slice's path at narrow width: a ResNet served from a checkpoint
# ---------------------------------------------------------------------

def test_narrow_resnet_served_from_a_checkpoint(tmp_path, monkeypatch):
    """A narrow NHWC ResNet v1 saved by ``save_training`` and served by
    ``register(block=<fresh net>, checkpoint=)``: every response agrees
    with the JAX package's forward of the same weights and with the
    port's own forward; the fused sites run the plain
    ``bn_relu_apply`` once per site per executor call; the net trains
    afterwards (no inference-mode tensor reaches its graph)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(7, 32, 32, 3).astype(np.float32)
    np.random.seed(0)
    jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.array(xs[:1]))
    net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, _weights(jnet))
    root = str(tmp_path / "ck")
    CheckpointManager(root).save_training(3, net)
    want = jnet(jmx.nd.array(xs)).asnumpy()

    spec = kernel_registry.get("bn_relu_apply")
    plain, calls = spec.plain, []
    monkeypatch.setattr(spec, "plain", lambda *a, **k: calls.append(
        a[0].shape) or plain(*a, **k))
    _forward(net, xs[:1])
    sites = len(calls)
    assert sites == 8        # 2 per bottleneck; the thumbnail stem has no BN

    fresh = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    fresh.initialize(device="cpu")
    reg = serving.ModelRegistry()
    try:
        s = reg.register("resnet", block=fresh, checkpoint=root,
                         input_shape=(32, 32, 3), buckets=(1, 2, 4),
                         max_wait_ms=50)
        calls.clear()
        futs = [s.submit(x, timeout=30) for x in xs]
        got = np.stack([f.result(timeout=30) for f in futs])
        executor_calls = s.stats()["batches"]
        assert len(calls) == sites * executor_calls
        assert s.stats()["responses"] == len(xs)
    finally:
        reg.shutdown(drain=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for i, x in enumerate(xs):
        np.testing.assert_allclose(got[i], _forward(fresh, x[None])[0],
                                   rtol=1e-5, atol=1e-6)
    tr = gluon.Trainer(fresh.collect_params(), "sgd", {"learning_rate": 0.1})
    step = TrainStep(fresh, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    losses = [float(step(xs[:4], np.arange(4, dtype=np.float32)))
              for _ in range(2)]
    assert losses[1] < losses[0]


# ---------------------------------------------------------------------
# the generative tier from a checkpoint
# ---------------------------------------------------------------------

GEOM = dict(vocab_size=32, units=16, num_layers=2, num_heads=2, max_seq=32)
ENGINE_KW = dict(prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
                 block_size=4, num_blocks=64, max_queue=16)
PROMPTS = [[3, 7, 1, 9, 2], [5, 5, 6], [1, 2, 3, 4]]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_register_generative_from_a_checkpoint(tmp_path, writer):
    """``register_generative(checkpoint=)`` streams the same greedy
    tokens as ``params=`` on the same weights, from a step written by
    either package."""
    model = tiny_gpt(**GEOM)
    jparams = {k: np.asarray(v)
               for k, v in jax_tiny_gpt(**GEOM).init_params(2).items()}
    root = str(tmp_path / "ck")
    if writer == "port":
        CheckpointManager(root).save(4, {"params": jparams})
    else:
        JCheckpointManager(root).save(4, {"params": jparams})
    reg = serving.ModelRegistry()
    try:
        reg.register_generative("p", model, params=jparams, device="cpu",
                                **ENGINE_KW)
        reg.register_generative("c", model, checkpoint=root,
                                device="cpu", **ENGINE_KW)
        for prompt in PROMPTS:
            want = reg.generate("p", prompt, 6).tokens()
            assert reg.generate("c", prompt, 6).tokens() == want
            assert want == model.reference_decode(
                {k: torch.tensor(v) for k, v in jparams.items()},
                prompt, 6)
        with pytest.raises(MXNetError, match="exactly one"):
            reg.register_generative("x", model, device="cpu")
        with pytest.raises(MXNetError, match="no 'params' item"):
            CheckpointManager(root).save(5, {"blob": b"x"})
            reg.register_generative("x", model, checkpoint=root,
                                    device="cpu", **ENGINE_KW)
    finally:
        reg.shutdown(drain=True)
