"""The port's namesakes of the JAX package's plain MXNet API that it
lacked: each follows its JAX namesake's contract on the port's device
(``mx.context.gpu_memory_info``, ``mx.autograd.get_symbol``,
``mx.base.check_call``, ``analysis.memory.device_hbm_bytes``,
``telemetry.hooks.update_observability_doc``; ``Context.memory_info``
and ``empty_cache``, ``DeviceType``, ``Parameter(stype=, grad_stype=)``,
``TrainStep(donate=)``, ``gluon.model_zoo.get_model``, the op registry
``mx.ops.get_op``/``list_ops``/``register``/``Op``,
``BucketExecutorPool(pure_fn=, params=, cache=)`` and its
``compiled_buckets()``, ``DecodeEngine(cache=)``, ``hbm_plan(fn=,
args=)``, ``base.build_param_doc``/``camel_to_snake``,
``flatten_group(xp=)``, ``kernels.describe``/``remedy_for`` and
``mx.nd.ndarray.concat``/``transpose``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import base as jbase
from mxnet_tpu import bucketing as jbucketing
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.serving.executor import \
    BucketExecutorPool as JBucketExecutorPool
from mxnet_tpu.telemetry import hooks as jhooks

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, bucketing, gluon, kernels, ops
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.analysis import memory
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.serving.executor import BucketExecutorPool
from mxnet_tpu_torch.telemetry import hooks


def test_gpu_memory_info_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.context.gpu_memory_info()


def test_gpu_memory_info_is_mem_get_info(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def mem_get_info(device):
        seen.append(device)
        return (3 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert mx.context.gpu_memory_info(1) == (3 << 30, 80 << 30)
    assert seen == [1]


def test_get_symbol_raises_as_the_jax_one():
    with mx.cpu():
        x = mx.nd.array([1.0, 2.0])
    with pytest.raises(JMXNetError) as want:
        jautograd.get_symbol(jmx.nd.array([1.0, 2.0]))
    with pytest.raises(MXNetError) as got:
        mx.autograd.get_symbol(x)
    assert str(got.value) == str(want.value)


def test_check_call_is_a_no_op():
    assert mx.base.check_call(0) == jbase.check_call(0) == 0
    assert mx.base.check_call(None) is None


def test_device_hbm_bytes(monkeypatch):
    assert memory.device_hbm_bytes() is None          # the CPU

    class Props:
        total_memory = 85520809984

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    assert memory.device_hbm_bytes() == 85520809984


def test_update_observability_doc_names_the_missing_doc(tmp_path):
    with pytest.raises(MXNetError, match="no observability doc"):
        hooks.update_observability_doc()
    missing = tmp_path / "observability.md"
    with pytest.raises(MXNetError, match=str(missing)):
        hooks.update_observability_doc(str(missing))
    missing.write_text("no markers\n")
    with pytest.raises(MXNetError, match="missing the instrument-index"):
        hooks.update_observability_doc(str(missing))


def test_update_observability_doc_regenerates_the_ports_table(tmp_path):
    doc = tmp_path / "observability.md"
    doc.write_text("head\n%s\nstale\n%s\ntail\n"
                   % (hooks._INDEX_BEGIN, hooks._INDEX_END))
    new = hooks.update_observability_doc(str(doc))
    assert doc.read_text() == new
    head, rest = new.split(hooks._INDEX_BEGIN, 1)
    inside, tail = rest.split(hooks._INDEX_END, 1)
    assert head == "head\n" and tail == "\ntail\n"
    assert inside.strip("\n") == hooks.instrument_index_md().strip("\n")
    # the same generator as the JAX package's, over the port's registry
    assert jhooks.instrument_index_md().splitlines()[:2] \
        == hooks.instrument_index_md().splitlines()[:2]


def test_memory_info_surface():
    """``tests/test_profiler_runtime.py::test_memory_info_surface`` on
    the port: a host context keeps no statistics, ``(0, 0)`` as the JAX
    package gives for a backend without them."""
    used, limit = mx.cpu().memory_info()
    assert used >= 0 and limit >= 0
    assert (used, limit) == (0, 0)
    free, total = mx.context.gpu_memory_info() if mx.num_gpus() \
        else (0, 0)
    assert free >= 0 and total >= 0
    jused, jlimit = jmx.cpu().memory_info()
    assert jused >= 0 and jlimit >= 0
    assert mx.cpu().empty_cache() is None
    assert jmx.cpu().empty_cache() is None


def test_memory_info_of_a_card_is_the_allocators(monkeypatch):
    class Props:
        total_memory = 85520809984

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: seen.append(d) or 123456)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: Props)
    assert mx.gpu(1).memory_info() == (123456, 85520809984)
    assert seen == [torch.device("cuda", 1)]


def test_device_types_are_the_references():
    for k in ("kCPU", "kGPU", "kCPUPinned", "kCPUShared"):
        assert getattr(mx.context.DeviceType, k) \
            == getattr(jmx.context.DeviceType, k)
    shared = mx.Context("cpu_shared", 0)
    assert shared.device_typeid == jmx.Context("cpu_shared", 0) \
        .device_typeid == 5
    assert shared.torch_device() == torch.device("cpu")


def test_parameter_takes_the_storage_types():
    for stype in ("default", "row_sparse", "csr"):
        jp = jgluon.Parameter("w", shape=(2,), stype=stype,
                              grad_stype=stype)
        p = gluon.Parameter("w", shape=(2,), stype=stype, grad_stype=stype)
        assert (p.name, p.shape) == (jp.name, jp.shape)
    jd, d = jgluon.ParameterDict("n_"), gluon.ParameterDict("n_")
    jw = jd.get("w", shape=(3,), stype="row_sparse",
                grad_stype="row_sparse")
    w = d.get("w", shape=(3,), stype="row_sparse", grad_stype="row_sparse")
    assert (w.name, w.shape) == (jw.name, jw.shape) == ("n_w", (3,))


def test_train_step_takes_donate():
    """``donate`` changes nothing: two steps from one start, with and
    without it, end bitwise equal."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 5)
                         .astype(np.float32))
    y = torch.arange(4) % 3
    out = []
    for donate in (True, False):
        torch.manual_seed(0)
        net = gluon.nn.Dense(3, in_units=5)
        net.initialize(device="cpu")
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        loss = gluon.loss.SoftmaxCrossEntropyLoss()
        step = mx.parallel.TrainStep(net, loss, trainer, donate=donate)
        for _ in range(2):
            step(x, y)
        out.append([p._data.detach().clone()
                    for p in net.collect_params().values()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_get_model_is_the_vision_zoos():
    net = gluon.model_zoo.get_model("resnet18_v1", classes=10)
    jnet = jgluon.model_zoo.get_model("resnet18_v1", classes=10)
    assert type(net).__name__ == type(jnet).__name__ == "ResNetV1"
    assert gluon.model_zoo.get_model is gluon.model_zoo.vision.get_model


def test_list_ops_is_the_jax_list():
    assert ops.list_ops() == jmx.ops.list_ops()
    assert sorted(ops.OP_REGISTRY) == sorted(jmx.ops.OP_REGISTRY)
    assert len(ops.OP_REGISTRY) == len(jmx.ops.OP_REGISTRY)


def test_get_op_carries_the_jax_fields():
    """Name, aliases and variadic as the JAX ``Op``'s; the JAX tensor
    arguments lead the port's (``LeakyReLU`` takes ``gamma`` for its
    ``prelu`` form); every JAX parameter the port's has, with its
    default, but ``LayerNorm``'s ``use_pallas`` (the kernel switch)."""
    for name in jmx.ops.list_ops():
        j, p = jmx.ops.get_op(name), ops.get_op(name)
        assert (p.name, tuple(p.aliases), p.variadic) \
            == (j.name, tuple(j.aliases), j.variadic), name
        assert p.arg_names[:len(j.arg_names)] == j.arg_names, name
        mine = {q.name: q for q in p.params}
        for q in j.params:
            if (name, q.name) == ("LayerNorm", "use_pallas"):
                continue
            assert q.name in mine, (name, q.name)
            assert mine[q.name].has_default == q.has_default, (name, q.name)
        assert p == ops.OP_REGISTRY[name] and p.doc.startswith(
            (p.fcompute.__doc__ or "").strip().split("\n")[0])
    with pytest.raises(MXNetError, match="did you mean 'relu'"):
        ops.get_op("reluu")


def test_a_registered_op_runs_as_in_jax():
    """An op registered after import runs through ``mx.nd.invoke`` and
    in a loaded symbol graph's node, in both packages."""
    @jmx.ops.register("surface_twice_jax")
    def _jtwice(data, k=2.0):
        return data * k

    @ops.register("surface_twice")
    def twice(data, k=2.0):
        return data * k

    assert isinstance(twice, ops.Op) and twice.param_defaults() \
        == _jtwice.param_defaults() == {"k": 2.0}
    x = np.array([1.0, -2.0], np.float32)
    with mx.cpu():
        got = mx.nd.invoke(ops.get_op("surface_twice"), [mx.nd.array(x)],
                           {"k": 3.0}).asnumpy()
    want = jmx.nd.invoke(jmx.ops.get_op("surface_twice_jax"),
                         [jmx.nd.array(x)], {"k": 3.0}).asnumpy()
    np.testing.assert_array_equal(got, want)
    graph = jmx.sym.relu(jmx.sym.var("data")).tojson()
    jout = jmx.sym.load_json(graph.replace('"relu"', '"surface_twice_jax"')
                             ).eval(data=jmx.nd.array(x))[0].asnumpy()
    with mx.cpu():
        out = mx.sym.load_json(graph.replace('"relu"', '"surface_twice"')
                               ).eval(data=mx.nd.array(x))[0].asnumpy()
    np.testing.assert_array_equal(out, jout)
    free = ops.Op("free_add", lambda data, s=1.0: data + s, ("data",))
    assert [q.name for q in free.params] == ["s"]
    with mx.cpu():
        np.testing.assert_array_equal(
            mx.nd.invoke(free, [mx.nd.array(x)], {"s": 5.0}).asnumpy(),
            x + 5.0)


def _dense_pair():
    np.random.seed(0)
    jnet = jgluon.nn.Dense(3, in_units=4, prefix="pool_")
    jnet.initialize(ctx=jmx.cpu())
    net = gluon.nn.Dense(3, in_units=4, prefix="pool_")
    net.initialize(device="cpu")
    params_from_numpy(net, {n: p.data().asnumpy() for n, p in
                            jnet.collect_params().items()})
    return jnet, net


def test_pool_over_a_pure_function_and_its_compiled_buckets():
    """The JAX form ``BucketExecutorPool(pure_fn=, params=, ...)`` over
    ``functionalize(training=False)``: no bucket built before warm-up,
    every bucket after it, as the JAX pool; its outputs are the net's
    and the JAX pool's; ``cache=`` counts each warmed bucket a
    compile-cache miss."""
    jnet, net = _dense_pair()
    jpure, jnames, jmap = jnet.functionalize(training=False)
    key = jax.random.PRNGKey(0)
    jpool = JBucketExecutorPool(
        lambda pv, x: tuple(jpure(pv, [x], key)[0]),
        {n: jmap[n].data()._data for n in jnames}, (4,), "float32", (1, 2))
    pure, names, pmap = net.functionalize(training=False)
    pool = BucketExecutorPool(
        pure_fn=lambda pv, x: pure(pv, [x])[0],
        params={n: pmap[n]._data.detach() for n in names},
        input_shape=(4,), dtype="float32", buckets=(1, 2), device="cpu",
        cache=object())
    assert pool.compiled_buckets() == jpool.compiled_buckets() == []
    telemetry.enable()
    telemetry.reset("serving.")
    try:
        pool.warmup()
        assert telemetry.counter("serving.compile_cache_misses").value == 2
    finally:
        telemetry.disable()
    jpool.warmup()
    assert pool.compiled_buckets() == jpool.compiled_buckets() == [1, 2]
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    with torch.no_grad():
        got = pool.call(2, torch.from_numpy(x))[0]
        want = net(torch.from_numpy(x))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpool.call(2, x)[0]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(MXNetError, match="not both"):
        BucketExecutorPool(lambda x: (x,), (4,), "float32", (1,), "cpu",
                           pure_fn=pure)


def test_decode_engine_takes_cache():
    from mxnet_tpu_torch.serving.decode import DecodeEngine, tiny_gpt
    model = tiny_gpt(vocab_size=32, units=16, num_layers=1, num_heads=2,
                     max_seq=16)
    eng = DecodeEngine(model, model.init_params(seed=0, device="cpu"),
                       prefill_buckets=(8,), decode_buckets=(1, 2),
                       block_size=4, num_blocks=16, device="cpu",
                       cache=object())
    telemetry.enable()
    telemetry.reset("serving.")
    try:
        eng.warmup()
        assert telemetry.counter("serving.compile_cache_misses").value == 3
    finally:
        telemetry.disable()


def test_hbm_plan_measures_peaks_only_on_the_card():
    x = torch.zeros(4, 3)
    with pytest.raises(MXNetError, match="CUDA device"):
        memory.hbm_plan("f", fn=lambda t: t * 2, args=(x,))
    with pytest.raises(MXNetError, match="not both"):
        memory.hbm_plan("f", fn=lambda t: t, args=(x,), peaks={4: 1})


def test_param_doc_and_snake_case_are_the_jax_ones():
    for name in ("BatchNorm", "FullyConnected", "L2Normalization",
                 "softmax", "LayerNorm2D"):
        assert mx.base.camel_to_snake(name) == jbase.camel_to_snake(name)
    for op in ("Convolution", "Concat", "BatchNorm", "_zeros"):
        assert mx.base.build_param_doc(ops.get_op(op).params) \
            == jbase.build_param_doc(ops.get_op(op).params)
    jparams = jmx.ops.get_op("Dropout").params
    assert mx.base.build_param_doc(jparams) \
        == jbase.build_param_doc(jparams)


def test_flatten_group_takes_the_array_module():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.ones(4, np.float32), np.zeros((1, 2), np.float32)]
    want = jbucketing.flatten_group(arrays, [0, 2], np)
    np.testing.assert_array_equal(
        bucketing.flatten_group(arrays, [0, 2], np), want)
    got = bucketing.flatten_group([torch.from_numpy(a) for a in arrays],
                                  [0, 2])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bucketing.flatten_group(arrays, [1], xp=np), arrays[1])


def test_kernels_describe_and_remedy_for():
    table = kernels.describe()
    assert sorted(table) == kernels.list_kernels()
    for name, row in table.items():
        spec = kernels.get(name)
        assert row["source"] == spec.source and row["plain"].endswith(
            spec.plain.__qualname__) and row["doc"]
        assert "mode" not in row and "choice" not in row
    assert kernels.remedy_for("unfused-elementwise") \
        == "kernels.bn_relu_apply"
    assert kernels.remedy_for("memory-bound") == "kernels.lamb_phase1"
    assert kernels.remedy_for("no-such-kind") is None


def test_nd_module_concat_and_transpose():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    with mx.cpu():
        x = mx.nd.array(a)
        got = (mx.nd.ndarray.concat(x, x, dim=1).asnumpy(),
               mx.nd.ndarray.transpose(x).asnumpy(),
               mx.nd.ndarray.transpose(x, axes=(1, 0)).asnumpy())
    jx = jmx.nd.array(a)
    want = (jmx.nd.ndarray.concat(jx, jx, dim=1).asnumpy(),
            jmx.nd.ndarray.transpose(jx).asnumpy(),
            jmx.nd.ndarray.transpose(jx, axes=(1, 0)).asnumpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
