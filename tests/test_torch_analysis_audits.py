"""The port's audits of the walked steps on the CPU: ``perf_audit``,
``numerics_audit`` and ``memory_audit`` over the CostReports that
``mx.profiling`` registers, ``hbm_plan``, and the graph check's bind
gate.

A narrow NHWC ResNet ``TrainStep`` (bf16 AMP, bucketed LARS) and a
narrow bf16 BERT ``TrainStep`` (Adam) are walked with ``device="cpu"``;
then:

- each audit's numbers per label are its CostReport's (flops, bytes,
  the memory section), and the hand kernels (``bn_relu_*``,
  ``lars_flat``, the flash and LayerNorm kernels) appear once, under
  their own names, charged at their cost functions;
- the AMP casts show as ``convert_share > 0``; the hand kernels, which
  accumulate in fp32, add no half-accumulating bytes;
- planted cases fire: an NCHW net's layout advisory, a bf16
  reduction's ``half_reduce_share``, a retained temporary's growth of
  the memory audit (``memory-drift`` naming the step and its peak);
- ``diff_audit`` of each artifact against itself is clean, and a copy
  with one metric grown past the tolerance names the step and metric;
- ``hbm_plan``'s module function and ``BucketExecutorPool.hbm_plan``
  agree;
- ``Executor(check=True)``, ``simple_bind(check=True)`` and
  ``MXNET_TPU_GRAPH_CHECK=1`` raise ``GraphCheckError`` on the broken
  twins before anything is allocated, and a clean graph binds.
"""
import copy

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, analysis, gluon, profiling
from mxnet_tpu_torch.analysis import memory, numerics, perf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.profiling import store

RESNET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
BERT = dict(vocab_size=200, units=64, hidden_size=128, num_layers=2,
            num_heads=2, max_length=64)


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _resnet_step(layout):
    net = ResNetV1(BottleneckV1, layout=layout, **RESNET)
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(0))
    tr = gluon.Trainer(net.collect_params(), "lars",
                       {"learning_rate": 0.1, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    rng = np.random.default_rng(0)
    shape = (4, 32, 32, 3) if layout == "NHWC" else (4, 3, 32, 32)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4).astype(np.float32))
    return step, x, y


class _MLMLoss(gluon.HybridBlock):
    def __init__(self, vocab, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outs, labels):
        return self._ce(outs[0].reshape(-1, self._vocab),
                        labels.reshape(-1))


def _bert_step():
    net = BERTModel(dropout=0.0, **BERT)
    net.initialize(device="cpu")
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3})
    step = TrainStep(net, _MLMLoss(BERT["vocab_size"]), tr)
    rng = np.random.default_rng(0)
    v = BERT["vocab_size"]
    ids = torch.from_numpy(rng.integers(0, v, (2, 32)).astype(np.float32))
    return step, ids, ids.clone()


def _walked(run):
    """Run ``run()`` with profiling on; returns the three audits and
    ``{label: (report, audit counters)}``."""
    profiling.reset()
    profiling.enable()
    try:
        run()
        audits = (analysis.perf_audit(), analysis.numerics_audit(),
                  analysis.memory_audit())
        reps = {rep["label"]: (rep, counters)
                for _k, rep, counters in store.audited()}
    finally:
        profiling.disable()
        profiling.reset()
    return audits, reps


@pytest.fixture(scope="module")
def resnet_walk():
    def run():
        with mx.cpu():
            step, x, y = _resnet_step("NHWC")
            with amp.scope("bfloat16"):
                step(x, y)
    return _walked(run)


@pytest.fixture(scope="module")
def bert_walk():
    def run():
        with mx.cpu():
            step, ids, labels = _bert_step()
            with amp.scope("bfloat16"):
                step(ids, labels)
    return _walked(run)


WALKS = {"resnet": ("train_step:ResNetV1",
                    ("bn_relu_apply", "bn_relu_bwd", "lars_flat")),
         "bert": ("train_step:BERTModel",
                  ("flash_attention_fwd", "flash_attention_bwd",
                   "layernorm_fwd"))}


@pytest.fixture
def walk(request, resnet_walk, bert_walk):
    return {"resnet": resnet_walk, "bert": bert_walk}[request.param]


@pytest.mark.parametrize("walk", sorted(WALKS), indirect=True)
def test_audits_are_their_cost_reports(walk, request):
    label, _kernels = WALKS[request.node.callspec.params["walk"]]
    (p, n, m), reps = walk
    rep, _c = reps[label]
    pm = p["executables"][label]["metrics"]
    assert pm["flops"] == int(rep["totals"]["flops"])
    assert pm["bytes"] == int(rep["totals"]["bytes_accessed"])
    assert n["executables"][label]["metrics"]["bytes_total"] == pm["bytes"]
    mm = m["executables"][label]["metrics"]
    for k in ("argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes", "peak_hbm_bytes"):
        assert mm[k] == rep["memory"][k], k
    for audit, schema in ((p, perf.AUDIT_SCHEMA),
                          (n, numerics.AUDIT_SCHEMA),
                          (m, memory.AUDIT_SCHEMA)):
        assert audit["schema"] == schema and audit["backend"] == "cpu"


@pytest.mark.parametrize("walk", sorted(WALKS), indirect=True)
def test_hand_kernels_appear_once_under_their_names(walk, request):
    label, kernels = WALKS[request.node.callspec.params["walk"]]
    (p, n, _m), reps = walk
    _rep, counters = reps[label]
    got = p["executables"][label]["kernels"]
    assert set(kernels) <= set(got)
    prov = {e["op_name"]: e for e in _rep["provenance"] if e.get("kernel")}
    for k in kernels:
        assert got[k] == prov[k]["bytes"] > 0
    # the kernels accumulate in fp32: no half-accumulating bytes of theirs
    for k in kernels:
        assert k not in counters["half_dots"]
        assert k not in counters["half_reduces"]
    # the AMP casts
    assert n["executables"][label]["metrics"]["convert_share"] > 0


def test_intensity_is_held_against_the_assumed_ridge_off_the_card(
        resnet_walk):
    (p, _n, _m), _reps = resnet_walk
    assert p["peaks_assumed"] is True
    pm = p["executables"]["train_step:ResNetV1"]["metrics"]
    assert pm["ridge_intensity"] == p["ridge_intensity"]
    assert any(a["kind"] == "memory-bound" for a in p["advisories"])


def test_nchw_net_gets_the_layout_advisory(resnet_walk):
    (p_nhwc, _n, _m), _r = resnet_walk

    def run():
        with mx.cpu():
            step, x, y = _resnet_step("NCHW")
            step(x, y)
    (p, _n2, _m2), _reps = _walked(run)
    kinds = {a["kind"] for a in p["executables"]["train_step:ResNetV1"]
             ["advisories"]}
    assert "layout-nchw-conv" in kinds
    assert p["executables"]["train_step:ResNetV1"]["metrics"][
        "nchw_conv_share"] == 1.0
    nhwc = p_nhwc["executables"]["train_step:ResNetV1"]
    assert nhwc["metrics"]["nchw_conv_share"] == 0.0
    assert "layout-nchw-conv" not in {a["kind"] for a in
                                      nhwc["advisories"]}
    diags = perf.diff_audit(p_nhwc, p)
    assert any("layout-nchw-conv" in d.message for d in diags)


@pytest.mark.parametrize("dtype,fires", [(torch.bfloat16, True),
                                         (torch.float32, False)])
def test_bf16_reduction_sets_half_reduce_share(dtype, fires):
    x = torch.randn(64, 128)

    def run():
        profiling.capture_jit("probe:reduce",
                              lambda t: t.to(dtype).sum(dim=1), (x,))
    (_p, n, _m), _reps = _walked(run)
    e = n["executables"]["probe:reduce"]
    assert (e["metrics"]["half_reduce_share"] > 0) is fires
    assert ("half-reduce" in {a["kind"] for a in e["advisories"]}) is fires


def test_retained_temporary_grows_the_memory_audit():
    x = torch.randn(256, 128)

    def clean(t):
        return (t @ t.T).sum()

    def retaining(t):
        tmp = t @ t.T
        return tmp.sum(), tmp          # the temporary outlives the step

    audits = {}
    for name, fn in (("clean", clean), ("retaining", retaining)):
        def run(fn=fn):
            profiling.capture_jit("probe:step", fn, (x,))
        (_p, _n, m), _reps = _walked(run)
        audits[name] = m
    base = audits["clean"]["executables"]["probe:step"]["metrics"]
    cur = audits["retaining"]["executables"]["probe:step"]["metrics"]
    assert cur["output_bytes"] == base["output_bytes"] + 256 * 256 * 4
    assert cur["peak_hbm_bytes"] > base["peak_hbm_bytes"]
    diags = memory.diff_audit(audits["clean"], audits["retaining"])
    assert [d.rule for d in diags] == ["memory-drift"]
    assert diags[0].node == "probe:step" and "peak HBM" in \
        diags[0].message


@pytest.mark.parametrize("which,metric", [
    ("perf", "unfused_elementwise_share"), ("numerics", "convert_share"),
    ("memory", "peak_hbm_bytes")])
def test_diff_audit_self_clean_and_grown_metric_named(resnet_walk, which,
                                                      metric):
    (p, n, m), _reps = resnet_walk
    mod, art = {"perf": (perf, p), "numerics": (numerics, n),
                "memory": (memory, m)}[which]
    assert mod.diff_audit(art, art) == []
    grown = copy.deepcopy(art)
    mets = grown["executables"]["train_step:ResNetV1"]["metrics"]
    mets[metric] = mets[metric] * 1.5 if metric == "peak_hbm_bytes" \
        else mets[metric] + 0.05
    diags = mod.diff_audit(art, grown)
    assert len(diags) == 1
    d = diags[0]
    assert d.rule == "%s-drift" % which and d.node == "train_step:ResNetV1"
    assert (metric if metric != "peak_hbm_bytes" else "peak HBM") in \
        d.message


def test_hbm_plan_function_and_pool_method_agree():
    from mxnet_tpu_torch.serving.executor import BucketExecutorPool
    pool = BucketExecutorPool(lambda t: (t,), (8,), "float32",
                              (1, 2, 4, 8), torch.device("cpu"))
    pool._peaks = {1: 1100, 2: 1200}
    for limit in (1550, None, 900):
        got = pool.hbm_plan(device_hbm_bytes=limit)
        want = analysis.hbm_plan(got["label"], limit, buckets=(1, 2, 4, 8),
                                 peaks={1: 1100, 2: 1200})
        assert got == want
    with pytest.raises(ValueError, match="measured peaks"):
        analysis.hbm_plan("nope")


# ----------------------------------------------------------------------
# the bind gate
# ----------------------------------------------------------------------

def _mlp():
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mx.sym.Activation(fc, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _duplicate():
    return mx.sym.var("x") + mx.sym.var("x")


def _contradiction():
    return mx.sym.dot(mx.sym.var("x", shape=(4, 5)),
                      mx.sym.var("w", shape=(3, 7)))


def _unknown_op():
    from mxnet_tpu_torch.symbol.symbol import Symbol, _Node
    v = _Node(None, "x", {}, [])
    return Symbol([(_Node("Convolutionn", "bad0", {}, [(v, 0)]), 0)])


TWINS = {"duplicate-input": _duplicate,
         "shape-contradiction": _contradiction,
         "unknown-op": _unknown_op}


@pytest.fixture
def no_allocation(monkeypatch):
    """Counts the NDArrays ``simple_bind`` makes."""
    from mxnet_tpu_torch import ndarray
    made = []
    real = ndarray.zeros

    def counting(*a, **k):
        made.append(a)
        return real(*a, **k)
    monkeypatch.setattr(ndarray, "zeros", counting)
    return made


@pytest.mark.parametrize("how", ["check", "env"])
@pytest.mark.parametrize("rule", sorted(TWINS))
def test_broken_twin_raises_before_anything_is_allocated(
        monkeypatch, no_allocation, rule, how):
    kwargs = {"check": True} if how == "check" else {}
    if how == "env":
        monkeypatch.setenv("MXNET_TPU_GRAPH_CHECK", "1")
    with pytest.raises(analysis.GraphCheckError) as ei:
        TWINS[rule]().simple_bind(ctx=mx.cpu(), grad_req="null", x=(4, 5),
                                  **kwargs)
    assert isinstance(ei.value, MXNetError)
    assert rule in str(ei.value)
    assert [d.rule for d in ei.value.diagnostics] == [rule]
    assert no_allocation == []
    if rule == "unknown-op":
        assert "did you mean 'Convolution'" in str(ei.value)


def test_executor_check_over_bound_arrays():
    sym = mx.sym.dot(mx.sym.var("a"), mx.sym.var("b"))
    args = {"a": mx.nd.ones((4, 5)), "b": mx.nd.ones((3, 7))}
    with pytest.raises(analysis.GraphCheckError, match="shape-"):
        sym.bind(mx.cpu(), args, check=True)
    ok = {"a": mx.nd.ones((4, 5)), "b": mx.nd.ones((5, 7))}
    out = sym.bind(mx.cpu(), ok, check=True).forward()[0]
    assert out.shape == (4, 7)


@pytest.mark.parametrize("how", ["check", "env"])
def test_clean_graph_binds_and_runs_like_the_unchecked(monkeypatch, how):
    kwargs = {"check": True} if how == "check" else {}
    if how == "env":
        monkeypatch.setenv("MXNET_TPU_GRAPH_CHECK", "1")
    checked = _mlp().simple_bind(ctx=mx.cpu(), grad_req="null",
                                 data=(2, 16), **kwargs)
    monkeypatch.delenv("MXNET_TPU_GRAPH_CHECK", raising=False)
    plain = _mlp().simple_bind(ctx=mx.cpu(), grad_req="null",
                               data=(2, 16))
    rng = np.random.default_rng(0)
    for name in checked.arg_dict:
        v = rng.standard_normal(checked.arg_dict[name].shape)
        checked.arg_dict[name][:] = mx.nd.array(v.astype(np.float32))
        plain.arg_dict[name][:] = mx.nd.array(v.astype(np.float32))
    a = checked.forward()[0].asnumpy()
    b = plain.forward()[0].asnumpy()
    assert a.shape == (2, 4) and np.array_equal(a, b)
