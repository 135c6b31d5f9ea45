"""The port's analysis on an NVIDIA GPU: the graph check's bind gate and
the audits of a walked step, on a narrow NHWC ResNet.

- (a) the gate: a hybridized net exported and bound on the card with
  ``check=True`` and under ``MXNET_TPU_GRAPH_CHECK=1``: the check alone
  allocates nothing and launches nothing, the checked forward is bitwise
  the unchecked one with ``bn_relu_apply`` at every fused site, and the
  broken twins raise ``GraphCheckError`` with no launch and no
  allocation;
- (b) the audits: a bf16 AMP LARS ``TrainStep`` walked and captured;
  the audits' numbers are the CostReport's, the hand kernels appear
  under their own names, the ridge is the card's, and the memory peak
  lies within 15% of ``torch.cuda.max_memory_allocated`` around the
  capture.

Every test here needs the card and skips without one.  The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX
it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_analysis.py
"""
import os

import pytest
import torch

pytestmark = pytest.mark.gpu

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
SITES = 8              # two a bottleneck, four bottlenecks (no stem BN)
PEAK_TOL = 0.15


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.delenv("MXNET_TPU_GRAPH_CHECK", raising=False)
    return torch.device("cuda")


def _net():
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                         ResNetV1)
    net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    net.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(0))
    return net


def _allocated():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _launched():
    from mxnet_tpu_torch.kernels import registry
    return sum(registry.launches(k) for k in registry.list_kernels())


@pytest.fixture
def exported(card, tmp_path):
    net = _net()
    x = torch.randn((8, 32, 32, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    net.hybridize()
    with torch.no_grad():
        for _ in range(2):
            net(x)
    sym_file, _params = net.export(str(tmp_path / "narrow"))
    return str(tmp_path / "narrow"), sym_file, x


def _bind(prefix, x, check):
    import mxnet_tpu_torch as mx
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    args = {k: v.as_in_context(mx.gpu(0)) for k, v in arg_params.items()}
    args["data"] = mx.nd.NDArray(x)
    aux = {k: v.as_in_context(mx.gpu(0)) for k, v in aux_params.items()}
    m0 = _allocated()
    ex = sym.bind(mx.gpu(0), args, grad_req="null", aux_states=aux,
                  check=check)
    return ex, _allocated() - m0, sym


def test_graph_check_allocates_and_launches_nothing(exported):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.kernels import registry
    prefix, _sym_file, x = exported
    sym, _a, _x = mx.model.load_checkpoint(prefix, 0)
    registry.reset_launches()
    m0 = _allocated()
    diags = analysis.check_symbol(sym, shapes={"data": tuple(x.shape)})
    assert _allocated() == m0 and _launched() == 0
    assert not [d for d in diags if d.severity == analysis.ERROR]


@pytest.mark.parametrize("how", ["check", "env"])
def test_checked_bind_runs_bitwise_like_the_unchecked(exported, monkeypatch,
                                                      how):
    from mxnet_tpu_torch.kernels import registry
    prefix, _sym_file, x = exported
    outs = {}
    for route in ("plain", how):
        if route == "env":
            monkeypatch.setenv("MXNET_TPU_GRAPH_CHECK", "1")
        ex, delta, _sym = _bind(prefix, x, True if route == "check"
                                else (None if route == "env" else False))
        monkeypatch.delenv("MXNET_TPU_GRAPH_CHECK", raising=False)
        assert delta == 0
        with torch.no_grad():
            for _ in range(2):
                ex.forward(is_train=False)
            registry.reset_launches()
            outs[route] = ex.forward(is_train=False)[0]._data.clone()
        assert registry.launches("bn_relu_apply") == SITES
    assert torch.equal(outs["plain"], outs[how])


def _twin(sym_file, rule):
    from mxnet_tpu_torch.symbol import load as sym_load
    sym = sym_load(sym_file)
    nodes = sym._topo()
    if rule == "duplicate-input":
        site = next(n for n in nodes if n.op == "fused_batch_norm_relu")
        site.inputs[2][0].name = site.inputs[1][0].name
    elif rule == "shape-contradiction":
        fc = next(n for n in nodes if n.op == "FullyConnected")
        fc.inputs[1][0].attrs["__shape__"] = "(10, 7)"
    else:
        next(n for n in nodes if n.op == "Convolution").op = "Convolutionn"
    return sym


@pytest.mark.parametrize("how", ["check", "env"])
@pytest.mark.parametrize("rule", ["duplicate-input", "shape-contradiction",
                                  "unknown-op"])
def test_broken_twins_raise_with_no_launch_and_no_allocation(
        exported, monkeypatch, rule, how):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.kernels import registry
    _prefix, sym_file, x = exported
    twin = _twin(sym_file, rule)
    if how == "env":
        monkeypatch.setenv("MXNET_TPU_GRAPH_CHECK", "1")
    registry.reset_launches()
    m0 = _allocated()
    with pytest.raises(analysis.GraphCheckError) as ei:
        twin.simple_bind(mx.gpu(0), grad_req="null",
                         check=True if how == "check" else None,
                         data=tuple(x.shape))
    assert rule in {d.rule for d in ei.value.diagnostics}
    assert _allocated() == m0 and _launched() == 0


def test_audits_of_a_walked_captured_step(card):
    from mxnet_tpu_torch import amp, analysis, gluon, profiling
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.profiling import roofline, store
    profiling.reset()
    profiling.enable()
    try:
        net = _net()
        tr = gluon.Trainer(net.collect_params(), "lars",
                           {"learning_rate": 0.1, "momentum": 0.9})
        step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        g = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn((32, 32, 32, 3), generator=g, device="cuda")
        y = torch.randint(0, 10, (32,), generator=g, device="cuda").float()
        with amp.scope("bfloat16"):
            step(x, y)                      # eager, walked
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(x, y)                      # captured
            torch.cuda.synchronize()
            capture_peak = torch.cuda.max_memory_allocated()
        p, n, m = (analysis.perf_audit(), analysis.numerics_audit(),
                   analysis.memory_audit())
        reps = {rep["label"]: rep for _k, rep, _c in store.audited()}
    finally:
        profiling.disable()
        profiling.reset()
    label = "train_step:ResNetV1"
    rep = reps[label]
    pm = p["executables"][label]["metrics"]
    assert pm["flops"] == int(rep["totals"]["flops"])
    assert pm["bytes"] == int(rep["totals"]["bytes_accessed"])
    assert {"bn_relu_apply", "bn_relu_bwd", "lars_flat"} <= \
        set(p["executables"][label]["kernels"])
    assert n["executables"][label]["metrics"]["convert_share"] > 0
    fl, bw, assumed = roofline.device_peaks(dtype="bfloat16")
    if not assumed:
        assert p["peaks_assumed"] is False
        assert abs(p["ridge_intensity"] - fl / bw) < 1e-2
    peak = m["executables"][label]["metrics"]["peak_hbm_bytes"]
    assert peak == rep["memory"]["peak_hbm_bytes"]
    assert abs(peak - capture_peak) <= PEAK_TOL * capture_peak, \
        (peak, capture_peak)
    for mod, art in ((analysis.perf, p), (analysis.numerics, n),
                     (analysis.memory, m)):
        assert mod.diff_audit(art, art) == []
    assert os.environ.get("MXNET_TPU_GRAPH_CHECK") is None
