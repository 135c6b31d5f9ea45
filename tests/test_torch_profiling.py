"""The port's ``mx.profiling`` against the JAX package's on the CPU.

One small convolutional net (two 3x3 convolutions of 64 channels, no
padding, and a Dense head), built the same in both packages from the
same numpy inputs, runs one ``TrainStep`` and one hybridized forward
with profiling on; then:

- the reports have the same keys, section for section;
- the port's ``conv_dot`` flops equal the JAX report's within 1%.  The
  JAX package's per-category split on the CPU backend rests on an HLO
  estimate that misses the backend's convolution calls, so the JAX
  side's convolution/dot flops are XLA's executable total less the
  JAX report's own estimates of everything that is not a convolution
  or dot (no padding: XLA counts a padded tap as no work, the flop
  counter counts every tap);
- ``roofline.build`` of each package on the same report, step time and
  peaks gives equal dicts;
- ``mxprof report`` and ``mxprof diff`` print the same text from
  either package's CLI on a report file written by the other;
- ``TrainStep.cost_analysis()`` returns the report's flops, and a
  hand kernel's plain version on the CPU is charged once, as its
  kernel, at its cost function.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import profiling as jprof
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.profiling import cli as jcli
from mxnet_tpu.profiling import roofline as jroofline

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel, profiling
from mxnet_tpu_torch.profiling import cli as pcli
from mxnet_tpu_torch.profiling import roofline as proofline

SHAPE = (8, 64, 10, 10)
CLASSES = 10
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _layers(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(64, 3, in_channels=64), nn.Activation("relu"),
            nn.Conv2D(64, 3, strides=2, in_channels=64),
            nn.Activation("relu"), nn.Flatten(),
            nn.Dense(CLASSES, in_units=64 * 3 * 3))
    return net


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.integers(0, CLASSES, SHAPE[0]).astype(np.float32))


def _exact_conv_dot_flops(train):
    """2 x MACs of each product; training adds the weight gradient of
    every layer and the data gradient of all but the first."""
    n = SHAPE[0]
    conv1 = n * 64 * 8 * 8 * 2 * 9 * 64
    conv2 = n * 64 * 3 * 3 * 2 * 9 * 64
    dense = n * 2 * 64 * 9 * CLASSES
    if not train:
        return conv1 + conv2 + dense
    return 2 * conv1 + 3 * conv2 + 3 * dense


@pytest.fixture(scope="module")
def reports():
    """Both packages' reports of the step and the forward, computed
    once per module."""
    x, y = _data()
    jprof.reset()
    profiling.reset()
    jprof.enable()
    profiling.enable()
    try:
        jnet = _layers(jgluon.nn)
        jnet.initialize(ctx=jmx.cpu())
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD,
                             kvstore=None)
        jstep = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                           jtr, mesh=None)
        jstep(jmx.nd.array(x), jmx.nd.array(y))
        jnet.hybridize()
        jnet(jmx.nd.array(x))
        jreps = {r["label"]: r for r in jprof.reports()}
        with mx.cpu():
            net = _layers(gluon.nn)
            net.initialize(device="cpu")
            tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
            step = parallel.TrainStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
            step(torch.from_numpy(x), torch.from_numpy(y))
            net.hybridize()
            net(mx.nd.array(x))
        preps = {r["label"]: r for r in profiling.reports()}
        jcomb, pcomb = jprof.combined_report(), profiling.combined_report()
    finally:
        jprof.disable()
        profiling.disable()
        jprof.reset()
        profiling.reset()
    return {"jax": jreps, "port": preps, "jax_combined": jcomb,
            "port_combined": pcomb, "step": step}


def _jax_conv_dot(rep):
    rest = sum(v["flops"] for c, v in rep["estimates"].items()
               if c != "conv_dot")
    return rep["totals"]["flops"] - rest


LABELS = ("train_step:HybridSequential", "hybrid:HybridSequential")


@pytest.mark.parametrize("label", LABELS)
def test_report_keys_and_conv_dot_flops_match_the_jax_package(reports,
                                                              label):
    jrep, prep = reports["jax"][label], reports["port"][label]
    assert sorted(jrep) == sorted(prep)
    for section in ("totals", "memory", "estimates", "categories"):
        assert sorted(jrep[section]) == sorted(prep[section]), section
    for cat in prep["categories"]:
        assert sorted(prep["categories"][cat]) == \
            sorted(jrep["categories"][cat])
    assert prep["schema"] == jrep["schema"] == "mxprof.cost_report.v1"
    assert prep["kind"] == jrep["kind"]
    assert prep["backend"] == "cpu" and prep["device"] == "cpu"
    got = prep["categories"]["conv_dot"]["flops"]
    assert got == _exact_conv_dot_flops(label.startswith("train"))
    want = _jax_conv_dot(jrep)
    assert abs(got - want) <= 0.01 * want, (got, want)
    # categories sum exactly to the totals (the mxprof contract)
    assert sum(c["flops"] for c in prep["categories"].values()) == \
        prep["totals"]["flops"]
    assert sum(c["bytes"] for c in prep["categories"].values()) == \
        prep["totals"]["bytes_accessed"]
    assert len(prep["fingerprint"]) == 16


@pytest.mark.parametrize("which", ["jax", "port"])
def test_roofline_build_gives_equal_numbers(reports, which):
    rep = reports[which]["train_step:HybridSequential"]
    for kw in ({}, {"peak_flops": 989e12, "peak_bytes_per_s": 3.35e12,
                    "items_per_step": 8}):
        assert proofline.build(rep, 0.0125, **kw) == \
            jroofline.build(rep, 0.0125, **kw)


def test_h100_peaks_and_the_assumed_path():
    assert proofline.device_peaks("NVIDIA H100 80GB HBM3") == \
        (989e12, 3.35e12, False)
    assert proofline.device_peaks("NVIDIA H100 80GB HBM3",
                                  dtype="float32") == (67e12, 3.35e12,
                                                       False)
    assert proofline.device_peaks("cpu") == jroofline.device_peaks("cpu")
    assert proofline.device_peaks("cpu")[2] is True


def _cli_text(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_mxprof_report_and_diff_read_the_other_package_files(
        reports, tmp_path, capsys):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    (jdir / "report.json").write_text(json.dumps(reports["jax_combined"]))
    (pdir / "report.json").write_text(json.dumps(reports["port_combined"]))
    for d in (jdir, pdir):
        jtext = _cli_text(jcli.main, ["report", "--dir", str(d)], capsys)
        ptext = _cli_text(pcli.main, ["report", "--dir", str(d)], capsys)
        assert jtext == ptext and jtext[0] == 0
        assert "executables:" in ptext[1]
        same = [str(d / "report.json")] * 2
        assert _cli_text(jcli.main, ["diff"] + same, capsys) == \
            _cli_text(pcli.main, ["diff"] + same, capsys)
    cross = [str(jdir / "report.json"), str(pdir / "report.json")]
    jdiff = _cli_text(jcli.main, ["diff"] + cross, capsys)
    pdiff = _cli_text(pcli.main, ["diff"] + cross, capsys)
    assert jdiff == pdiff
    assert pcli.diff_reports(reports["port_combined"],
                             reports["port_combined"]) == []


def test_cost_analysis_returns_flops_and_restores_the_step(reports):
    step = reports["step"]
    ca = step.cost_analysis()
    assert set(ca) >= {"flops", "bytes accessed"}
    assert ca["flops"] == float(_exact_conv_dot_flops(True))
    with mx.cpu():
        net = _layers(gluon.nn)
        net.initialize(device="cpu")
        tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
        fresh = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                   tr)
        assert fresh.cost_analysis() is None
        x, y = _data()
        fresh(torch.from_numpy(x), torch.from_numpy(y))
        before = {n: p.data()._data.clone()
                  for n, p in net.collect_params().items()}
        walked = fresh.cost_analysis()
        after = {n: p.data()._data for n, p in net.collect_params().items()}
    assert walked["flops"] == ca["flops"]
    for n in before:
        assert torch.equal(before[n], after[n]), n


def test_plain_kernels_are_charged_once_as_their_kernel():
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.kernels.fused_bn_relu import fused_bn_relu
    from mxnet_tpu_torch.profiling import aten
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 5, 5, 16))
                         .astype(np.float32)).requires_grad_()
    c = 16
    args = (torch.ones(c, requires_grad=True),
            torch.zeros(c, requires_grad=True), torch.zeros(c),
            torch.ones(c))
    with aten.Walk() as walk:
        out, _m, _v = fused_bn_relu(x, *args, fix_gamma=False,
                                    training=True)
        out.sum().backward()
    kernels = walk.kernels()
    rows = 4 * 5 * 5
    assert kernels["bn_relu_apply"]["calls"] == 1
    assert kernels["bn_relu_apply"]["launches"] == 0
    assert (kernels["bn_relu_apply"]["flops"],
            kernels["bn_relu_apply"]["bytes"]) == \
        (3 * rows * c, 2 * rows * c * 4 + 8 * c)
    assert (kernels["bn_relu_bwd"]["flops"],
            kernels["bn_relu_bwd"]["bytes"]) == \
        (8 * rows * c, 4 * rows * c * 4 + 20 * c)
    # the plain versions' aten ops are not charged: the clamp of the
    # forward and the where of the backward are only in the kernels
    assert walk.categories["elementwise_fusion"]["flops"] == \
        (3 + 8) * rows * c
    for name in registry.list_kernels():
        spec = registry.get(name)
        assert callable(spec.cost) and spec.category in profiling.CATEGORIES
    with pytest.raises(mx.MXNetError, match="cost"):
        registry.count_launch("bn_relu_apply")


def test_timeline_and_save_reports(tmp_path):
    from mxnet_tpu_torch.profiling import timeline
    profiling.reset()
    profiling.enable()
    try:
        with mx.cpu():
            net = _layers(gluon.nn)
            net.initialize(device="cpu")
            tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
            step = parallel.TrainStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
            x, y = _data()
            for _ in range(2):
                step(torch.from_numpy(x), torch.from_numpy(y))
        names = {e["name"] for e in timeline.events()}
        assert "train_step:HybridSequential" in names
        path = profiling.save_reports(str(tmp_path))
        assert os.path.basename(path) == "report.json"
        comb = json.loads(open(path).read())
        assert comb["steps"]["train_step:HybridSequential"]["count"] == 2
        assert profiling.flops_per_step() == \
            float(_exact_conv_dot_flops(True))
        trace = timeline.export_chrome_trace(str(tmp_path / "t.json"))
        assert trace["otherData"]["producer"] == \
            "mxnet_tpu_torch.profiling.timeline"
    finally:
        profiling.disable()
        profiling.reset()
