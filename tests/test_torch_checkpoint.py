"""The port's checkpoints on the CPU: ``Block.save_parameters`` /
``load_parameters``, ``Trainer.save_states`` / ``load_states`` and
``mxnet_tpu_torch.checkpoint.CheckpointManager``.

Against the JAX package: files, ``.states`` blobs and managed steps
written by either package restore in the other, bit for bit; a trainer
resumed in the port from the JAX package's second step takes the same
third step (SGD with momentum through ``Trainer.step`` and the bucketed
LARS ``TrainStep``).  Then the cases of ``tests/test_checkpoint.py``
that need neither sharding, preemption, telemetry nor the kvstore and
``model.py`` paths, held against the port.

Tolerances of the resumed third step: SGD 5e-4 relative / 5e-5
absolute, the bound of ``test_torch_gluon.py``'s Trainer trajectory
test; LARS 2e-5 / 2e-6, as ``test_torch_lars.py`` holds weights and
momenta.  Everything a checkpoint moves (parameters, running
statistics, optimizer states) is compared exactly."""
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.checkpoint import CheckpointManager as JCheckpointManager
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.parallel import TrainStep as JTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.checkpoint import CheckpointError, CheckpointManager
from mxnet_tpu_torch.checkpoint import async_writer, core as ckpt_core
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import TrainStep

from conftest import paired_params

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
SGD = {"learning_rate": 0.1, "momentum": 0.9}
LARS = {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.01}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture()
def kernels_on(monkeypatch):
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    with jax.default_matmul_precision("highest"):
        yield


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _net_and_trainer():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(device="cpu")
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
    return net, tr


def _train(net, tr, x, y, steps, loss_fn=None):
    loss_fn = loss_fn or gluon.loss.L2Loss()
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        tr.step(x.shape[0])


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (mx.nd.array(rng.randn(4, 6).astype(np.float32)),
            mx.nd.array(rng.randn(4, 4).astype(np.float32)))


def _dead_pid():
    """A pid guaranteed dead: a subprocess that already exited."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def _values(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _site_net(pkg, classes=4):
    """A channels-last conv, a fused BatchNorm+relu site, a dense head."""
    net = pkg.nn.HybridSequential(prefix="site_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
                pkg.nn.BatchNorm(axis=3), pkg.nn.Activation("relu"),
                pkg.nn.Flatten(), pkg.nn.Dense(classes))
    return net


def _site_batch(seed=0, classes=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(4, 6, 6, 3).astype(np.float32),
            rng.randint(0, classes, 4).astype(np.float32))


def _jax_states(jtr):
    return {i: s.asnumpy() for i, s in jtr._updater.states.items()}


# ----------------------------------------------------------------------
# Parameter.data() / grad() are NDArrays over the parameter's tensors
# ----------------------------------------------------------------------

def test_parameter_data_and_grad_match_the_jax_package():
    """After ``initialize`` (weights carried across) and after one
    ``Trainer.step``, ``p.data().asnumpy()`` and ``p.grad().asnumpy()``
    agree with the JAX package's; ``data()`` shares the tensor."""
    x, y = _data()
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.array(x.asnumpy()))
    net, tr = _net_and_trainer()
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    params_from_numpy(net, {k: p.data().asnumpy() for k, p in
                            jnet._collect_params_with_prefix().items()})
    for jp, p in paired_params(jnet, net):
        assert isinstance(p.data(), mx.NDArray)
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      jp.data().asnumpy())
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD, kvstore=None)
    with jautograd.record():
        jl = jgluon.loss.L2Loss()(jnet(jmx.nd.array(x.asnumpy())),
                                  jmx.nd.array(y.asnumpy())).mean()
    jl.backward()
    with autograd.record():
        tl = gluon.loss.L2Loss()(net(x), y).mean()
    tl.backward()
    for jp, p in paired_params(jnet, net):
        assert isinstance(p.grad(), mx.NDArray)
        np.testing.assert_allclose(p.grad().asnumpy(), jp.grad().asnumpy(),
                                   rtol=1e-5, atol=1e-7)
    jtr.step(4)
    tr.step(4)
    for jp, p in paired_params(jnet, net):
        np.testing.assert_allclose(p.data().asnumpy(), jp.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    w = net[0].weight
    assert w.data()._data is w._data
    w.data()[:] = 0
    assert not w._data.detach().any()


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_parameters_across_packages(tmp_path, writer):
    """A narrow NHWC ResNet's ``save_parameters`` file from one package
    loads into a fresh (deferred) net of the other, every parameter and
    running statistic bit for bit."""
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    path = str(tmp_path / "net.params")
    np.random.seed(0)
    jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
    jnet.initialize(ctx=jmx.cpu())
    net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(1))
    if writer == "jax":
        jnet(jmx.nd.array(x))
        jnet.save_parameters(path)
        net.load_parameters(path)
        want, got = _values(jnet), _values(net)
    else:
        net(mx.nd.array(x))
        net.save_parameters(path)
        jnet.load_parameters(path, ctx=jmx.cpu())
        want, got = _values(net), _values(jnet)
    assert sorted(got) == sorted(want) and len(got) == 91
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_parameters_missing_and_extra(tmp_path):
    net, _tr = _net_and_trainer()
    x, _y = _data()
    net(x)
    full = str(tmp_path / "full.params")
    net.save_parameters(full)
    values = _values(net)
    partial = str(tmp_path / "partial.params")
    mx.nd.save(partial, {k: v for k, v in values.items()
                         if k != "1.bias"})
    extra = str(tmp_path / "extra.params")
    mx.nd.save(extra, dict(values, stray=np.zeros(2, np.float32)))
    fresh, _ = _net_and_trainer()
    with pytest.raises(MXNetError, match="missing from file"):
        fresh.load_parameters(partial)
    fresh.load_parameters(partial, allow_missing=True)
    with pytest.raises(MXNetError, match="not found in Block"):
        fresh.load_parameters(extra)
    fresh.load_parameters(extra, ignore_extra=True)
    for k, v in _values(fresh).items():
        np.testing.assert_array_equal(v, values[k], err_msg=k)
    # full prefixed names (collect_params().save) load too, through
    # load_parameters and through ParameterDict.load
    prefixed = str(tmp_path / "prefixed.params")
    net.collect_params().save(prefixed)
    for load in (net.load_parameters, net.collect_params().load):
        for p in net.collect_params().values():
            p.set_data(np.zeros(p.shape, np.float32))
        load(prefixed)
        for k, v in _values(net).items():
            np.testing.assert_array_equal(v, values[k], err_msg=k)


def test_sgd_trainer_states_resume_across_packages(tmp_path, kernels_on):
    """The JAX package trains two SGD-momentum ``Trainer.step``s on a
    net with a fused BatchNorm+relu site and saves parameters and
    ``save_states``; the port loads both and takes the third step."""
    x, y = _site_batch()
    np.random.seed(0)
    jnet = _site_net(jgluon)
    jnet.initialize(ctx=jmx.cpu())
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD, kvstore=None)
    jlf = jgluon.loss.SoftmaxCrossEntropyLoss()

    def jstep():
        with jautograd.record():
            jl = jlf(jnet(jmx.nd.array(x)), jmx.nd.array(y)).mean()
        jl.backward()
        jtr.step(4)

    for _ in range(2):
        jstep()
    ppath, spath = str(tmp_path / "p.params"), str(tmp_path / "t.states")
    jnet.save_parameters(ppath)
    jtr.save_states(spath)
    saved_states = _jax_states(jtr)
    jstep()

    tnet = _site_net(gluon)
    tnet.initialize(device="cpu")
    tnet.load_parameters(ppath)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", SGD)
    ttr.load_states(spath)
    assert sorted(ttr._updater.states) == sorted(saved_states)
    for i, s in saved_states.items():
        np.testing.assert_array_equal(ttr._updater.states[i].numpy(), s)
    with autograd.record():
        tl = gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(mx.nd.array(x)), mx.nd.array(y)).mean()
    tl.backward()
    ttr.step(4)
    for jp, tp in paired_params(jnet, tnet):
        np.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=tp.name)


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    assert a.dtype.name == "bfloat16", a.dtype
    return np.asarray(a).view(np.uint16)


def _bf16_dense(pkg, init):
    net = pkg.nn.HybridSequential(prefix="b16_")
    with net.name_scope():
        net.add(pkg.nn.Dense(8, activation="relu"), pkg.nn.Dense(4))
    init(net)
    for p in net.collect_params().values():
        p.cast("bfloat16")
    return net


@pytest.mark.parametrize("writer", ["port", "jax", "port-no-ml_dtypes"])
def test_bf16_sgd_states_round_trip_across_packages(tmp_path, monkeypatch,
                                                     writer):
    """A bf16-cast net's SGD-momentum states are bf16; a ``.states`` blob
    of either package restores them in the other (and in the port)
    as bf16, bit for bit.  Without ml_dtypes the port stores them as
    float32 and restores them at the parameter's dtype."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randn(4, 4).astype(np.float32)
    spath = str(tmp_path / "t.states")
    if writer == "jax":
        np.random.seed(0)
        net = _bf16_dense(jgluon, lambda n: n.initialize(ctx=jmx.cpu()))
        tr = jgluon.Trainer(net.collect_params(), "sgd", SGD, kvstore=None)
        with jautograd.record():
            loss = jgluon.loss.L2Loss()(
                net(jmx.nd.array(x).astype("bfloat16")),
                jmx.nd.array(y).astype("bfloat16")).mean()
        loss.backward()
        tr.step(4)
        want = {i: _bf16_bits(s.asnumpy())
                for i, s in tr._updater.states.items()}
    else:
        if writer == "port-no-ml_dtypes":
            monkeypatch.setitem(sys.modules, "ml_dtypes", None)
        net = _bf16_dense(gluon, lambda n: n.initialize(device="cpu"))
        tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
        with autograd.record():
            loss = gluon.loss.L2Loss()(
                net(mx.nd.array(x).astype("bfloat16")),
                mx.nd.array(y).astype("bfloat16")).mean()
        loss.backward()
        tr.step(4)
        want = {i: _bf16_bits(s) for i, s in tr._updater.states.items()}
    assert want and all(np.abs(w).max() > 0 for w in want.values())
    tr.save_states(spath)

    tnet = _bf16_dense(gluon, lambda n: n.initialize(device="cpu"))
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", SGD)
    ttr.load_states(spath)
    assert sorted(ttr._updater.states) == sorted(want)
    for i, s in ttr._updater.states.items():
        assert s.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(s), want[i])
    if writer == "port":
        jnet = _bf16_dense(jgluon, lambda n: n.initialize(ctx=jmx.cpu()))
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD,
                             kvstore=None)
        jtr.load_states(spath)
        assert sorted(jtr._updater.states) == sorted(want)
        for i, s in jtr._updater.states.items():
            np.testing.assert_array_equal(_bf16_bits(s.asnumpy()), want[i])


def test_lars_train_step_resumes_across_packages(tmp_path, kernels_on):
    """The same with the bucketed LARS ``TrainStep`` on both sides: two
    JAX steps, the states blob and parameters saved, the third step in
    the port from them."""
    x, y = _site_batch(1, classes=10)
    np.random.seed(1)
    jnet = _site_net(jgluon, classes=10)
    jnet.initialize(ctx=jmx.cpu())
    jtr = jgluon.Trainer(jnet.collect_params(), "lars", LARS, kvstore=None)
    jstep = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), jtr,
                       mesh=None)
    for _ in range(2):
        jstep(jmx.nd.array(x), jmx.nd.array(y))
    ppath, spath = str(tmp_path / "p.params"), str(tmp_path / "t.states")
    jnet.save_parameters(ppath)
    jtr.save_states(spath)
    saved_states = _jax_states(jtr)
    jstep(jmx.nd.array(x), jmx.nd.array(y))

    tnet = _site_net(gluon, classes=10)
    tnet.initialize(device="cpu")
    tnet.load_parameters(ppath)
    ttr = gluon.Trainer(tnet.collect_params(), "lars", LARS)
    ttr.load_states(spath)
    for i, s in saved_states.items():
        np.testing.assert_array_equal(ttr._updater.states[i].numpy(), s)
    TrainStep(tnet, gluon.loss.SoftmaxCrossEntropyLoss(), ttr)(x, y)
    for jp, tp in paired_params(jnet, tnet):
        np.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=tp.name)
    for i, s in _jax_states(jtr).items():
        np.testing.assert_allclose(ttr._updater.states[i].numpy(), s,
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manager_steps_restore_across_packages(tmp_path, writer):
    """A ``CheckpointManager.save_training`` step of one package passes
    the other's manifest and CRC check and restores parameters and
    optimizer state bit for bit."""
    x, y = _data()
    root = str(tmp_path / "ck")
    np.random.seed(0)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    jnet.initialize(ctx=jmx.cpu())
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD, kvstore=None)
    net, tr = _net_and_trainer()
    if writer == "jax":
        jx, jy = jmx.nd.array(x.asnumpy()), jmx.nd.array(y.asnumpy())
        for _ in range(2):
            with jautograd.record():
                jl = jgluon.loss.L2Loss()(jnet(jx), jy).mean()
            jl.backward()
            jtr.step(4)
        JCheckpointManager(root).save_training(2, jnet, jtr,
                                               metadata={"by": "jax"})
        ckpt = CheckpointManager(root).restore_training(net, tr)
        src, dst, src_tr, dst_tr = jnet, net, jtr, tr
    else:
        _train(net, tr, x, y, 2)
        CheckpointManager(root).save_training(2, net, tr,
                                              metadata={"by": "port"})
        ckpt = JCheckpointManager(root).restore_training(jnet, jtr)
        src, dst, src_tr, dst_tr = net, jnet, tr, jtr
    assert ckpt.step == 2 and ckpt.metadata == {"by": writer}
    for a, b in paired_params(src, dst):
        np.testing.assert_array_equal(b.data().asnumpy(),
                                      a.data().asnumpy())
    states = {i: np.asarray(s.asnumpy() if hasattr(s, "asnumpy") else s)
              for i, s in src_tr._updater.states.items()}
    assert sorted(dst_tr._updater.states) == sorted(states)
    for i, s in dst_tr._updater.states.items():
        got = s.asnumpy() if hasattr(s, "asnumpy") else s.numpy()
        np.testing.assert_array_equal(got, states[i])


# ----------------------------------------------------------------------
# manager round trip
# ----------------------------------------------------------------------

def test_manager_round_trip_bit_identical(tmp_path):
    x, y = _data()
    net, tr = _net_and_trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _train(net, tr, x, y, 5)
    mgr.save_training(5, net, tr, metadata={"epoch": 1})

    net2, tr2 = _net_and_trainer()
    net2(x)  # materialize params
    ckpt = CheckpointManager(str(tmp_path / "ck")).restore_training(net2,
                                                                    tr2)
    assert ckpt.step == 5
    assert ckpt.metadata == {"epoch": 1}
    for p1, p2 in paired_params(net, net2):
        np.testing.assert_array_equal(p1.data().asnumpy(),
                                      p2.data().asnumpy())
    # optimizer state (momentum) bit-identical => identical continuation
    _train(net, tr, x, y, 1)
    _train(net2, tr2, x, y, 1)
    for p1, p2 in paired_params(net, net2):
        np.testing.assert_array_equal(p1.data().asnumpy(),
                                      p2.data().asnumpy())


@pytest.mark.parametrize("materialized", [True, False])
def test_restore_keeps_tensor_identity(tmp_path, materialized):
    """A gradient-taking parameter keeps its tensor across a restore
    (the value is copied in), so the step after ``restore_training``
    updates the tensor the net computes with and moves its outputs; a
    deferred net takes the saved shapes."""
    x, y = _data()
    net, tr = _net_and_trainer()
    _train(net, tr, x, y, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save_training(2, net, tr)
    net2, tr2 = _net_and_trainer()
    if materialized:
        net2(x)
    before = {k: p._data for k, p in
              net2._collect_params_with_prefix().items()}
    mgr.restore_training(net2, tr2)
    for k, p in net2._collect_params_with_prefix().items():
        if materialized:
            assert p._data is before[k], k
        assert isinstance(p._data, torch.nn.Parameter), k
    out0 = net2(x).asnumpy()
    np.testing.assert_array_equal(out0, net(x).asnumpy())
    _train(net2, tr2, x, y, 1)
    assert not np.allclose(net2(x).asnumpy(), out0)
    _train(net, tr, x, y, 1)
    np.testing.assert_array_equal(net2(x).asnumpy(), net(x).asnumpy())


def test_restore_fresh_start_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore() is None
    assert mgr.latest_step() is None
    net, tr = _net_and_trainer()
    assert mgr.restore_training(net, tr) is None


def test_generic_items_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = torch.arange(4, dtype=torch.float32).to(torch.bfloat16)
    mgr.save(7, {"params": {"w": mx.nd.array(w), "b": b},
                 "blob": b"\x00state"}, metadata={"note": "x"})
    ckpt = mgr.restore()
    assert ckpt.step == 7
    np.testing.assert_array_equal(ckpt.items["params"]["w"].asnumpy(), w)
    assert torch.equal(ckpt.items["params"]["b"]._data, b)
    assert ckpt.items["params"]["w"].context == mx.cpu()
    assert ckpt.items["blob"] == b"\x00state"
    assert ckpt.metadata == {"note": "x"}


def test_restore_of_an_unknown_parameter_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"params": {"nope.weight": np.zeros(2, np.float32)}})
    net, _tr = _net_and_trainer()
    with pytest.raises(CheckpointError, match="not found in block"):
        mgr.restore_training(net)


# ----------------------------------------------------------------------
# corruption fallback
# ----------------------------------------------------------------------

def _two_step_manager(tmp_path):
    x, y = _data()
    net, tr = _net_and_trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _train(net, tr, x, y, 1)
    mgr.save_training(1, net, tr)
    _train(net, tr, x, y, 1)
    mgr.save_training(2, net, tr)
    return mgr, net, tr, x, y


def _truncate(mgr):
    with open(os.path.join(mgr.step_dir(2), "params.params"), "r+b") as f:
        f.truncate(10)


def _drop_manifest(mgr):
    os.remove(os.path.join(mgr.step_dir(2), ckpt_core.MANIFEST_NAME))


def _flip_a_bit(mgr):
    fpath = os.path.join(mgr.step_dir(2), "trainer.bin")
    with open(fpath, "r+b") as f:
        f.seek(max(0, os.path.getsize(fpath) // 2))
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("damage,match", [
    (_truncate, "size mismatch"), (_drop_manifest, "no manifest"),
    (_flip_a_bit, "crc32 mismatch")], ids=["truncated", "no-manifest",
                                           "bitflip"])
def test_damaged_step_falls_back_to_previous(tmp_path, damage, match):
    mgr, net, tr, x, y = _two_step_manager(tmp_path)
    damage(mgr)
    with pytest.warns(RuntimeWarning, match=match):
        assert mgr.latest_step() == 1
    assert os.path.isdir(mgr.step_dir(2) + ".corrupt")    # quarantined
    net2, tr2 = _net_and_trainer()
    net2(x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert mgr.restore_training(net2, tr2).step == 1


def test_explicit_restore_of_corrupt_step_raises(tmp_path):
    mgr, *_ = _two_step_manager(tmp_path)
    os.remove(os.path.join(mgr.step_dir(2), "params.params"))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(CheckpointError):
            mgr.restore(step=2)
    assert mgr.restore(step=1).step == 1


def test_all_steps_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (3, 1, 7):
        mgr.save(s, {"blob": b"x"})
    assert mgr.all_steps() == [1, 3, 7]
    assert mgr.latest_step() == 7


# ----------------------------------------------------------------------
# retention
# ----------------------------------------------------------------------

def test_retention_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in range(1, 6):
        mgr.save(s, {"blob": b"s%d" % s})
    assert mgr.all_steps() == [4, 5]


def test_retention_keep_every_n_interaction(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                            keep_every_n_steps=5)
    for s in range(1, 13):
        mgr.save(s, {"blob": b"s%d" % s})
    assert mgr.all_steps() == [5, 10, 11, 12]


def test_retention_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_MAX_TO_KEEP", "1")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.max_to_keep == 1
    for s in (1, 2, 3):
        mgr.save(s, {"blob": b"x"})
    assert mgr.all_steps() == [3]


# ----------------------------------------------------------------------
# stale-temp sweep and atomic commits
# ----------------------------------------------------------------------

def test_sweep_stale_tmps_at_manager_init(tmp_path):
    root = tmp_path / "ck"
    root.mkdir()
    dead = _dead_pid()
    stale = root / ("step_00000001.%d.tmp" % dead)
    stale.mkdir()               # a stranded staging DIR
    (stale / "params.params").write_bytes(b"torn")
    live = root / ("step_00000002.%d.tmp" % os.getpid())
    live.mkdir()                # our own in-flight write: must survive
    CheckpointManager(str(root))
    assert not stale.exists()
    assert live.exists()


def test_commit_sweeps_sibling_stale_tmps(tmp_path):
    dead = _dead_pid()
    target = tmp_path / "state.bin"
    stale = tmp_path / ("state.bin.%d.tmp" % dead)
    stale.write_bytes(b"half-written")
    ckpt_core.atomic_write_bytes(str(target), b"good")
    assert target.read_bytes() == b"good"
    assert not stale.exists()


def test_commit_failure_leaves_no_tmp_and_old_file(tmp_path):
    target = tmp_path / "state.bin"
    target.write_bytes(b"old")

    def boom(tmp):
        with open(tmp, "wb") as f:
            f.write(b"partial")
        raise RuntimeError("writer died")

    with pytest.raises(RuntimeError):
        ckpt_core.commit(str(target), boom)
    assert target.read_bytes() == b"old"
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_trainer_save_states_atomic_on_failure(tmp_path):
    x, y = _data()
    net, tr = _net_and_trainer()
    _train(net, tr, x, y, 1)
    fname = str(tmp_path / "t.states")
    tr.save_states(fname)
    good = open(fname, "rb").read()
    assert good

    orig = tr._updater.get_states
    tr._updater.get_states = lambda **kw: (_ for _ in ()).throw(
        RuntimeError("serializer died"))
    with pytest.raises(RuntimeError):
        tr.save_states(fname)
    tr._updater.get_states = orig
    assert open(fname, "rb").read() == good
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    tr.load_states(fname)


# ----------------------------------------------------------------------
# async writer
# ----------------------------------------------------------------------

@pytest.fixture
def write_gate():
    gate = threading.Event()
    async_writer._TEST_WRITE_GATE = gate
    yield gate
    gate.set()
    async_writer._TEST_WRITE_GATE = None


def test_async_save_overlaps_training(tmp_path, write_gate):
    x, y = _data()
    net, tr = _net_and_trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    net(x)
    mgr.save_training(1, net, tr)
    assert mgr.all_steps() == []          # the writer waits on the gate
    assert mgr._writer.in_flight
    _train(net, tr, x, y, 2)              # the loop advances regardless
    assert mgr.all_steps() == []
    write_gate.set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]
    assert mgr.restore().step == 1


def test_async_snapshot_is_immutable_to_later_steps(tmp_path,
                                                    write_gate):
    """The port updates weights and momenta in place: the snapshot taken
    at ``save`` must be a copy, or the async save writes later steps'
    values."""
    x, y = _data()
    net, tr = _net_and_trainer()
    _train(net, tr, x, y, 1)
    before = {k: p._reduce().asnumpy() for k, p in
              net._collect_params_with_prefix().items()}
    states = tr.get_states()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save_training(1, net, tr)
    _train(net, tr, x, y, 3)      # mutate params while save in flight
    write_gate.set()
    mgr.wait_until_finished()
    ckpt = mgr.restore()
    for k, v in before.items():
        np.testing.assert_array_equal(ckpt.items["params"][k].asnumpy(),
                                      v)
    assert ckpt.items["trainer"] == states


def test_async_at_most_one_in_flight(tmp_path, write_gate):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(1, {"blob": b"one"})
    done = threading.Event()

    def second_save():
        mgr.save(2, {"blob": b"two"})   # must drain save 1 first
        done.set()

    t = threading.Thread(target=second_save, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()            # blocked behind save 1
    assert mgr.all_steps() == []
    write_gate.set()
    t.join(timeout=30)
    assert done.is_set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1, 2]


def test_async_error_reraised_at_next_save(tmp_path, monkeypatch):
    monkeypatch.setattr(async_writer, "_RETRIES", 0)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    orig = mgr._write_step

    def boom(*a, **k):
        raise RuntimeError("disk on fire")

    mgr._write_step = boom
    mgr.save(1, {"blob": b"x"})         # fails on the writer thread
    mgr._write_step = orig
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.save(2, {"blob": b"y"})
    mgr.save(2, {"blob": b"y"})         # the error was consumed
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]


def test_async_error_reraised_at_wait(tmp_path, monkeypatch):
    monkeypatch.setattr(async_writer, "_RETRIES", 0)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr._write_step = lambda *a, **k: (_ for _ in ()).throw(
        OSError("enospc"))
    mgr.save(1, {"blob": b"x"})
    with pytest.raises(OSError, match="enospc"):
        mgr.wait_until_finished()


def test_async_transient_failure_is_retried(tmp_path, monkeypatch):
    monkeypatch.setattr(async_writer, "_BACKOFF_S", 0.0)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    orig = mgr._write_step
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("blip")
        return orig(*a, **k)

    mgr._write_step = flaky
    mgr.save(1, {"blob": b"x"})
    mgr.wait_until_finished()
    assert len(calls) == 2 and mgr.all_steps() == [1]


@pytest.mark.parametrize("value,is_async", [("1", True), ("0", False)])
def test_async_env_default(tmp_path, monkeypatch, value, is_async):
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", value)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert (mgr._writer is not None) == is_async
    mgr.save(1, {"blob": b"x"})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]


# ----------------------------------------------------------------------
# misc API
# ----------------------------------------------------------------------

def test_save_rejects_bad_items(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(CheckpointError):
        mgr.save(1, {})
    with pytest.raises(MXNetError):
        mgr.save(1, {"bad": 42})


def test_resave_same_step_overwrites(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"blob": b"first"})
    mgr.save(1, {"blob": b"second"})
    assert mgr.all_steps() == [1]
    assert mgr.restore().items["blob"] == b"second"
