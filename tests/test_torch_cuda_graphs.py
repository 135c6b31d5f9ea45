"""The port's compiled paths on an NVIDIA GPU: a hybridized block, a
``TrainStep``, the serving pool and the decode engine run from captured
CUDA graphs (``mxnet_tpu_torch._capture``), each held against the same
work run eagerly.  Every test here needs the card and skips without one.
The file imports neither JAX nor the JAX package, so on a machine with
a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_graphs.py

TF32 is off in every test (cuDNN would otherwise round convolutions to
TF32), and cuDNN runs its deterministic algorithms: with its default
ones an all-eager ``TrainStep`` and the imperative loop end as far
apart as the captured step does (the order of the weight gradients'
atomics; one run put the narrow ResNet's stem weights 1.5e-3 apart
after three SGD steps), and with them both come out bitwise.
Tolerances: a replayed graph runs the kernels the eager call
runs, on the same inputs, so forwards, gradients and running statistics
match the eager ones to 1e-6 relative to the largest value (cuDNN may
pick another algorithm on another stream); three SGD steps of a narrow
ResNet against the imperative loop 1e-5 (the loss), 1e-4 relative
norm-wise plus 1e-6 absolute (weights and momenta: the difference
compounds over the steps; a convolution bias ahead of a BatchNorm has
an exact gradient of 0, so its update is rounding noise of ~1e-7); decode streams equal token for token (greedy argmax over fp32
logits, teacher-forced: a token may differ only where the oracle's
top-2 logit gap is under 1e-3); four LAMB or LARS steps of a Dense net
captured against four eager ones 1e-6 (the same kernels on the same
inputs; a graph that kept step 2's lr or bias corrections is off by
more than 1e-3 in the last step's update of some tensor, held
norm-wise per tensor to 1e-5); likewise four Adam, AdamW or
per-parameter LAMB steps under a ``PolyScheduler`` in warm-up (lr and
``t`` change at every call), and four multi-precision SGD steps of an
fp16 net.

Every test but the serving hot swap runs under
``_capture.checking_syncs()``: each capture and replay runs under
``torch.cuda.set_sync_debug_mode("error")``.  The hot swap runs as a
server does, without it.
"""
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError, _capture, autograd, gluon
from mxnet_tpu_torch.kernels import registry

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


@pytest.fixture
def cuda(card):
    with _capture.checking_syncs():
        yield card


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _small_net(seed=0, dropout=0.0):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, kernel_size=3), nn.BatchNorm(), nn.Activation(
        "relu"), nn.Flatten(), nn.Dense(16, activation="relu"))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(5))
    net.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    net(torch.zeros(2, 3, 8, 8, device="cuda"))      # sizes the params
    return net


def _copy_weights(src, dst):
    for (_k, a), (_k2, b) in zip(
            sorted(src._collect_params_with_prefix().items()),
            sorted(dst._collect_params_with_prefix().items())):
        b.set_data(a.data()._data.detach().clone())


def _narrow_resnet(seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, thumbnail=True, layout="NHWC")
    net.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    return net


def test_hybridized_forward_replays_match_eager(cuda):
    net, ref = _small_net(), _small_net(seed=1)
    _copy_weights(net, ref)
    net.hybridize()
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = torch.tensor(rng.standard_normal((4, 3, 8, 8)),
                         dtype=torch.float32, device=cuda)
        with autograd.pause():
            got, want = net(x), ref(x)
        assert _rel(got, want) <= 1e-6
    stats = net.cache_stats()
    assert len(stats["keys"]) == 1
    assert stats["graphs"]["cuda:0"]["graphs"] == 1
    assert stats["graphs"]["cuda:0"]["replays"] == 3


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_hybridized_record_matches_eager(cuda, grad_req):
    """Forward, gradients and running statistics under ``record()`` for
    three iterations (the first eager, the second captures, the third
    replays), against the same net un-hybridized."""
    net, ref = _small_net(), _small_net(seed=1)
    _copy_weights(net, ref)
    for n in (net, ref):
        for p in n.collect_params().values():
            if p.grad_req != "null":
                p.grad_req = grad_req
    net.hybridize()
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = torch.tensor(rng.standard_normal((4, 3, 8, 8)),
                         dtype=torch.float32, device=cuda)
        outs = []
        for n in (net, ref):
            with autograd.record():
                out = n(x)
                loss = (out * out).sum()
            loss.backward()
            outs.append(out)
        assert _rel(outs[0], outs[1]) <= 1e-6
        for (k, a), (_k, b) in zip(
                sorted(net._collect_params_with_prefix().items()),
                sorted(ref._collect_params_with_prefix().items())):
            assert _rel(a.data()._data, b.data()._data) <= 1e-6, k
            if a.grad_req != "null":
                assert _rel(a._data.grad, b._data.grad) <= 1e-6, k
    assert net.cache_stats()["graphs"]["cuda:0"]["graphs"] == 2


def _dense_cell(seed=0):
    from mxnet_tpu_torch.gluon import nn
    cell = nn.Dense(8, in_units=8, activation="tanh")
    cell.initialize(device="cuda",
                    generator=torch.Generator().manual_seed(seed))
    return cell


def _shared_twice(net, x, rng):
    """A block applied twice to one shape and once to another under one
    ``record()``."""
    x2 = torch.tensor(rng.standard_normal(tuple(x.shape)),
                      dtype=torch.float32, device=x.device)
    x3 = torch.tensor(rng.standard_normal((6,) + tuple(x.shape[1:])),
                      dtype=torch.float32, device=x.device)
    return (net(x) * net(x2)).sum() + net(x3).sum()


def _cell_loop(cell, x, _rng):
    """A cell applied three times in a loop under one ``record()``."""
    h = x
    for _ in range(3):
        h = cell(h)
    return (h * h).sum()


@pytest.mark.parametrize("make,inputs,loss", [
    (_small_net, (4, 3, 8, 8), _shared_twice),
    (_dense_cell, (4, 8), _cell_loop)], ids=["shared-block", "cell-loop"])
def test_calls_outstanding_under_one_record_match_eager(cuda, make, inputs,
                                                        loss):
    """Several calls of one hybridized block under one ``record()``
    before its backward (a shared block applied twice, two shapes, a
    cell in a loop): each call keeps its own activations, so gradients
    equal the un-hybridized block's in every iteration (the first eager,
    the second captures, the third replays)."""
    net, ref = make(), make(seed=1)
    _copy_weights(net, ref)
    net.hybridize()
    for it in range(3):
        x = torch.tensor(np.random.default_rng(it).standard_normal(inputs),
                         dtype=torch.float32, device=cuda)
        values = []
        for n in (net, ref):
            with autograd.record():
                out = loss(n, x, np.random.default_rng(10 + it))
            out.backward()
            values.append(out.detach())
        assert _rel(values[0], values[1]) <= 1e-6, it
        for (k, a), (_k, b) in zip(
                sorted(net._collect_params_with_prefix().items()),
                sorted(ref._collect_params_with_prefix().items())):
            assert _rel(a.data()._data, b.data()._data) <= 1e-6, (it, k)
            if a.grad_req != "null":
                assert _rel(a._data.grad, b._data.grad) <= 1e-6, (it, k)
    # a forward and a backward graph for each call outstanding at once
    # (two of one shape and one of the other; three calls of the cell)
    assert net.cache_stats()["graphs"]["cuda:0"]["graphs"] == 6


def test_a_retained_backward_after_the_next_call_raises(cuda):
    """A backward kept by ``retain_graph`` that runs again after the
    block's pair replayed for a later call raises; it does not read the
    later call's activations."""
    net = _small_net()
    net.hybridize()
    x = torch.randn(4, 3, 8, 8, device=cuda)
    for _ in range(2):
        with autograd.record():
            out = net(x).sum()
        out.backward(retain_graph=True)
    with autograd.record():
        net(x).sum().backward()
    with pytest.raises(MXNetError, match="retain_graph"):
        out.backward()


def test_dropout_masks_differ_between_replays(cuda):
    net = _small_net(dropout=0.5)
    net.hybridize()
    x = torch.randn(4, 3, 8, 8, device=cuda)
    outs = []
    for _ in range(4):
        with autograd.record():
            outs.append(net(x).detach())
    assert not torch.equal(outs[2], outs[3])


def test_recapture_after_load_parameters(cuda, tmp_path):
    net, other = _small_net(), _small_net(seed=5)
    with autograd.record():          # moves the running statistics
        other(torch.randn(8, 3, 8, 8, device=cuda))
    other.save_parameters(str(tmp_path / "w.params"))
    net.hybridize()
    x = torch.randn(4, 3, 8, 8, device=cuda)
    with autograd.pause():
        net(x)
        net(x)
    net.load_parameters(str(tmp_path / "w.params"))
    with autograd.pause():
        got, want = net(x), other(x)
    assert _rel(got, want) <= 1e-6
    assert net.cache_stats()["graphs"]["cuda:0"]["graphs"] == 2


def _imperative_sgd(net, x, y, steps, lr=0.05, momentum=0.9):
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": lr, "momentum": momentum})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.sum().backward()
        tr.step(x.shape[0])
        losses.append(float(loss.detach().mean()))
    return losses, tr


def test_captured_train_step_matches_the_imperative_loop(cuda):
    """Three ``TrainStep`` calls (eager, captured, replayed) of a narrow
    NHWC ResNet against three steps of record/backward/trainer.step on a
    copy of the net: losses, weights, running statistics and momenta."""
    from mxnet_tpu_torch.parallel import TrainStep
    net, ref = _narrow_resnet(), _narrow_resnet(seed=1)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 32, 32, 3)),
                     dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.integers(0, 10, 4), dtype=torch.float32,
                     device=cuda)
    with autograd.pause():
        net(x[:1])
        ref(x[:1])
    _copy_weights(net, ref)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    losses = [float(step(x, y)) for _ in range(3)]
    want, rtr = _imperative_sgd(ref, x, y, 3)
    assert step.capture_stats()["graphs"] == 1
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for (k, a), (_k, b) in zip(
            sorted(net._collect_params_with_prefix().items()),
            sorted(ref._collect_params_with_prefix().items())):
        d = float((a.data()._data - b.data()._data).norm())
        assert d <= 1e-4 * float(b.data()._data.norm()) + 1e-6, k
    for i, s in tr._updater.states.items():
        w = rtr._updater.states[i]
        assert float((s - w).norm()) <= 1e-4 * float(w.norm()) + 1e-6, i


def test_replays_count_the_launches_captured(cuda):
    from mxnet_tpu_torch.parallel import TrainStep
    net = _narrow_resnet()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x = torch.randn(4, 32, 32, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda).float()
    step(x, y)
    registry.reset_launches()
    step(x, y)                        # captures (no launch), replays once
    graph = next(iter(step._owner._entries.values())).graph
    assert graph.launches[("bn_relu_apply", "float32")] == 8
    for _ in range(4):
        step(x, y)
    assert registry.launches("bn_relu_apply") == 8 * 5
    assert registry.launches("bn_relu_bwd") == 8 * 5
    assert registry.launch_dtypes("bn_relu_apply") == {"float32": 40}


def test_captured_step_takes_a_new_learning_rate(cuda):
    """After ``set_learning_rate`` the replayed step moves the weights
    by the new lr: with lr 0 the weights stay, with lr back they move
    as a fresh eager step would."""
    from mxnet_tpu_torch.parallel import TrainStep
    net = _narrow_resnet()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x = torch.randn(4, 32, 32, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda).float()
    step(x, y)
    step(x, y)
    tr.set_learning_rate(0.0)
    w = net.output.weight.data()._data.clone()
    step(x, y)
    assert torch.equal(net.output.weight.data()._data, w)
    tr.set_learning_rate(0.05)
    step(x, y)
    assert not torch.equal(net.output.weight.data()._data, w)
    assert step.capture_stats()["graphs"] == 1


def _dense_net(seed=0, dropout=0.3):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dropout(dropout),
            nn.Dense(10))
    net.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    net(torch.zeros(2, 20, device="cuda"))      # sizes the params
    return net


@pytest.mark.parametrize("opt,hyper", [
    ("lamb", {"learning_rate": 0.01, "wd": 0.1}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001,
              "wd": 1e-4})])
def test_captured_bucketed_steps_match_eager_steps(cuda, opt, hyper):
    """Four calls of one ``TrainStep`` with LAMB or LARS (eager,
    captured, replayed, replayed after ``set_learning_rate``) against
    four eager steps -- a fresh ``TrainStep`` each time, whose first
    call of a key runs eagerly -- on a copy of the net: losses, weights,
    the last step's update and every optimizer state (LAMB's two
    moments, LARS's momentum).  The bucketed update reads lr, wd, the
    update count ``t`` and LAMB's bias corrections from the device each
    replay; dropout draws the masks the eager steps draw (the port's
    generator reseeded before each run)."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.kernels.registry import launches
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.data_parallel import _tensors
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((8, 20)), dtype=torch.float32,
                     device=cuda)
    y = torch.tensor(rng.integers(0, 10, 8), dtype=torch.float32,
                     device=cuda)
    kernel = "lamb_phase1" if opt == "lamb" else "lars_flat"
    runs = []
    for captured in (True, False):
        net = _dense_net()
        tr = gluon.Trainer(net.collect_params(), opt, dict(hyper))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        mxrandom.seed(11)
        step = TrainStep(net, loss_fn, tr)
        n0 = launches(kernel)
        losses, before = [], None
        for k in range(4):
            if k == 3:
                tr.set_learning_rate(hyper["learning_rate"] / 4)
                before = [p._data.clone()
                          for p in net.collect_params().values()]
            if not captured:
                step = TrainStep(net, loss_fn, tr)
            losses.append(float(step(x, y)))
        assert launches(kernel) - n0 == 4
        runs.append((net, tr, losses, before, step))
    (net, tr, got, w3, step), (ref, rtr, want, r3, _s) = runs
    stats = step.capture_stats()
    assert stats["graphs"] == 1 and stats["replays"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b, a3, b3 in zip(net.collect_params().values(),
                            ref.collect_params().values(), w3, r3):
        assert _rel(a._data, b._data) <= 1e-6, a.name
        du, dv = (a._data - a3).double(), (b._data - b3).double()
        assert float((du - dv).norm()) <= 1e-5 * float(dv.norm()), a.name
    assert sorted(tr._updater.states) == sorted(rtr._updater.states)
    for i, s in tr._updater.states.items():
        for u, v in zip(_tensors(s), _tensors(rtr._updater.states[i])):
            assert _rel(u, v) <= 1e-6, i


def _captured_against_eager(cuda, make_opt, make_net, x, y, loss_fn,
                            kernel=None):
    """Four calls of one ``TrainStep`` (eager, captured, replayed,
    replayed) against four eager steps -- a fresh ``TrainStep`` each
    time -- on a copy of the net, each run with its own optimizer from
    ``make_opt()``: losses 1e-6, weights 1e-6, the last step's update
    per tensor 1e-5 norm-wise, every optimizer state 1e-6."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.data_parallel import _tensors
    runs = []
    for captured in (True, False):
        net = make_net()
        tr = gluon.Trainer(net.collect_params(), make_opt())
        mxrandom.seed(11)
        step = TrainStep(net, loss_fn, tr)
        n0 = registry.launches(kernel) if kernel else 0
        losses, before = [], None
        for k in range(4):
            if k == 3:
                before = [p._data.clone()
                          for p in net.collect_params().values()]
            if not captured:
                step = TrainStep(net, loss_fn, tr)
            losses.append(float(step(x, y)))
        if kernel:
            assert registry.launches(kernel) - n0 > 0
        runs.append((net, tr, losses, before, step))
    (net, tr, got, w3, step), (ref, rtr, want, r3, _s) = runs
    stats = step.capture_stats()
    assert stats["graphs"] == 1 and stats["replays"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b, a3, b3 in zip(net.collect_params().values(),
                            ref.collect_params().values(), w3, r3):
        assert a._data.dtype == b._data.dtype
        du, dv = (a._data - a3).double(), (b._data - b3).double()
        err = float((du - dv).norm()) / float(dv.norm())
        assert err <= 1e-5, "%s: last update %.3g apart" % (a.name, err)
        assert _rel(a._data, b._data) <= 1e-6, a.name
    assert sorted(tr._updater.states) == sorted(rtr._updater.states)
    for i, s in tr._updater.states.items():
        for u, v in zip(_tensors(s), _tensors(rtr._updater.states[i])):
            assert u.dtype == v.dtype
            assert _rel(u, v) <= 1e-6, i
    return tr


def _dense_batch(cuda, dtype=torch.float32):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((8, 20)), dtype=dtype, device=cuda)
    y = torch.tensor(rng.integers(0, 10, 8), dtype=torch.float32,
                     device=cuda)
    return x, y


def _per_parameter_lamb(**kw):
    """A subclass of LAMB: ``bucket_supported`` takes only LARS and LAMB
    themselves, so ``TrainStep`` applies it parameter by parameter."""
    from mxnet_tpu_torch.optimizer import LAMB

    class PerParameterLAMB(LAMB):
        pass

    return PerParameterLAMB(**kw)


def test_captured_per_parameter_lamb_follows_the_update_count(cuda):
    """A per-parameter LAMB reads the update count ``t`` in its bias
    corrections: a captured step must take ``t`` from the device at
    every replay, not the count of the call that captured it (the
    port's TrainStep before its repair baked that count into the graph;
    the last update then strayed by more than 1e-3)."""
    x, y = _dense_batch(cuda)
    _captured_against_eager(
        cuda, lambda: _per_parameter_lamb(learning_rate=0.01, wd=0.1),
        _dense_net, x, y, gluon.loss.SoftmaxCrossEntropyLoss())


@pytest.mark.parametrize("name", ["adam", "adamw", "lamb_per_parameter"])
def test_captured_scheduled_steps_match_eager_steps(cuda, name):
    """Adam, AdamW and a per-parameter LAMB under a ``PolyScheduler``
    in warm-up: the lr and ``t`` change at every call, and both reach
    each replay from the device."""
    from mxnet_tpu_torch import lr_scheduler, optimizer

    def make_opt():
        sched = lr_scheduler.PolyScheduler(max_update=100, base_lr=1e-2,
                                           pwr=1, warmup_steps=4)
        kw = {"learning_rate": 1e-2, "wd": 0.05, "lr_scheduler": sched}
        if name == "lamb_per_parameter":
            return _per_parameter_lamb(**kw)
        return optimizer.create(name, **kw)

    x, y = _dense_batch(cuda)
    tr = _captured_against_eager(cuda, make_opt, _dense_net, x, y,
                                 gluon.loss.SoftmaxCrossEntropyLoss())
    assert tr.optimizer.num_update == 4
    assert tr.learning_rate == pytest.approx(1e-2)


def test_captured_multi_precision_fp16_step_matches_eager(cuda):
    """``net.cast("float16")`` and SGD with ``multi_precision``: the
    captured step updates the fp32 master copies and writes each fp16
    weight as its cast, in place, as the eager steps do."""
    def make_net():
        net = _dense_net(dropout=0.0)
        net.cast("float16")
        return net

    x, y = _dense_batch(cuda, torch.float16)
    tr = _captured_against_eager(
        cuda, lambda: __import__("mxnet_tpu_torch").optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, multi_precision=True),
        make_net, x, y, gluon.loss.SoftmaxCrossEntropyLoss())
    for i, (mom, w32) in tr._updater.states.items():
        assert mom.dtype == w32.dtype == torch.float32
        assert torch.equal(tr._params[i].data()._data, w32.half())


def test_sentinel_names_the_offender_of_a_captured_step(cuda):
    """With the numerics sentinel armed, a replayed step on a poisoned
    batch raises ``NonFiniteError`` naming the first parameter, the
    weights bitwise at their pre-step values."""
    from mxnet_tpu_torch.analysis import numerics
    from mxnet_tpu_torch.parallel import TrainStep
    net = _dense_net(dropout=0.0)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x, y = _dense_batch(cuda)
    prev = numerics._set_check(True)
    try:
        step(x, y)
        step(x, y)                      # captured
        before = [p._data.clone() for p in net.collect_params().values()]
        bad = x.clone()
        bad[2, 1] = float("nan")
        with pytest.raises(numerics.NonFiniteError) as err:
            step(bad, y)
    finally:
        numerics._set_check(prev)
    first = next(iter(net.collect_params().values()))
    assert err.value.param == first.name and err.value.kind == "nan"
    assert err.value.step == 3
    for p, w in zip(net.collect_params().values(), before):
        assert torch.equal(p._data, w), p.name
    assert step.capture_stats()["graphs"] == 1


def test_replays_make_no_host_read(cuda):
    """Steps on device inputs under ``set_sync_debug_mode("error")``:
    the per-step scalars come from a pinned buffer and the replay reads
    nothing on the host."""
    from mxnet_tpu_torch.parallel import TrainStep
    net = _narrow_resnet()
    tr = gluon.Trainer(net.collect_params(), "lars",
                       {"learning_rate": 0.1, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x = torch.randn(4, 32, 32, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda).float()
    step(x, y)
    step(x, y)
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(x, y) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(torch.stack(losses)).all()


def test_a_host_read_inside_a_capture_raises(cuda):
    from mxnet_tpu_torch import _capture
    owner = _capture.GraphOwner("probe", cuda)
    x = torch.ones(4, device=cuda)
    owner.warm(lambda: x * 2)
    with pytest.raises(MXNetError, match="capture of probe body failed"):
        owner.capture(lambda: float(x.sum()), "probe body")
    assert float((x * 2).sum()) == 8.0      # the device still works


def test_pool_outputs_survive_the_next_call(cuda):
    from mxnet_tpu_torch.serving.executor import BucketExecutorPool
    net = _small_net()
    pool = BucketExecutorPool(lambda t: (net(t),), (3, 8, 8), "float32",
                              (2, 4), cuda)
    pool.warmup()
    assert pool.capture_stats()["graphs"] == 2
    a = np.random.default_rng(0).standard_normal((4, 3, 8, 8))
    b = np.random.default_rng(1).standard_normal((4, 3, 8, 8))
    first = pool.call(4, a.astype(np.float32))[0]
    kept = first.clone()
    second = pool.call(4, b.astype(np.float32))[0]
    assert torch.equal(first, kept) and not torch.equal(first, second)
    with autograd.predict_mode():
        want = net(torch.tensor(a, dtype=torch.float32, device=cuda))
    assert _rel(first, want) <= 1e-6


def test_captured_decode_streams_equal_eager(cuda):
    from mxnet_tpu_torch.serving.decode import DecodeEngine, tiny_gpt
    model = tiny_gpt(vocab_size=97, units=64, num_layers=2, num_heads=4,
                     max_seq=64)
    params = model.init_params(seed=0, device=cuda)
    eng = DecodeEngine(model, params, prefill_buckets=(8, 16),
                       decode_buckets=(1, 2, 4), block_size=4,
                       num_blocks=64, device=cuda)
    eng.warmup()
    assert eng.capture_stats()["graphs"] == 5
    eng.start()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).tolist() for n in (3, 9, 5)]
    registry.reset_launches()
    steps0 = eng.decode_steps
    streams = [eng.submit(p, 10) for p in prompts]
    got = [s.tokens() for s in streams]
    eng.close()
    assert registry.launches("paged_attention") == 2 * (
        eng.decode_steps - steps0)
    for p, toks in zip(prompts, got):
        # teacher-forced on the engine's own tokens: each must be the
        # oracle's argmax unless the oracle's top-2 gap is under 1e-3
        seq = torch.tensor([p + toks[:-1]], device=cuda)
        logits = model.full_logits(params, seq)[0, len(p) - 1:]
        for i, tok in enumerate(toks):
            best = int(logits[i].argmax())
            assert tok == best or float(
                logits[i, best] - logits[i, tok]) < 1e-3, (p, i)


def test_registering_while_another_servable_serves(card):
    """A servable re-registered, and another one registered, while the
    first serves requests and a generative servable decodes: the
    captures of the new servables' buckets run beside the old ones'
    replays and host reads, and every request gets its answer."""
    from mxnet_tpu_torch.serving.decode import tiny_gpt
    from mxnet_tpu_torch.serving.registry import ModelRegistry
    reg = ModelRegistry()
    kw = dict(input_shape=(3, 8, 8), buckets=(1, 2, 4), max_wait_ms=1)
    reg.register("net", block=_small_net(), **kw)
    model = tiny_gpt(vocab_size=97, units=64, num_layers=2, num_heads=4,
                     max_seq=64)
    reg.register_generative("gpt", model,
                            params=model.init_params(seed=0, device=card),
                            prefill_buckets=(8,), decode_buckets=(1, 2),
                            block_size=4, num_blocks=64, device=card)
    stop, errors, served = threading.Event(), [], [0, 0]

    def client(k):
        rng = np.random.default_rng(k)
        while not stop.is_set():
            try:
                out = reg.infer("net", rng.standard_normal(
                    (3, 8, 8)).astype(np.float32), timeout=60)
                assert out.shape == (5,) and np.isfinite(out).all()
                served[0] += 1
            except Exception as e:      # noqa: BLE001 -- reported below
                errors.append(e)

    def decoder():
        while not stop.is_set():
            try:
                toks = reg.generate("gpt", [1, 2, 3], 8).tokens()
                assert len(toks) == 8
                served[1] += 1
            except Exception as e:      # noqa: BLE001 -- reported below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(4)] + [threading.Thread(target=decoder)]
    for t in threads:
        t.start()
    try:
        for seed in (1, 2):
            reg.register("net", block=_small_net(seed=seed), **kw)
        reg.register("other", block=_small_net(seed=3), **kw)
    finally:
        stop.set()
        for t in threads:
            t.join()
        reg.shutdown()
    assert not errors, errors[:3]
    assert served[0] > 0 and served[1] > 0
