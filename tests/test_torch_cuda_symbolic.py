"""The symbolic front end and the recurrent nets on an NVIDIA GPU: the
fused ``RNN`` op (cuDNN's RNN, one direction of one layer a call) eager
and captured against its CPU computation, and a ``BucketingModule``
replaying one train graph a bucket over one shared parameter set.
Every test here needs the card and skips without one.  The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX
it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_symbolic.py

TF32 is off (cuDNN's fp32 RNN would otherwise multiply in TF32) and
every capture and replay runs under ``_capture.checking_syncs()``.
Tolerances: the card against the CPU 5e-5 relative to the largest value
for outputs and states and 1e-4 for gradients (fp32 sums over the time
steps in another order: a two-layer bidirectional tanh RNN read 1.65e-5
on an H100, the other cases less); a replay against the eager call on
the card 1e-6 (the same kernels on the same inputs).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, amp, autograd, gluon, ops, sym
from mxnet_tpu_torch.ops.nn import RNN, rnn_param_size

import chip_smoke

pytestmark = pytest.mark.gpu

MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with _capture.checking_syncs():
        yield torch.device("cuda")


def rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def rnn_inputs(mode, layers, bidirectional, T=7, N=3, I=5, H=6, seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    ps = rnn_param_size(mode, I, H, layers, bidirectional)
    return [torch.tensor(a) for a in (
        rng.randn(T, N, I).astype(np.float32),
        (0.3 * rng.randn(ps)).astype(np.float32),
        rng.randn(layers * dirs, N, H).astype(np.float32),
        rng.randn(layers * dirs, N, H).astype(np.float32))]


def run_rnn(tensors, mode, layers, bidirectional, device):
    leaves = [t.to(device).requires_grad_() for t in tensors]
    outs = RNN(*leaves, state_size=6, num_layers=layers, mode=mode,
               bidirectional=bidirectional)
    loss = sum((o * (k + 1)).sum() for k, o in enumerate(outs))
    grads = torch.autograd.grad(loss, leaves[:3] + ([leaves[3]] if mode
                                                     == "lstm" else []))
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_on_the_card_matches_the_cpu(card, mode, layers,
                                            bidirectional):
    tensors = rnn_inputs(mode, layers, bidirectional)
    outs, grads = run_rnn(tensors, mode, layers, bidirectional, card)
    want_outs, want_grads = run_rnn(tensors, mode, layers, bidirectional,
                                    "cpu")
    errs = [rel(g, w) for g, w in zip(outs, want_outs)]
    assert max(errs) < 5e-5, errs
    errs = [rel(g, w) for g, w in zip(grads, want_grads)]
    assert max(errs) < 1e-4, errs


def test_rnn_op_under_bf16_amp_takes_bf16_on_the_card(card):
    tensors = [t.to(card) for t in rnn_inputs("lstm", 2, False)]
    with amp.scope("bfloat16"):
        outs = ops.RNN(*tensors, state_size=6, num_layers=2, mode="lstm")
    assert all(o.dtype == torch.bfloat16 for o in outs)
    want = RNN(*tensors, state_size=6, num_layers=2, mode="lstm")
    assert rel(outs[0].float(), want[0]) < 3e-2


def _lstm_layer(device, dropout):
    torch.manual_seed(0)     # the initializer's draws
    lstm = gluon.rnn.LSTM(16, num_layers=2, dropout=dropout, input_size=8)
    lstm.initialize(mx.init.Uniform(0.1), device=device)
    return lstm


def test_captured_lstm_layer_matches_eager(card):
    x = torch.randn(9, 4, 8, generator=torch.Generator().manual_seed(1))
    eager = _lstm_layer(card, 0.0)
    graphed = _lstm_layer(card, 0.0)
    for a, b in zip(eager.collect_params().values(),
                    graphed.collect_params().values()):
        assert torch.equal(a.data()._data, b.data()._data)
    graphed.hybridize()
    results = []
    for net in (eager, graphed):
        for _ in range(3):
            xs = x.to(card).requires_grad_()
            with autograd.record():
                out = net(xs)
            out.backward(torch.ones_like(out))
        grads = [p.grad()._data for p in net.collect_params().values()]
        results.append((out.detach(), xs.grad, grads))
    stats = graphed.cache_stats()["graphs"]
    owner = next(iter(stats.values()))
    assert owner["graphs"] == 2 and owner["replays"] >= 2, owner
    (o1, g1, p1), (o2, g2, p2) = results
    errs = [rel(o2, o1), rel(g2, g1)] + [rel(a, b) for a, b in zip(p2, p1)]
    assert max(errs) < 1e-6, errs


def test_captured_inter_layer_dropout_draws_a_new_mask_each_replay(card):
    net = _lstm_layer(card, 0.5)
    net.hybridize()
    x = torch.randn(9, 4, 8, device=card)
    with torch.no_grad(), autograd.train_mode():
        outs = [net(x) for _ in range(4)]
    owner = next(iter(net.cache_stats()["graphs"].values()))
    assert owner["replays"] >= 2
    assert not torch.equal(outs[2], outs[3])
    with torch.no_grad(), autograd.predict_mode():
        evals = [net(x) for _ in range(4)]
    assert torch.equal(evals[2], evals[3])


def _bucketing_run(ctx, keys, batches):
    mx.random.seed(0)
    gen = chip_smoke.lstm_lm_sym_gen(sym, 4, vocab=40, embed=8, hidden=8,
                                     layers=2)
    mod = mx.mod.BucketingModule(gen, default_bucket_key=max(keys),
                                 context=ctx)
    mod.bind(data_shapes=[("data", (4, max(keys)))],
             label_shapes=[("softmax_label", (4, max(keys)))])
    rng = np.random.RandomState(0)
    init = {n: mx.nd.array((0.1 * rng.randn(*a.shape)).astype(np.float32),
                           ctx=mx.cpu())
            for n, a in mod._curr_module._exec.arg_dict.items()
            if n in mod._curr_module._param_names}
    mod.init_params(arg_params=init)
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    outs = []
    for data, label in batches:
        b = mx.io.DataBatch(
            data=[mx.nd.array(data, ctx=mx.cpu())],
            label=[mx.nd.array(label, ctx=mx.cpu())],
            provide_data=[mx.io.DataDesc("data", data.shape)],
            provide_label=[mx.io.DataDesc("softmax_label", label.shape)])
        b.bucket_key = data.shape[1]
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


def test_bucketing_module_replays_three_buckets_over_shared_weights(card):
    keys = (5, 7, 10)
    rng = np.random.RandomState(1)
    order = [10, 5, 7, 10, 5, 7, 7, 10, 5]
    batches = [(rng.randint(0, 40, (4, t)).astype(np.float32),
                rng.randint(0, 40, (4, t)).astype(np.float32))
               for t in order]
    mod, outs = _bucketing_run(mx.gpu(0), keys, batches)
    _, want = _bucketing_run(mx.cpu(), keys, batches)
    stats = mod.capture_stats()
    for key in keys:
        train = stats[key]["train"]
        assert train["graphs"] == 1
        assert train["replays"] == order.count(key) - 1
    weights = [m._exec.arg_dict["lstm_parameters"]._data
               for m in mod._buckets.values()]
    assert all(w.data_ptr() == weights[0].data_ptr() for w in weights)
    for got, ref in zip(outs, want):
        assert np.abs(got - ref).max() < 1e-4 * max(np.abs(ref).max(), 1)
