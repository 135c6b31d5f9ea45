"""The fused ``RNN`` op and ``gluon.rnn`` against the JAX package on the
CPU: the op in all four modes, one and two layers, one and two
directions (outputs, final states and the gradients of the input, the
flat parameters and the initial states under a head gradient that is
not ones), ``rnn_param_size``, the inter-layer dropout's keep rate and
scale, the counterparts of ``tests/test_gluon.py``'s recurrent tests
and ``tests/test_operator.py :: test_rnn_lstm_shapes_and_grad`` with
the weights carried across, the cells against the fused layer, and one
step of a small word language model (upstream ``example/gluon/
word_language_model``) against the JAX package's.

Tolerance: 1e-5 relative / 1e-5 absolute for forwards, 1e-4 for
gradients and updates (fp32 sums over the time steps in another order:
``lax.scan`` against ATen's fused recurrence)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops import nn as jops

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, ops
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.ops.nn import RNN, rnn_param_size

import chip_smoke

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-4)
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _inputs(mode, layers, bidirectional, T=6, N=3, I=4, H=5, seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    ps = rnn_param_size(mode, I, H, layers, bidirectional)
    return [rng.randn(T, N, I).astype(np.float32),
            (0.4 * rng.randn(ps)).astype(np.float32),
            rng.randn(layers * dirs, N, H).astype(np.float32),
            rng.randn(layers * dirs, N, H).astype(np.float32)]


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_the_jax_op(mode, layers, bidirectional):
    arrays = _inputs(mode, layers, bidirectional)
    kw = dict(state_size=5, num_layers=layers, mode=mode,
              bidirectional=bidirectional)

    def jfn(*a):
        return jops._rnn.fcompute(jax.random.PRNGKey(0), *a, **kw)

    jouts, vjp = jax.vjp(jfn, *[jnp.array(a) for a in arrays])
    rng = np.random.RandomState(9)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.array(c) for c in cts))

    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    touts = RNN(*leaves, **kw)
    assert len(touts) == len(jouts) == (3 if mode == "lstm" else 2)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)
    tgrads = torch.autograd.grad(touts, leaves,
                                 [torch.tensor(c) for c in cts],
                                 allow_unused=True)
    used = 4 if mode == "lstm" else 3
    for t, j in zip(tgrads[:used], jgrads[:used]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **BWD)


@pytest.mark.parametrize("args", [("lstm", 4, 6, 1, False),
                                  ("lstm", 200, 200, 2, False),
                                  ("gru", 5, 7, 3, True),
                                  ("rnn_relu", 3, 2, 2, True),
                                  ("rnn_tanh", 650, 650, 2, False)])
def test_rnn_param_size_matches_the_jax_package(args):
    assert rnn_param_size(*args) == jops.rnn_param_size(*args)


def test_rnn_op_inter_layer_dropout_keep_rate_and_scale():
    """In training, inverted dropout of rate p follows every layer but
    the last: the last layer's input is the first layer's output zeroed
    at rate p, the rest scaled by 1 / (1 - p).  Measured through a
    second layer that is the identity on its input (relu mode, W_ih = I,
    W_hh = 0, no bias)."""
    T, N, H, p = 40, 50, 8, 0.3
    ps = rnn_param_size("rnn_relu", H, H, 2, False)
    params = torch.zeros(ps)
    eye = torch.eye(H).reshape(-1)
    layer = H * H * 2 + 2 * H
    params[:H * H] = eye                   # layer 0: relu(x)
    params[layer:layer + H * H] = eye      # layer 1: relu(layer 0's out)
    x = torch.rand(T, N, H) + 0.5
    h0 = torch.zeros(2, N, H)
    out, _ = RNN(x, params, h0, state_size=H, num_layers=2,
                 mode="rnn_relu", p=p, training=True)
    ratio = (out / x).reshape(-1)
    kept = ratio != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    np.testing.assert_allclose(ratio[kept].numpy(), 1 / (1 - p), rtol=1e-5)
    a, _ = RNN(x, params, h0, state_size=H, num_layers=2, mode="rnn_relu",
               p=p, training=False)
    b, _ = RNN(x, params, h0, state_size=H, num_layers=2, mode="rnn_relu",
               p=p, training=False)
    np.testing.assert_array_equal(a.numpy(), x.numpy())
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rnn_op_follows_its_step_by_step_statement():
    """The fused recurrence against ``_rnn_cell_step`` over time."""
    from mxnet_tpu_torch.ops.nn import _rnn_cell_step, _rnn_unpack
    for mode in MODES:
        x, p, h, c = [torch.tensor(a) for a in _inputs(mode, 1, False)]
        out = RNN(x, p, h, c, state_size=5, mode=mode)
        (wts,), = _rnn_unpack(p, mode, 4, 5, 1, False)
        hh, cc, ys = h[0], c[0], []
        for t in range(x.shape[0]):
            hh, cc = _rnn_cell_step(mode, x[t], hh, cc, *wts)
            ys.append(hh)
        np.testing.assert_allclose(out[0].numpy(), torch.stack(ys).numpy(),
                                   **FWD)


def _carry(jnet, tnet):
    params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in
                             jnet.collect_params().items()},
                      prefix=jnet.prefix)


def _seeded(jnet, x):
    jnet.initialize(ctx=jmx.cpu())
    with jautograd.pause():
        jnet(jmx.nd.array(x, ctx=jmx.cpu()))
    for i, (_, p) in enumerate(sorted(jnet.collect_params().items())):
        p.set_data(jmx.nd.array((0.3 * np.random.RandomState(i).randn(
            *p.shape)).astype(np.float32), ctx=jmx.cpu()))
    return jnet


def test_lstm_layer_matches_with_and_without_states():
    x = np.random.RandomState(0).randn(5, 3, 8).astype(np.float32)
    jl = _seeded(jgluon.rnn.LSTM(16, num_layers=2), x)
    tl = gluon.rnn.LSTM(16, num_layers=2)
    tl.initialize(device="cpu")
    _carry(jl, tl)
    np.testing.assert_allclose(tl(tmx.nd.array(x)).asnumpy(),
                               jl(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy(),
                               **FWD)
    rng = np.random.RandomState(1)
    states = [rng.randn(2, 3, 16).astype(np.float32) for _ in range(2)]
    jout, jst = jl(jmx.nd.array(x, ctx=jmx.cpu()),
                   [jmx.nd.array(s, ctx=jmx.cpu()) for s in states])
    tout, tst = tl(tmx.nd.array(x), [tmx.nd.array(s) for s in states])
    assert tout.shape == (5, 3, 16) and len(tst) == 2
    assert tst[0].shape == tst[1].shape == (2, 3, 16)
    for t, j in zip([tout] + tst, [jout] + jst):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **FWD)
    begin = tl.begin_state(batch_size=3)
    assert [s.shape for s in begin] == [(2, 3, 16)] * 2


def test_gru_bidirectional_ntc_matches():
    x = np.random.RandomState(2).randn(2, 4, 5).astype(np.float32)
    jg = _seeded(jgluon.rnn.GRU(8, bidirectional=True, layout="NTC"), x)
    tg = gluon.rnn.GRU(8, bidirectional=True, layout="NTC")
    tg.initialize(device="cpu")
    _carry(jg, tg)
    out = tg(tmx.nd.array(x))
    assert out.shape == (2, 4, 16)
    np.testing.assert_allclose(
        out.asnumpy(), jg(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy(), **FWD)


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "RNNCell"])
def test_cell_unroll_matches(cell):
    x = np.random.RandomState(3).randn(2, 5, 4).astype(np.float32)
    jc = getattr(jgluon.rnn, cell)(8)
    jc.initialize(ctx=jmx.cpu())
    jx = jmx.nd.array(x, ctx=jmx.cpu())
    with jautograd.pause():
        jc.unroll(5, jx, layout="NTC")
    for i, (_, p) in enumerate(sorted(jc.collect_params().items())):
        p.set_data(jmx.nd.array((0.3 * np.random.RandomState(i).randn(
            *p.shape)).astype(np.float32), ctx=jmx.cpu()))
    tc = getattr(gluon.rnn, cell)(8)
    tc.initialize(device="cpu")
    _carry(jc, tc)
    jout, jst = jc.unroll(5, jx, layout="NTC")
    tout, tst = tc.unroll(5, tmx.nd.array(x), layout="NTC")
    assert tout.shape == (2, 5, 8) and tst[0].shape == (2, 8)
    for t, j in zip([tout] + list(tst), [jout] + list(jst)):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **FWD)


def test_lstm_cell_unroll_equals_the_fused_layer():
    """A one-layer LSTM and an LSTMCell with the same weights give the
    same sequence (one gate order for both)."""
    x = torch.randn(6, 3, 4)
    layer = gluon.rnn.LSTM(5, input_size=4)
    layer.initialize(tmx.init.Uniform(0.5), device="cpu")
    cell = gluon.rnn.LSTMCell(5, input_size=4)
    cell.initialize(device="cpu")
    values = {k[3:]: p.data()._data for k, p in
              layer._collect_params_with_prefix().items()}
    for k, p in cell._collect_params_with_prefix().items():
        p.set_data(values[k])
    outs, _ = cell.unroll(6, x, layout="TNC")
    np.testing.assert_allclose(outs.detach().numpy(),
                               layer(x).detach().numpy(), **FWD)


def test_sequential_dropout_and_zoneout_cells():
    seq = gluon.rnn.SequentialRNNCell()
    with seq.name_scope():
        seq.add(gluon.rnn.LSTMCell(6))
        seq.add(gluon.rnn.DropoutCell(0.5))
        seq.add(gluon.rnn.ZoneoutCell(gluon.rnn.GRUCell(6),
                                      zoneout_outputs=0.5,
                                      zoneout_states=0.5))
    seq.initialize(device="cpu")
    assert len(seq.state_info(2)) == 3
    x = tmx.nd.array(np.random.RandomState(4).randn(2, 7, 3)
                     .astype(np.float32))
    a, sa = seq.unroll(7, x, layout="NTC")
    b, sb = seq.unroll(7, x, layout="NTC")
    assert a.shape == (2, 7, 6) and len(sa) == 3
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())   # eval: exact
    with autograd.record():
        c, _ = seq.unroll(7, x, layout="NTC")
    assert not np.array_equal(a.asnumpy(), c.asnumpy())


def test_lstm_trains_and_its_gradients_match():
    x = np.random.RandomState(5).randn(4, 2, 5).astype(np.float32)
    jl = _seeded(jgluon.rnn.LSTM(8), x)
    tl = gluon.rnn.LSTM(8)
    tl.initialize(device="cpu")
    _carry(jl, tl)
    jx, tx = jmx.nd.array(x, ctx=jmx.cpu()), tmx.nd.array(x)
    with jautograd.record():
        jloss = (jl(jx) ** 2).sum()
    jloss.backward()
    with autograd.record():
        tloss = (tl(tx) ** 2).sum()
    tloss.backward()
    np.testing.assert_allclose(tloss.asnumpy(), jloss.asnumpy(), **FWD)
    jg = {n[len(jl.prefix):]: p.grad().asnumpy()
          for n, p in jl.collect_params().items()}
    tg = {n[len(tl.prefix):]: p.grad().asnumpy()
          for n, p in tl.collect_params().items()}
    assert sorted(jg) == sorted(tg)
    assert all(np.abs(g).sum() > 0 for g in tg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **BWD)


def test_nd_rnn_lstm_shapes_and_grad_match():
    """``tests/test_operator.py :: test_rnn_lstm_shapes_and_grad`` with
    the same inputs in both packages."""
    T, N, I, H = 4, 2, 3, 5
    ps = rnn_param_size("lstm", I, H, 2, True)
    rng = np.random.RandomState(6)
    arrays = [rng.randn(T, N, I).astype(np.float32),
              (0.1 * rng.randn(ps)).astype(np.float32),
              np.zeros((4, N, H), np.float32),
              np.zeros((4, N, H), np.float32)]
    results = []
    for pkg, ag, ctx in ((jmx, jautograd, jmx.cpu()),
                         (tmx, autograd, tmx.cpu())):
        data, params, h0, c0 = [pkg.nd.array(a, ctx=ctx) for a in arrays]
        params.attach_grad()
        with ag.record():
            out, hy, cy = pkg.nd.RNN(data, params, h0, c0, state_size=H,
                                     num_layers=2, bidirectional=True,
                                     mode="lstm")
            loss = out.sum()
        loss.backward()
        assert out.shape == (T, N, 2 * H) and hy.shape == (4, N, H)
        results.append((out.asnumpy(), params.grad.asnumpy()))
    (jo, jg), (to, tg) = results
    assert float(np.abs(tg).sum()) > 0
    np.testing.assert_allclose(to, jo, **FWD)
    np.testing.assert_allclose(tg, jg, **BWD)


def test_rnn_op_keeps_bf16_under_amp_as_the_jax_package():
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp
    arrays = _inputs("lstm", 2, False)
    with jamp.scope("bfloat16"):
        jouts = jmx.nd.RNN(*[jmx.nd.array(a, ctx=jmx.cpu())
                             for a in arrays], state_size=5, num_layers=2)
    with amp.scope("bfloat16"):
        touts = ops.RNN(*[torch.tensor(a) for a in arrays], state_size=5,
                        num_layers=2)
    assert [str(t.dtype).replace("torch.", "") for t in touts] == \
        [str(j.dtype) for j in jouts] == ["bfloat16"] * 3
    np.testing.assert_allclose(touts[0].float().numpy(),
                               jouts[0].astype("float32").asnumpy(),
                               rtol=0, atol=5e-2)


def test_word_lm_step_matches_the_jax_package():
    """One step of phase 19's word LM (``chip_smoke.word_lm_model``,
    upstream ``model.py``'s ``RNNModel`` in either package) at narrow
    width, hybridized in the port: the loss averaged over the tokens,
    the gradients, the example's global-norm clip at 0.25 and one SGD
    step at lr 20."""
    V, E, H, L, T, N = 30, 8, 8, 2, 5, 3
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (T, N)).astype(np.float32)
    target = rng.randint(0, V, (T, N)).astype(np.float32)
    h0 = np.zeros((L, N, H), np.float32)
    results = []
    jnet = chip_smoke.word_lm_model(jgluon, V, E, H, L, 0.0)
    jnet.initialize(ctx=jmx.cpu())
    for i, (_, p) in enumerate(sorted(jnet.collect_params().items())):
        p.set_data(jmx.nd.array((0.2 * np.random.RandomState(i).randn(
            *p.shape)).astype(np.float32), ctx=jmx.cpu()))
    tnet = chip_smoke.word_lm_model(gluon, V, E, H, L, 0.0)
    tnet.initialize(device="cpu")
    _carry(jnet, tnet)
    tnet.hybridize()
    for pkg, ag, net, ctx in ((jmx, jautograd, jnet, jmx.cpu()),
                              (tmx, autograd, tnet, tmx.cpu())):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 20.0})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        x, y = pkg.nd.array(ids, ctx=ctx), pkg.nd.array(target, ctx=ctx)
        h = pkg.nd.array(h0, ctx=ctx)
        with ag.record():
            out, hT, cT = net(x, h, h)
            loss = loss_fn(out, y.reshape((-1,))).mean()
        loss.backward()
        grads = {n[len(net.prefix):]: p.grad().asnumpy()
                 for n, p in net.collect_params().items()}
        # the example clips by the global norm at 0.25
        total = sum(float((g.astype(np.float64) ** 2).sum())
                    for g in grads.values()) ** 0.5
        assert total > 0.25
        for p in net.collect_params().values():
            g = p.grad()
            g[:] = g * (0.25 / total)
        trainer.step(1)
        results.append((loss.asnumpy(), hT.asnumpy(), grads,
                        {n[len(net.prefix):]: p.data().asnumpy()
                         for n, p in net.collect_params().items()}))
    (jl, jh, jg, jw), (tl, th, tg, tw) = results
    np.testing.assert_allclose(tl, jl, **FWD)
    np.testing.assert_allclose(th, jh, **FWD)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **BWD)
        np.testing.assert_allclose(tw[k], jw[k], **BWD)


def test_params_from_numpy_carries_a_layers_own_structural_names():
    """A recurrent layer's own parameters have structural names with no
    ``.`` (``l0_i2h_weight``, as ``save_parameters`` writes them); they
    carry across by structure."""
    x = np.random.RandomState(8).randn(4, 2, 3).astype(np.float32)
    jl = _seeded(jgluon.rnn.GRU(5, num_layers=2, bidirectional=True), x)
    arrays = {k: p.data().asnumpy()
              for k, p in jl._collect_params_with_prefix().items()}
    assert "r1_h2h_bias" in arrays
    tl = gluon.rnn.GRU(5, num_layers=2, bidirectional=True)
    tl.initialize(device="cpu")
    params_from_numpy(tl, arrays)
    np.testing.assert_allclose(
        tl(tmx.nd.array(x)).asnumpy(),
        jl(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy(), **FWD)
