"""The port's LARS (``mxnet_tpu_torch.kernels.optimizer_update``,
``ops.optimizer_ops.lars_update`` and ``optimizer.LARS``) against the
JAX package's (``mxnet_tpu/kernels/optimizer_update.py`` with the Pallas
``lars_flat`` kernel in interpret mode, ``nd.lars_update`` /
``nd.sgd_mom_update`` and ``optimizer.LARS``), on the CPU; the port's
bucketed update against its own per-parameter one; and ``TrainStep``'s
LARS bucket and ``run_steps``.  The same numpy inputs go to both.

Tolerances: the flat pass 1e-6 in fp32 (the same expression in fp32 on
both sides; FMA contraction is the only difference) and one bf16
rounding step (relative 2^-7) in bf16, where the two fp32 results can
round to neighbouring bf16 values; weights and momenta 2e-5 relative /
2e-6 absolute after the trust ratios (fp32 norms summed in another
order), as the JAX package's own bucket test holds them."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu import kernels as jkernels
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.kernels import optimizer_update as jkopt

from mxnet_tpu_torch import MXNetError, gluon, optimizer
from mxnet_tpu_torch.kernels import optimizer_update as tkopt
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.parallel import TrainStep, data_parallel

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")

SHAPES = [(7, 5), (16,), (3, 4, 2), (9,)]
LRS = [0.1, 0.2, 0.05, 0.15]
WDS = [1e-4, 0.0, 1e-4, 5e-5]
SKIPS = [False, True, False, True]


@pytest.fixture()
def kernels_on(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")


def _param_set(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ms = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    return ws, gs, ms


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=2e-5,
                               atol=2e-6, err_msg=err_msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("n", [1, 127, 1000, 4099])
def test_flat_pass_matches_pallas_kernel(n, clip, dtype):
    rng = np.random.default_rng(n)
    w, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    lr = (rng.random(n) * 0.1).astype(np.float32)
    wd = (rng.random(n) * 1e-3).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jw, jm = jkopt.lars_flat_pallas(
        *(jnp.asarray(a).astype(jdt) for a in (w, g, m)),
        *(jnp.asarray(a) for a in (lr, wd, sign)), 0.5, momentum=0.9,
        clip=clip, interpret=True)
    tw, tm = tkopt.lars_flat_reference(
        *(torch.tensor(a).to(tdt) for a in (w, g, m)),
        *(torch.tensor(a) for a in (lr, wd, sign)), torch.tensor([0.5]),
        momentum=0.9, clip=clip)
    assert tw.dtype == tm.dtype == tdt and tw.shape == (n,)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name, t, j in (("w", tw, jw), ("m", tm, jm)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=tol, atol=1e-6, err_msg=name)


def test_bucket_update_matches_jax_bucket_and_per_param_ops(kernels_on):
    """The port's bucket against the JAX bucket (Pallas pass in interpret
    mode) and against the JAX per-parameter ops, on the JAX package's own
    parameter set: skips, ``rescale=0.5``, ``clip=1.0``.  Momenta are
    compared with the sign convention: a skip-list tensor's momentum has
    SGD's sign in all three."""
    ws, gs, ms = _param_set(0)
    kw = dict(momentum=0.9, eta=0.001, epsilon=1e-9, rescale=0.5, clip=1.0)
    jw, jm = jkopt.lars_bucket_update(
        *([jnp.asarray(a) for a in arrs] for arrs in (ws, gs, ms)),
        LRS, WDS, SKIPS, **kw)
    tw, tm = [torch.tensor(a) for a in ws], [torch.tensor(a) for a in ms]
    out = tkopt.lars_bucket_update(tw, [torch.tensor(a) for a in gs], tm,
                                   LRS, WDS, SKIPS, **kw)
    assert out[0] is tw and out[1] is tm      # updated in place
    for i in range(len(SHAPES)):
        op = nd.sgd_mom_update if SKIPS[i] else nd.lars_update
        extra = {} if SKIPS[i] else {"eta": 0.001, "epsilon": 1e-9}
        rw, rm = op(nd.NDArray(jnp.asarray(ws[i])),
                    nd.NDArray(jnp.asarray(gs[i])),
                    nd.NDArray(jnp.asarray(ms[i])), momentum=0.9,
                    lr=LRS[i], wd=WDS[i], rescale_grad=0.5,
                    clip_gradient=1.0, **extra)
        sign = -1.0 if SKIPS[i] else 1.0
        for want_w, want_m, what in ((jw[i], jm[i], "bucket"),
                                     (rw.asnumpy(), rm.asnumpy(), "op")):
            _close(tw[i], want_w, "w%d vs JAX %s" % (i, what))
            _close(sign * tm[i].numpy(), sign * np.asarray(want_m),
                   "m%d vs JAX %s" % (i, what))


def _names():
    return ["p%d_%s" % (i, "bias" if s else "weight")
            for i, s in enumerate(SKIPS)]


@pytest.mark.parametrize("kw", [
    {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001},
    {"learning_rate": 0.05, "momentum": 0.8, "eta": 0.01, "wd": 1e-3,
     "clip_gradient": 0.5, "rescale_grad": 0.25}])
def test_per_param_lars_matches_jax_lars(kw):
    """Three updates of each parameter by the port's ``LARS.update``
    against the JAX package's, the skip list chosen by name in both."""
    ws, gs, _ms = _param_set(3)
    names = _names()
    params = {i: gluon.Parameter(n, shape=w.shape)
              for i, (n, w) in enumerate(zip(names, ws))}
    topt = optimizer.create("lars", param_dict=params, **kw)
    jo = jopt.create("lars", param_idx2name=dict(enumerate(names)), **kw)
    for i, (w, g) in enumerate(zip(ws, gs)):
        assert topt._skip_lars(i) == jo._skip_lars(i) == SKIPS[i]
        tw, jw = torch.tensor(w), nd.NDArray(jnp.asarray(w))
        ts, js = topt.create_state(i, tw), jo.create_state(i, jw)
        for step in range(3):
            gi = g * (1.0 + 0.3 * step)
            topt.update(i, tw, torch.tensor(gi), ts)
            jo.update(i, jw, nd.NDArray(jnp.asarray(gi)), js)
        _close(tw, jw.asnumpy(), "w%d" % i)
        _close(ts, js.asnumpy(), "m%d" % i)


def test_bucket_update_matches_per_param_lars():
    """The port's flat bucket against its own per-parameter LARS, with
    per-parameter lr/wd multipliers, skip-list names and a bf16 group
    beside fp32 (the counterpart of the JAX package's bucket-vs-loop
    trajectory test)."""
    ws, gs, _ms = _param_set(4)
    params = [gluon.Parameter(n, shape=w.shape, lr_mult=1.0 + 0.5 * i,
                              wd_mult=0.5 * i)
              for i, (n, w) in enumerate(zip(_names(), ws))]
    kw = {"learning_rate": 0.05, "momentum": 0.9, "eta": 0.01, "wd": 0.01,
          "clip_gradient": 2.0, "rescale_grad": 0.5}
    runs = {}
    for mode in ("bucket", "per_param"):
        opt = optimizer.create("lars", param_dict=dict(enumerate(params)),
                               **kw)
        tws = [torch.tensor(w) for w in ws]
        tws[2] = tws[2].bfloat16()
        states = [opt.create_state(i, w) for i, w in enumerate(tws)]
        for step in range(3):
            tgs = [torch.tensor(g * (1 + step)).to(w.dtype)
                   for g, w in zip(gs, tws)]
            if mode == "bucket":
                for i in range(len(tws)):
                    opt._update_count(i)
                tkopt.bucket_update(opt, list(zip(range(len(tws)), tws, tgs,
                                                  states)))
            else:
                for i, (w, g) in enumerate(zip(tws, tgs)):
                    opt.update(i, w, g, states[i])
        runs[mode] = (tws, states)
    (bw, bs), (pw, ps) = runs["bucket"], runs["per_param"]
    for i in range(len(ws)):
        assert bw[i].dtype == pw[i].dtype == bs[i].dtype
        tol = 1e-2 if bw[i].dtype == torch.bfloat16 else 2e-5
        for name, a, b in (("w", bw[i], pw[i]), ("m", bs[i], ps[i])):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=tol, atol=tol * 0.1,
                                       err_msg="%s%d" % (name, i))


class _ConvBNNet(gluon.HybridBlock):
    """A channels-last conv, BatchNorm+relu site and a dense head."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.body = gluon.nn.HybridSequential(prefix="")
            self.body.add(gluon.nn.Conv2D(4, 3, padding=1, layout="NHWC",
                                          in_channels=1),
                          gluon.nn.BatchNorm(axis=-1, in_channels=4),
                          gluon.nn.Activation("relu"))
            self.head = gluon.nn.Dense(10, in_units=4 * 8 * 8)

    def hybrid_forward(self, F, x):
        return self.head(self.body(x))


def _lars_step(seed=0, lr=0.1):
    net = _ConvBNNet()
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    tr = gluon.Trainer(net.collect_params(), "lars",
                       {"learning_rate": lr, "momentum": 0.9, "eta": 0.01})
    return net, TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)


def _batches(k=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, 8, 8, 8, 1)).astype(np.float32),
            rng.integers(0, 10, (k, 8)).astype(np.float32))


def _snapshot(net):
    return {p.name[len(net.prefix):]: p.data()._data.detach().clone()
            for p in net.collect_params().values()}


def test_train_step_runs_the_lars_bucket(monkeypatch):
    """``TrainStep`` with LARS goes through ``bucket_update`` and the
    ``lars_flat`` plain version (one pass over every parameter a step),
    with the skip list read from the parameters' names."""
    net, step = _lars_step()
    seen, calls = [], []
    original = data_parallel.bucket_update

    def spy(opt, items, **kw):
        seen.append([opt._skip_lars(i) for i, *_ in items])
        return original(opt, items, **kw)

    monkeypatch.setattr(data_parallel, "bucket_update", spy)
    spec = registry.get("lars_flat")
    plain = spec.plain
    monkeypatch.setattr(spec, "plain", lambda *a, **k: calls.append(
        a[0].numel()) or plain(*a, **k))
    x, y = _batches()
    losses = [float(step(x[0], y[0])) for _ in range(4)]
    names = [p.name for p in step._trainer._params if p.grad_req != "null"]
    assert seen == [[n.endswith(("bias", "gamma", "beta"))
                     for n in names]] * 4
    assert any(seen[0]) and not all(seen[0])
    assert calls == [sum(p.data()._data.numel() for p in step._trainer._params
                         if p.grad_req != "null")] * 4
    assert losses[-1] < losses[0]


def test_train_step_skips_the_lars_bucket_on_nonfinite_gradients():
    net, step = _lars_step(seed=1)
    x, y = _batches(seed=1)
    step(x[0], y[0])
    tr = step._trainer
    weights = {k: v for k, v in _snapshot(net).items()
               if "running" not in k}
    states = {i: s.clone() for i, s in tr._updater.states.items()}
    count = tr.optimizer.num_update
    bad = x[1].copy()
    bad[0, 0, 0, 0] = np.nan
    assert not np.isfinite(float(step(bad, y[1])))
    assert step.last_step_finite is False
    assert tr.optimizer.num_update == count + 1
    after = _snapshot(net)
    for k, v in weights.items():
        assert torch.equal(after[k], v), k
    for i, s in tr._updater.states.items():
        assert torch.equal(states[i], s)


def test_run_steps_matches_sequential_calls():
    """``run_steps`` over (K, B, ...) reproduces K ``__call__``s exactly:
    losses, weights, LARS momenta and running statistics; the losses come
    back as one (K,) tensor, the update counts advance by K, and lr and
    wd are the optimizer's own again after the block."""
    x, y = _batches(k=3, seed=2)
    net_a, step_a = _lars_step(seed=2)
    net_b, step_b = _lars_step(seed=2)
    ref = torch.stack([step_a(x[k], y[k]) for k in range(3)])
    losses = step_b.run_steps(x, y)
    assert losses.shape == (3,)
    assert torch.equal(losses, ref)
    a, b = _snapshot(net_a), _snapshot(net_b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = step_a._trainer._updater.states, step_b._trainer._updater.states
    assert all(torch.equal(sa[i], sb[i]) for i in sa)
    opt = step_b._trainer.optimizer
    assert set(opt._index_update_count.values()) == {3}
    assert "_get_lr" not in vars(opt) and "_get_wd" not in vars(opt)


def test_run_steps_reads_lr_once_per_block():
    """An lr read during the block is the one read at its start (the JAX
    package feeds the block-start lr to every step of its scan)."""
    x, y = _batches(k=3, seed=3)
    net, step = _lars_step(seed=3)
    opt = step._trainer.optimizer
    seen = []
    original = data_parallel.bucket_update

    def spy(o, items, **kw):
        seen.append(o._get_lr(items[0][0]))
        o.lr *= 10          # a change inside the block is not seen
        return original(o, items, **kw)

    data_parallel.bucket_update = spy
    try:
        step.run_steps(x, y)
    finally:
        data_parallel.bucket_update = original
    assert seen == [0.1] * 3
    assert opt._get_lr(0) == pytest.approx(100.0)


def test_lars_flat_wrapper_refuses_cpu_tensors():
    w = torch.zeros(4)
    with pytest.raises(MXNetError, match="needs CUDA"):
        tkopt.lars_flat_cuda(w, w, w, w, w, w, 1.0)
    assert tkopt.bucket_supported(optimizer.create("lars"))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_bucket_update_gradient_matches_jax_grad(kernels_on, clip):
    """With inputs that require a gradient, ``lars_bucket_update``
    writes nothing in place and returns new tensors whose gradient --
    through the trust ratios and ``FlatLars``'s replayed backward --
    w.r.t. weights, gradients, momenta and the per-tensor lrs equals
    ``jax.grad`` of the JAX bucket (its ``custom_vjp``, the Pallas pass
    in interpret mode), at the flat pass's tolerance after the trust
    ratios (2e-5 relative)."""
    import jax
    ws, gs, ms = _param_set(4)
    rng = np.random.default_rng(5)
    cw = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    kw = dict(momentum=0.9, eta=0.001, epsilon=1e-9, rescale=0.5, clip=clip)

    def jloss(ws_, gs_, ms_, lrs_):
        nw, nm = jkopt.lars_bucket_update(ws_, gs_, ms_, list(lrs_), WDS,
                                          SKIPS, **kw)
        return sum(jnp.sum(w * w * c) + jnp.sum(m) for w, m, c in
                   zip(nw, nm, cw))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *([jnp.asarray(a) for a in arrs] for arrs in (ws, gs, ms)),
        jnp.asarray(LRS, jnp.float32))
    leaves = [[torch.tensor(a, requires_grad=True) for a in arrs]
              for arrs in (ws, gs, ms)]
    lrs = torch.tensor(LRS, requires_grad=True)
    nw, nm = tkopt.lars_bucket_update(*leaves, lrs, WDS, SKIPS, **kw)
    assert all(a is not b for a, b in zip(nw, leaves[0]))
    loss = sum((w * w * torch.tensor(c)).sum() + m.sum()
               for w, m, c in zip(nw, nm, cw))
    loss.backward()
    for k, (got, jw) in enumerate(zip(leaves + [[lrs]], want[:3]
                                      + ([want[3]],))):
        for i, (t, j) in enumerate(zip(got, jw)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       rtol=2e-5, atol=2e-6,
                                       err_msg="input %d, tensor %d"
                                       % (k, i))
    for t, a in zip(leaves[0], ws):          # nothing written in place
        np.testing.assert_array_equal(t.detach().numpy(), a)


def test_flat_lars_function_backward_is_autodiff_of_the_plain_math():
    n = 300
    rng = np.random.default_rng(6)
    ins = [torch.tensor(rng.standard_normal(n).astype(np.float32),
                        requires_grad=True) for _ in range(3)]
    lr, wd = torch.full((n,), 0.1), torch.full((n,), 1e-4)
    sign, rs = torch.ones(n), torch.tensor([0.5])
    nw, nm = tkopt.FlatLars.apply(*ins, lr, wd, sign, rs, 0.9, 0.0)
    got = torch.autograd.grad((nw * nw).sum() + nm.sum(), ins)
    pw, pm = tkopt.lars_flat_reference(*ins, lr, wd, sign, rs, momentum=0.9)
    want = torch.autograd.grad((pw * pw).sum() + pm.sum(), ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
