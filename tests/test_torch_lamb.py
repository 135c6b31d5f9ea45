"""The port's LAMB (``mxnet_tpu_torch.kernels.optimizer_update``,
``ops.optimizer_ops`` and ``optimizer.LAMB``) against the JAX package's
(``mxnet_tpu/kernels/optimizer_update.py`` with the Pallas phase-1
kernel in interpret mode, ``lamb_update_phase1/2`` and
``optimizer.LAMB``), on the CPU; and the port's bucketed update against
its own per-parameter one (the port of ``tests/test_kernels.py ::
test_lamb_bucket_matches_per_param_ops``).  The same numpy inputs go to
both.

Tolerances: 2e-6 absolute / 2e-5 relative on weights and moments (fp32
sums in another order in the trust-ratio norms; the phase-1 math is the
same expression); phase-1 outputs 1e-6."""
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
from mxnet_tpu_torch.parallel import TrainStep

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")

SHAPES = [(7, 5), (16,), (3, 4, 2), (9,), (130,)]


@pytest.fixture()
def kernels_on(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")


def _param_set(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ms = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    vs = [(np.abs(rng.standard_normal(s)) * 0.1).astype(np.float32)
          for s in SHAPES]
    return ws, gs, ms, vs


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-6, err_msg=err_msg)


@pytest.mark.parametrize("clip,n", [(0.0, 1000), (0.7, 257)])
def test_phase1_matches_pallas_kernel(clip, n):
    rng = np.random.default_rng(1)
    w, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    wd = (rng.random(n) * 0.01).astype(np.float32)
    scalars = (0.5, 1.0 / (1 - 0.9 ** 3), 1.0 / (1 - 0.999 ** 3))
    jgw, jm, jv = jkopt.lamb_phase1_pallas(
        *(jnp.asarray(a) for a in (w, g, m, v, wd)),
        jnp.asarray(scalars, jnp.float32), beta1=0.9, beta2=0.999,
        eps=1e-6, clip=clip, interpret=True)
    tgw, tm, tv = tkopt.lamb1_reference(
        *(torch.tensor(a) for a in (w, g, m, v, wd)),
        torch.tensor(scalars, dtype=torch.float32), beta1=0.9,
        beta2=0.999, eps=1e-6, clip=clip)
    assert tgw.dtype == torch.float32
    for name, t, j in (("gw", tgw, jgw), ("m", tm, jm), ("v", tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("bounds,clip", [((None, None), None),
                                         ((0.01, 10.0), 1.0)])
def test_bucket_update_matches_jax_bucket_update(kernels_on, bounds, clip):
    ws, gs, ms, vs = _param_set(2)
    lrs = [0.1, 0.2, 0.05, 0.15, 0.1]
    wds = [1e-4, 0.0, 1e-4, 5e-5, 0.01]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, bias_correction=True,
              lower_bound=bounds[0], upper_bound=bounds[1], rescale=0.5,
              clip=clip)
    jw, jm, jv = jkopt.lamb_bucket_update(
        *([jnp.asarray(a) for a in arrs] for arrs in (ws, gs, ms, vs)),
        lrs, wds, 3, **kw)
    tw, tm, tv = ([torch.tensor(a) for a in arrs] for arrs in (ws, ms, vs))
    out = tkopt.lamb_bucket_update(tw, [torch.tensor(a) for a in gs], tm,
                                   tv, lrs, wds, 3, **kw)
    assert out[0] is tw     # updated in place
    for i in range(len(SHAPES)):
        _close(tw[i], jw[i], "w%d" % i)
        _close(tm[i], jm[i], "m%d" % i)
        _close(tv[i], jv[i], "v%d" % i)


def _jax_lamb(**kw):
    return jopt.create("lamb", **kw)


@pytest.mark.parametrize("kw", [
    {"learning_rate": 0.01, "wd": 0.01},
    {"learning_rate": 0.05, "wd": 0.0, "lower_bound": 0.1,
     "upper_bound": 2.0, "clip_gradient": 0.5, "rescale_grad": 0.25},
    {"learning_rate": 0.01, "bias_correction": False}])
def test_per_param_lamb_matches_jax_lamb(kw):
    """Three updates of each parameter by the port's ``LAMB.update``
    against the JAX package's."""
    ws, gs, _ms, _vs = _param_set(3)
    topt, jo = optimizer.create("lamb", **kw), _jax_lamb(**kw)
    for i, (w, g) in enumerate(zip(ws, gs)):
        tw, jw = torch.tensor(w), nd.NDArray(jnp.asarray(w))
        ts, js = topt.create_state(i, tw), jo.create_state(i, jw)
        for step in range(3):
            gi = g * (1.0 + 0.3 * step)
            topt.update(i, tw, torch.tensor(gi), ts)
            jo.update(i, jw, nd.NDArray(jnp.asarray(gi)), js)
        _close(tw, jw.asnumpy(), "w%d" % i)
        _close(ts[0], js[0].asnumpy(), "m%d" % i)
        _close(ts[1], js[1].asnumpy(), "v%d" % i)


def test_bucket_update_matches_per_param_lamb():
    """The port's flat bucket against its own per-parameter LAMB, with
    per-parameter lr/wd multipliers and a bf16 group beside fp32."""
    ws, gs, _ms, _vs = _param_set(4)
    params = [gluon.Parameter("p%d" % i, shape=w.shape,
                              lr_mult=1.0 + 0.5 * i, wd_mult=0.5 * i)
              for i, w in enumerate(ws)]
    kw = {"learning_rate": 0.02, "wd": 0.01, "lower_bound": 0.05,
          "upper_bound": 5.0, "clip_gradient": 2.0, "rescale_grad": 0.5}
    runs = {}
    for mode in ("bucket", "per_param"):
        opt = optimizer.create("lamb", param_dict=dict(enumerate(params)),
                               **kw)
        tws = [torch.tensor(w) for w in ws]
        tws[1] = tws[1].bfloat16()
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
        assert bw[i].dtype == pw[i].dtype == bs[i][0].dtype
        tol = 1e-2 if bw[i].dtype == torch.bfloat16 else 2e-5
        for name, a, b in (("w", bw[i], pw[i]), ("m", bs[i][0], ps[i][0]),
                           ("v", bs[i][1], ps[i][1])):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=tol, atol=tol * 0.1,
                                       err_msg="%s%d" % (name, i))


class _PartlyUsed(gluon.HybridBlock):
    """Two dense layers on the path and one that takes no gradient."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.a = gluon.nn.Dense(8, in_units=6, activation="relu")
            self.b = gluon.nn.Dense(2, in_units=8)
            self.unused = gluon.nn.Dense(4, in_units=3)

    def hybrid_forward(self, F, x):
        return self.b(self.a(x))


def test_train_step_runs_the_bucket_and_updates_unused_params():
    """``TrainStep`` with LAMB goes through ``lamb_phase1`` (its plain
    version on the CPU) over every parameter, and a parameter left
    without a gradient moves as with JAX's zero gradient: LAMB's
    direction is ``wd * w`` and the trust ratio ``1 / wd``, so each step
    scales it by ``1 - lr``."""
    net = _PartlyUsed()
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    lr = 0.01
    tr = gluon.Trainer(net.collect_params(), "lamb",
                       {"learning_rate": lr, "wd": 0.1})
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = rng.standard_normal((5, 2)).astype(np.float32)
    calls = []
    spec = registry.get("lamb_phase1")
    plain = spec.plain
    spec.plain = lambda *a, **k: calls.append(a[0].numel()) or plain(*a,
                                                                       **k)
    try:
        w_unused = net.unused.weight.data()._data.detach().clone()
        losses = [float(step(x, y)) for _ in range(4)]
    finally:
        spec.plain = plain
    assert calls == [sum(p.data()._data.numel()
                         for p in net.collect_params().values())] * 4
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(net.unused.weight.data().asnumpy(),
                               w_unused.numpy() * (1 - lr) ** 4, rtol=1e-5)


def test_bucket_update_refuses_other_optimizers():
    opt = optimizer.create("sgd", learning_rate=0.1)
    assert not tkopt.bucket_supported(opt)
    with pytest.raises(MXNetError, match="no bucketed update"):
        tkopt.bucket_update(opt, [])
    with pytest.raises(MXNetError, match="needs CUDA"):
        w = torch.zeros(4)
        tkopt.lamb_phase1_cuda(w, w, w, w, w, (1.0, 1.0, 1.0))


def test_trust_ratio_norm_is_exact_at_bert_embedding_size():
    """The trust-ratio norms accumulate in fp64: at the size of BERT's
    embedding and decoder weights (2.3e7 values) PyTorch's fp32 norm on
    the CPU is off by ~1e-3 relative, which would move every LAMB step
    of those weights by as much."""
    x = torch.rand(23_440_896, generator=torch.Generator().manual_seed(0))
    x = x * 0.14 - 0.07
    want = torch.linalg.vector_norm(x.double())
    got = tkopt.l2_norm(x)
    assert got.dtype == torch.float32
    assert abs(float(got) / float(want) - 1) < 1e-7


def test_train_step_skips_the_bucket_on_nonfinite_gradients():
    """The finite-skip contract holds on the bucket path: a NaN in the
    batch leaves weights and LAMB moments as they were, while the update
    counts advance."""
    net = _PartlyUsed()
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    tr = gluon.Trainer(net.collect_params(), "lamb",
                       {"learning_rate": 0.01, "wd": 0.1})
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = rng.standard_normal((5, 2)).astype(np.float32)
    step(x, y)
    weights = [p.data()._data.detach().clone()
               for p in net.collect_params().values()]
    states = [tuple(t.clone() for t in s)
              for _i, s in sorted(tr._updater.states.items())]
    count = tr.optimizer.num_update
    x[0, 0] = np.nan
    assert not np.isfinite(float(step(x, y)))
    assert step.last_step_finite is False
    assert tr.optimizer.num_update == count + 1
    for a, p in zip(weights, net.collect_params().values()):
        assert torch.equal(a, p.data()._data.detach())
    for a, (_i, s) in zip(states, sorted(tr._updater.states.items())):
        assert all(torch.equal(u, v) for u, v in zip(a, s))


@pytest.mark.parametrize("bounds,clip", [((None, None), None),
                                         ((0.01, 10.0), 1.0)])
def test_bucket_update_gradient_matches_jax_grad(kernels_on, bounds, clip):
    """With inputs that require a gradient, ``lamb_bucket_update``
    writes nothing in place and returns new tensors whose gradient --
    through the trust ratios and ``FlatLamb1``'s replayed backward --
    w.r.t. weights, gradients and both moments equals ``jax.grad`` of
    the JAX bucket (its ``custom_vjp``, the Pallas phase 1 in interpret
    mode), within 2e-5 relative."""
    import jax
    ws, gs, ms, vs = _param_set(7)
    lrs = [0.1, 0.2, 0.05, 0.15, 0.1]
    wds = [1e-4, 0.0, 1e-4, 5e-5, 0.01]
    rng = np.random.default_rng(8)
    cw = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in ws]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, bias_correction=True,
              lower_bound=bounds[0], upper_bound=bounds[1], rescale=0.5,
              clip=clip)

    def jloss(*arrs):
        nw, nm, nv = jkopt.lamb_bucket_update(*arrs, lrs, wds, 3, **kw)
        return sum(jnp.sum(w * c) + jnp.sum(m * m) + jnp.sum(v)
                   for w, m, v, c in zip(nw, nm, nv, cw))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *([jnp.asarray(a) for a in arrs] for arrs in (ws, gs, ms, vs)))
    leaves = [[torch.tensor(a, requires_grad=True) for a in arrs]
              for arrs in (ws, gs, ms, vs)]
    nw, nm, nv = tkopt.lamb_bucket_update(*leaves, lrs, wds, 3, **kw)
    loss = sum((w * torch.tensor(c)).sum() + (m * m).sum() + v.sum()
               for w, m, v, c in zip(nw, nm, nv, cw))
    loss.backward()
    for k, (got, jw) in enumerate(zip(leaves, want)):
        for i, (t, j) in enumerate(zip(got, jw)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       rtol=2e-5, atol=2e-6,
                                       err_msg="input %d, tensor %d"
                                       % (k, i))
    for t, a in zip(leaves[0], ws):          # nothing written in place
        np.testing.assert_array_equal(t.detach().numpy(), a)
