"""The port's bf16 BERT slice as a whole on the CPU: a narrow
``BERTModel`` (the shape of ``bert_small``, narrower) under
``amp.scope("bfloat16")`` with Adam and a ``FactorScheduler`` through
``TrainStep`` -- ``bench.py :: bench_bert_base``'s configuration, cut
to size -- against the JAX package's ``TrainStep`` with the kernel tier
armed (``MXNET_TPU_KERNELS=1``, ``use_flash=True``: the Pallas flash
kernels in interpret mode), weights carried across by
``params_from_numpy``; the dtype each layer returns and each kernel
site is given under the bf16 policy, against the JAX package's; and an
fp16 net (``net.cast("float16")``) trained by multi-precision SGD
through ``TrainStep`` against the JAX one.

Tolerances:

- bf16: the loss and parameter limits of
  ``tests/test_torch_resnet_amp_lars.py`` (``BF16_LIMITS``): losses
  within 1e-2 relative, all parameters together within 3e-3 norm-wise
  relative.  The three steps' updates are held as the chip smoke's AMP
  oracles hold them (``held_against_floors``): within the larger of 8x the
  JAX package's own floor (the same bf16 steps with the batch permuted,
  measured 8.4e-3 norm-wise) and the distance of its fp32 steps from its
  bf16 ones (measured 5.1e-2).  Adam's first steps, ``m / sqrt(v) ~
  g / |g|``, turn a gradient entry's rounding into a full step of
  either sign, so two libraries that round to bf16 in different places
  end as far apart as bf16 is from fp32 (measured 4.8e-2; each
  tensor's distance is within its own fp32 distance), where
  ``test_torch_resnet_amp_lars.py``'s LARS steps stay within 2e-2.
  The key third of each ``qkv_bias`` is left out of the norm-wise
  measures: softmax ignores a shift of a row's scores, so its exact
  gradient is 0 and its Adam update, ``lr * g / |g|`` of rounding
  noise, a full step of either sign.
- fp16 multi-precision SGD: losses within 1e-3 relative; the fp32
  master copies within 1e-3 norm-wise relative (fp16 products summed
  in another order by each library), and each fp16 weight is its
  master copy's cast.
"""
import contextlib

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel
from mxnet_tpu.parallel import TrainStep as JTrainStep

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.parallel import TrainStep

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")

NARROW = dict(vocab_size=200, units=64, hidden_size=128, num_layers=2,
              num_heads=2, max_length=64)
BATCH, SEQ, STEPS = 2, 32, 3
ADAM = {"learning_rate": 1e-3}
BF16_LIMITS = {"loss_rel": 1e-2, "param_rel": 3e-3}
BF16_UPDATE_FACTOR = 8.0
FP16_LIMITS = {"loss_rel": 1e-3, "master_rel": 1e-3}
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "layernorm_fwd")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    v = NARROW["vocab_size"]
    return (rng.integers(0, v, (BATCH, SEQ)).astype(np.float32),
            rng.integers(0, v, (BATCH, SEQ)).astype(np.float32))


def _jax_mlm_loss():
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    vocab = NARROW["vocab_size"]

    class MLMLoss(jgluon.HybridBlock):
        def hybrid_forward(self, F, outs, labels):
            return ce(outs[0].reshape((-1, vocab)), labels.reshape((-1,)))

    return MLMLoss()


class MLMLoss(gluon.HybridBlock):
    """Masked-LM loss of ``bench.py :: bench_bert_base``."""

    def __init__(self, vocab, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outs, labels):
        return self._ce(outs[0].reshape(-1, self._vocab), labels.reshape(-1))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _out_dtype(out):
    return _dtype_name((out[0] if isinstance(out, (tuple, list))
                        else out).dtype)


def _jax_sites(jnet, ids):
    """The JAX package's bf16 forward: ``[(block type, output dtype)]``
    in call order, the input dtype of each LayerNorm, and the q dtype of
    each flash-attention call (jit off, so every call site runs)."""
    import mxnet_tpu.ops.pallas.flash_attention as pfa
    seen, ln_inputs, flash = [], [], []

    def hook(b, args, out):
        seen.append((type(b).__name__, _out_dtype(out)))
        if type(b).__name__ == "LayerNorm":
            ln_inputs.append(_dtype_name(args[0].dtype))

    def walk(b):
        yield b
        for c in b._children.values():
            yield from walk(c)

    fwd = pfa.flash_attention_fwd_pallas
    # run what an earlier test left queued in the eager bulk region, so
    # that only this forward's calls are recorded
    mx.nd.waitall()

    def recording(q, *a, **k):
        flash.append(str(q.dtype))
        return fwd(q, *a, **k)

    blocks = list(walk(jnet))
    for b in blocks:
        b.register_forward_hook(hook)
    pfa.flash_attention_fwd_pallas = recording
    try:
        with jax.disable_jit(), jamp.scope("bfloat16"), jautograd.pause():
            jnet(mx.nd.array(ids))
    finally:
        pfa.flash_attention_fwd_pallas = fwd
        for b in blocks:
            b._forward_hooks.remove(hook)
    return seen, ln_inputs, flash


def _port_sites(net, ids):
    """The port's bf16 forward on the CPU: the same three lists, the
    kernel sites read where each kernel's plain version runs."""
    seen, routes = [], {k: [] for k in KERNELS}
    hooks = [m.register_forward_hook(
        lambda m, _a, out: seen.append((type(m).__name__, _out_dtype(out))))
        for m in net.modules()]
    specs = {k: registry.get(k) for k in KERNELS}
    plains = {k: s.plain for k, s in specs.items()}

    def recording(name):
        def plain(x, *a, **k):
            routes[name].append(_dtype_name(x.dtype))
            return plains[name](x, *a, **k)
        return plain

    for k, s in specs.items():
        s.plain = recording(k)
    try:
        with amp.scope("bfloat16"), autograd.pause():
            net(torch.from_numpy(ids))
    finally:
        for k, s in specs.items():
            s.plain = plains[k]
        for h in hooks:
            h.remove()
    return seen, routes


def _jax_steps(ids, labels, bf16=True, sites=False):
    """Three Adam ``TrainStep``s with a ``FactorScheduler`` of a fresh
    seed-0 JAX net on the kernel tier: ``(initial arrays, losses, final
    weights, lr after, the bf16 forward's sites or None)``."""
    with jax.default_matmul_precision("highest"):
        np.random.seed(0)
        jnet = JBERTModel(dropout=0.0, use_flash=True, **NARROW)
        jnet.initialize(ctx=mx.cpu())
        with jautograd.pause():
            jnet(mx.nd.array(ids))
        arrays = {n: p.data().asnumpy()
                  for n, p in jnet.collect_params().items()}
        found = _jax_sites(jnet, ids) if sites else None
        sched = mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        tr = jgluon.Trainer(jnet.collect_params(), "adam",
                            dict(ADAM, lr_scheduler=sched), kvstore=None)
        step = JTrainStep(jnet, _jax_mlm_loss(), tr, mesh=None)
        with jamp.scope("bfloat16") if bf16 else contextlib.nullcontext():
            losses = [float(step(mx.nd.array(ids),
                                 mx.nd.array(labels)).asscalar())
                      for _ in range(STEPS)]
        final = {n[len(jnet.prefix):]: p.data().asnumpy()
                 for n, p in jnet.collect_params().items()}
    return arrays, losses, final, tr.learning_rate, found


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: the initial weights, the bf16 forward's sites,
    three bf16 Adam steps (losses, final weights), and the floors of
    their updates: the same steps with the batch permuted, and in
    fp32."""
    ids, labels = _batch()
    perm = np.arange(BATCH)[::-1].copy()
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_KERNELS", "1")
    try:
        arrays, losses, final, lr, sites = _jax_steps(ids, labels,
                                                      sites=True)
        permuted = _jax_steps(ids[perm], labels[perm])[2]
        fp32 = _jax_steps(ids, labels, bf16=False)[2]
    finally:
        mp.undo()
    initial = {n[len(next(iter(arrays)).split("_")[0]) + 1:]: a
               for n, a in arrays.items()}
    return {"arrays": arrays, "initial": initial, "sites": sites,
            "losses": losses, "final": final, "lr": lr,
            "permuted": permuted, "fp32": fp32}


def _port_net(arrays):
    net = BERTModel(dropout=0.0, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    return net


def _held(d):
    """``d`` with the key third of every ``qkv_bias`` cut out."""
    u = NARROW["units"]
    return {k: (np.concatenate([v[:u], v[2 * u:]])
                if k.endswith("qkv_bias") else v) for k, v in d.items()}


def _rel(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def test_bf16_site_dtypes_match_the_jax_package(jax_run):
    """Every layer's output dtype under the bf16 policy, and the dtype
    each kernel site gets: flash attention bf16 q/k/v at every layer
    (forward and backward), LayerNorm fp32 after each residual add (a
    widest-type cast of the fp32 stream and a bf16 branch) and bf16 in
    the MLM head (after its bf16 Dense)."""
    want, ln_inputs, flash = jax_run["sites"]
    net = _port_net(jax_run["arrays"])
    got, routes = _port_sites(net, _batch()[0])
    layers = NARROW["num_layers"]
    assert len(got) == len(want) > 20
    assert got == want
    assert routes["layernorm_fwd"] == ln_inputs
    assert len(ln_inputs) == 2 * layers + 2
    assert ln_inputs == ["float32"] * (2 * layers + 1) + ["bfloat16"]
    assert routes["flash_attention_fwd"] == flash == ["bfloat16"] * layers
    # the backward gets the forward's dtype at each site
    tr = gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
    step = TrainStep(net, MLMLoss(NARROW["vocab_size"]), tr)
    bwd = registry.get("flash_attention_bwd")
    plain, dtypes = bwd.plain, []

    def recording(q, *a, **k):
        dtypes.append(_dtype_name(q.dtype))
        return plain(q, *a, **k)

    bwd.plain = recording
    try:
        with amp.scope("bfloat16"):
            step(*_batch())
    finally:
        bwd.plain = plain
    assert dtypes == ["bfloat16"] * layers


def test_bf16_adam_train_steps_match_the_jax_package(jax_run):
    net = _port_net(jax_run["arrays"])
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       dict(ADAM, lr_scheduler=sched))
    step = TrainStep(net, MLMLoss(NARROW["vocab_size"]), tr)
    ids, labels = _batch()
    with amp.scope("bfloat16"):
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_run["losses"],
                               rtol=BF16_LIMITS["loss_rel"])
    assert abs(tr.learning_rate - jax_run["lr"]) <= 1e-12
    got = {p.name[len(net.prefix):]: p.data()._data.detach().numpy()
           for p in net.collect_params().values()}
    want, initial = jax_run["final"], jax_run["initial"]
    assert sorted(got) == sorted(want)
    for name, w in got.items():
        assert w.dtype == np.float32, name      # fp32 weights under AMP
    assert _rel(_held(got), _held(want)) <= BF16_LIMITS["param_rel"]
    initial = _held(initial)

    def update(w):
        return {k: v - initial[k] for k, v in _held(w).items()}

    floor = _rel(update(jax_run["permuted"]), update(jax_run["final"]))
    fp32 = _rel(update(jax_run["fp32"]), update(jax_run["final"]))
    limit = max(BF16_UPDATE_FACTOR * floor, fp32)
    assert 0 < floor < fp32 < 0.25
    assert _rel(update(got), update(want)) <= limit
    states = tr._updater.states
    assert all(isinstance(s, tuple) and len(s) == 2
               and s[0].dtype == torch.float32 for s in states.values())


def _dense(pkg, prefix):
    net = pkg.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu", in_units=8),
                pkg.nn.Dense(4, in_units=16))
    return net


def test_fp16_multi_precision_sgd_train_steps_match_the_jax_package():
    """``net.cast("float16")`` and SGD with ``multi_precision`` through
    ``TrainStep``, three steps: the fp32 master copies in the optimizer
    state, the fp16 weights their casts, against the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 8)).astype(np.float16)
    y = rng.standard_normal((8, 4)).astype(np.float16)
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
           "multi_precision": True}
    np.random.seed(1)
    jnet = _dense(jgluon, "mp_")
    jnet.initialize(ctx=mx.cpu())
    arrays = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    jnet.cast("float16")
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(sgd),
                         kvstore=None)
    jstep = JTrainStep(jnet, jgluon.loss.L2Loss(), jtr, mesh=None)
    with jax.default_matmul_precision("highest"):
        jlosses = [float(jstep(mx.nd.array(x, dtype="float16"),
                               mx.nd.array(y, dtype="float16")).asscalar())
                   for _ in range(STEPS)]
    jmaster = {i: s[1].asnumpy() for i, s in jtr._updater.states.items()}

    net = _dense(gluon, "mp_")
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    net.cast("float16")
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses,
                               rtol=FP16_LIMITS["loss_rel"])
    states = tr._updater.states
    assert sorted(states) == sorted(jmaster)
    master = {i: s[1].numpy() for i, s in states.items()}
    assert _rel(master, jmaster) <= FP16_LIMITS["master_rel"]
    for i, p in enumerate(tr._params):
        w = p.data()._data
        assert w.dtype == torch.float16
        mom, w32 = states[i]
        assert mom.dtype == w32.dtype == torch.float32
        assert torch.equal(w, w32.half()), p.name
