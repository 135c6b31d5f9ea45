"""BERT pretraining as users run it, in the port against the JAX
package on the CPU: a narrow ``BERTModel`` (2 layers, 64 units, 4 heads,
vocabulary 100) on a padded batch of 3 sequences of 16 with ragged valid
lengths -- ``[CLS] A [SEP] B [SEP]`` with token types, 15% of the valid
non-special positions masked for the MLM loss (sample weight 1 there, 0
elsewhere), next-sentence labels, and ``valid_mask[b, i, j] = j <
len_b`` -- trained by the imperative loop with the default
``Trainer(kvstore="device")`` and Adam::

    with autograd.record():
        mlm, nsp = net(ids, types, valid_mask)
        loss = ce(mlm, labels, weights) + ce(nsp, nsp_labels)
    loss.backward()
    trainer.step(batch)

for three steps, both nets hybridized, the weights carried across by
``params_from_numpy``.  The JAX side runs its kernel tier
(``MXNET_TPU_KERNELS=1``) with ``use_flash=True`` (the masked Pallas
flash kernels in interpret mode) against the port's default
``use_flash=None`` (the masked flash kernels' plain versions); one case
runs both with ``use_flash=False`` (the plain attention math against
XLA's) and one with ``compression_params={"type": "2bit", "threshold":
0.5}``.

Tolerances: each step's per-sample losses 1e-5 relative; the weights
after each step 1e-5 norm-wise relative.  The key third of each
``qkv_bias`` is left out of the weights: softmax ignores a shift of a
row's scores, so its exact gradient is 0 and Adam turns the rounding
noise each library leaves there into a full step of either sign (the
rule of ``tests/test_torch_bert_bf16.py``); it is held to lie within
three Adam steps (3 x lr) of its start instead."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel

from mxnet_tpu_torch import NDArray, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.kernels import registry

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")

NARROW = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=16)
BATCH, SEQ, STEPS = 3, 16, 3
LENGTHS = (16, 11, 7)
ADAM = {"learning_rate": 1e-3, "wd": 0.01}
PAD, CLS, SEP, MASK = 0, 1, 2, 3
LOSS_TOL = 1e-5
WEIGHT_TOL = 1e-5
CASES = {
    "flash": dict(jax_flash=True, flash=None, compression=None),
    "plain": dict(jax_flash=False, flash=False, compression=None),
    "2bit": dict(jax_flash=True, flash=None,
                 compression={"type": "2bit", "threshold": 0.5}),
}


def pretraining_batch(seed=0, masked_lm_prob=0.15):
    """The padded batch: ids, token types, the key-validity mask, MLM
    labels and weights (batch, seq, 1), next-sentence labels."""
    rng = np.random.default_rng(seed)
    v = NARROW["vocab_size"]
    ids = np.full((BATCH, SEQ), PAD, np.float32)
    types = np.zeros((BATCH, SEQ), np.float32)
    labels = np.zeros((BATCH, SEQ), np.float32)
    weights = np.zeros((BATCH, SEQ, 1), np.float32)
    for b, n in enumerate(LENGTHS):
        len_a = int(rng.integers(1, n - 3))
        ids[b, :n] = rng.integers(MASK + 1, v, n)
        ids[b, 0] = CLS
        ids[b, len_a + 1] = ids[b, n - 1] = SEP
        types[b, len_a + 2:n] = 1
        cand = [i for i in range(n) if ids[b, i] not in (CLS, SEP)]
        picks = rng.permutation(cand)[:max(1, round(n * masked_lm_prob))]
        labels[b, picks] = ids[b, picks]
        weights[b, picks, 0] = 1
        for i in picks:
            r = rng.random()
            if r < 0.8:
                ids[b, i] = MASK
            elif r < 0.9:
                ids[b, i] = rng.integers(MASK + 1, v)
    lens = np.array(LENGTHS)
    mask = (np.arange(SEQ)[None, None, :] < lens[:, None, None]) \
        .astype(np.float32).repeat(SEQ, axis=1)
    nsp = rng.integers(0, 2, BATCH).astype(np.float32)
    return ids, types, mask, labels, weights, nsp


def _snapshot(params, prefix):
    return {n[len(prefix):]: (p.data().asnumpy() if hasattr(
        p.data(), "asnumpy") else p.data()).copy()
        for n, p in params.items()}


def _jax_loop(jax_flash, compression):
    ids, types, mask, labels, weights, nsp = (
        jmx.nd.array(a, ctx=jmx.cpu()) for a in pretraining_batch())
    np.random.seed(0)
    jnet = JBERTModel(dropout=0.0, use_flash=jax_flash, **NARROW)
    jnet.initialize(ctx=jmx.cpu())
    with jautograd.pause():
        jnet(ids, types, mask)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jnet.hybridize()
    trainer = jgluon.Trainer(jnet.collect_params(), "adam", dict(ADAM),
                             compression_params=compression)
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    losses, snaps = [], []
    for _ in range(STEPS):
        with jautograd.record():
            mlm, nsp_out = jnet(ids, types, mask)
            loss = ce(mlm, labels, weights) + ce(nsp_out, nsp)
        loss.backward()
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
        snaps.append(_snapshot(jnet.collect_params(), jnet.prefix))
    assert trainer._kvstore.type == "device"
    return arrays, jnet.prefix, losses, snaps


@pytest.fixture(scope="module")
def jax_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_KERNELS", "1")
    try:
        with jax.default_matmul_precision("highest"):
            return {name: _jax_loop(c["jax_flash"], c["compression"])
                    for name, c in CASES.items()}
    finally:
        mp.undo()


def _port_loop(arrays, flash, compression, counts):
    ids, types, mask, labels, weights, nsp = (
        NDArray(torch.tensor(a)) for a in pretraining_batch())
    net = BERTModel(dropout=0.0, use_flash=flash, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(ADAM),
                            compression_params=compression)
    kv_calls = []
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, snaps = [], []
    for _ in range(STEPS):
        with autograd.record():
            mlm, nsp_out = net(ids, types, mask)
            loss = ce(mlm, labels, weights) + ce(nsp_out, nsp)
        loss.backward()
        trainer.step(BATCH)
        if not kv_calls:
            pushpull = trainer._kvstore.pushpull
            trainer._kvstore.pushpull = lambda *a, **k: kv_calls.append(
                a[0]) or pushpull(*a, **k)
        losses.append(loss.asnumpy())
        snaps.append(_snapshot(net.collect_params(), net.prefix))
    live = [p for p in net.collect_params().values() if p.grad_req != "null"]
    counts["pushpull_per_step"] = len(kv_calls) / (STEPS - 1)
    counts["live"] = len(live)
    assert trainer._kvstore.type == "device"
    return losses, snaps


def _split_key_bias(snap):
    u = NARROW["units"]
    held = {k: (np.concatenate([v[:u], v[2 * u:]])
                if k.endswith("qkv_bias") else v) for k, v in snap.items()}
    keys = {k: v[u:2 * u] for k, v in snap.items() if k.endswith("qkv_bias")}
    return held, keys


def _rel(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _label(dtype, masked):
    name = str(dtype).replace("torch.", "")
    return name + (" masked" if masked else "")


def test_masked_bf16_sites_match_the_jax_package_and_the_card_phase():
    """(First in the module: it reads the JAX package's sites with jit
    off, which the JAX loops of the test below leave cached state
    for.)  The dtype (and mask) each kernel site gets on the masked path
    under the bf16 policy, read from the JAX package with jit off (every
    call site runs) against the port's: masked flash attention on bf16
    q/k/v at every layer, forward and backward; LayerNorm fp32 at the
    embedding and after each residual add, bf16 in the MLM head.  These
    are the per-step counts ``chip_smoke.py``'s phase 9b checks on the
    card (``BERT_PRETRAIN_SITE_DTYPES``, at 12 layers)."""
    from collections import Counter
    import mxnet_tpu.ops.pallas.flash_attention as pfa
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp
    ids, types, mask, labels, weights, nsp = pretraining_batch()
    np.random.seed(0)
    jnet = JBERTModel(dropout=0.0, use_flash=True, **NARROW)
    jnet.initialize(ctx=jmx.cpu())
    jargs = [jmx.nd.array(a) for a in (ids, types, mask)]
    with jautograd.pause():
        jnet(*jargs)
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jln, jflash = [], []

    def hook(b, args, out):
        jln.append(str(args[0].dtype))

    def walk(b):
        yield b
        for c in b._children.values():
            yield from walk(c)

    lns = [b for b in walk(jnet) if type(b).__name__ == "LayerNorm"]
    for b in lns:
        b.register_forward_hook(hook)
    fwd = pfa.flash_attention_fwd_pallas

    def recording(q, k, v, mask=None, *a, **kw):
        jflash.append(_label(q.dtype, mask is not None))
        return fwd(q, k, v, mask, *a, **kw)

    pfa.flash_attention_fwd_pallas = recording
    try:
        with jax.disable_jit(), jamp.scope("bfloat16"), jautograd.pause():
            jnet(*jargs)
    finally:
        pfa.flash_attention_fwd_pallas = fwd
        for b in lns:
            b._forward_hooks.remove(hook)

    net = BERTModel(dropout=0.0, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    names = ("flash_attention_fwd", "flash_attention_bwd", "layernorm_fwd")
    specs = {k: registry.get(k) for k in names}
    plains = {k: s.plain for k, s in specs.items()}
    routes = {k: [] for k in names}

    def recorder(name):
        def plain(x, *a, **k):
            routes[name].append(_label(x.dtype, k.get("mask") is not None))
            return plains[name](x, *a, **k)
        return plain

    for k, s in specs.items():
        s.plain = recorder(k)
    try:
        with amp.scope("bfloat16"):
            tr = gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
            ce = gluon.loss.SoftmaxCrossEntropyLoss()
            args = [NDArray(torch.tensor(a)) for a in (ids, types, mask)]
            with autograd.record():
                mlm, nsp_out = net(*args)
                loss = ce(mlm, NDArray(torch.tensor(labels)),
                          NDArray(torch.tensor(weights))) \
                    + ce(nsp_out, NDArray(torch.tensor(nsp)))
            loss.backward()
            tr.step(BATCH)
    finally:
        for k, s in specs.items():
            s.plain = plains[k]
    layers = NARROW["num_layers"]
    assert routes["layernorm_fwd"] == jln
    assert jln == ["float32"] * (2 * layers + 1) + ["bfloat16"]
    assert routes["flash_attention_fwd"] == jflash \
        == ["bfloat16 masked"] * layers
    assert routes["flash_attention_bwd"] == ["bfloat16 masked"] * layers
    got = {k: dict(Counter(v)) for k, v in routes.items()}
    cs = _chip_smoke()
    card = cs.BERT_PRETRAIN_SITE_DTYPES
    n = cs.BERT_LAYERS
    assert got == {"flash_attention_fwd": {"bfloat16 masked": layers},
                   "flash_attention_bwd": {"bfloat16 masked": layers},
                   "layernorm_fwd": {"float32": 2 * layers + 1,
                                     "bfloat16": 1}}
    assert card == {"flash_attention_fwd": {"bfloat16 masked": n},
                    "flash_attention_bwd": {"bfloat16 masked": n},
                    "layernorm_fwd": {"float32": 2 * n + 1, "bfloat16": 1}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_imperative_pretraining_loop_matches_the_jax_package(jax_runs, case):
    arrays, prefix, jlosses, jsnaps = jax_runs[case]
    c = CASES[case]
    counts = {}
    registry.reset_launches()
    spec = registry.get("flash_attention_fwd")
    plain, masked = spec.plain, []
    spec.plain = lambda *a, **k: masked.append(k.get("mask") is not None) \
        or plain(*a, **k)
    try:
        losses, snaps = _port_loop(arrays, c["flash"], c["compression"],
                                   counts)
    finally:
        spec.plain = plain
    # every layer of every step through the masked flash kernel's plain
    # version, or never through it on the plain route
    layers = NARROW["num_layers"]
    assert masked == ([] if c["flash"] is False else [True] * layers * STEPS)
    assert counts["pushpull_per_step"] == counts["live"] > 0
    for s in range(STEPS):
        np.testing.assert_allclose(losses[s], jlosses[s], rtol=LOSS_TOL,
                                   err_msg="step %d" % s)
        held, keys = _split_key_bias(snaps[s])
        jheld, jkeys = _split_key_bias(jsnaps[s])
        assert sorted(held) == sorted(jheld)
        err = _rel(held, jheld)
        assert err <= WEIGHT_TOL, (s, err)
        start = _split_key_bias({k[len(prefix):]: v
                                 for k, v in arrays.items()})[1]
        for k in keys:
            lim = ADAM["learning_rate"] * (s + 1) * 1.01
            assert np.abs(keys[k] - start[k]).max() <= lim, k
    assert float(losses[-1].sum()) < float(losses[0].sum())
