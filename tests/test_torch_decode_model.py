"""The PyTorch port's TinyGPT against the JAX package's, on identical
weights carried across by ``params_from_numpy``: parameter names and
shapes, the full causal forward, prefill K/V, one paged decode step
(through the JAX XLA reference and through the Pallas kernel in
interpret mode) and greedy decoding.  fp32 throughout at atol 1e-5
(the same arithmetic in another summation order); 2e-2 where the KV
cache is bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.serving.decode import tiny_gpt as jax_tiny_gpt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serving.decode import (TinyGPT, params_from_numpy,
                                            tiny_gpt)

GEOM = dict(vocab_size=32, units=16, num_layers=2, num_heads=2, max_seq=32)
MODEL = tiny_gpt(**GEOM)
JMODEL = jax_tiny_gpt(**GEOM)


@pytest.fixture(scope="module")
def weights():
    """(jax params, numpy params, port params) for seed 2."""
    jp = JMODEL.init_params(2)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jp, npp, params_from_numpy(npp, "cpu")


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(
        0, GEOM["vocab_size"], (b, t)).astype(np.int32)


def test_init_params_names_shapes_match_jax(weights):
    _jp, npp, _tp = weights
    mine = MODEL.init_params(seed=0, device="cpu")
    assert sorted(mine) == sorted(npp)
    for name, value in npp.items():
        assert tuple(mine[name].shape) == value.shape, name
        assert mine[name].dtype == torch.float32
        assert mine[name].device.type == "cpu"
    again = MODEL.init_params(seed=0, device="cpu")
    other = MODEL.init_params(seed=1, device="cpu")
    assert torch.equal(mine["h0_wqkv"], again["h0_wqkv"])
    assert not torch.equal(mine["h0_wqkv"], other["h0_wqkv"])


def test_params_from_numpy_keeps_layout_and_casts(weights):
    _jp, npp, tp = weights
    assert tuple(tp["h1_wqkv"].shape) == (16, 48)
    np.testing.assert_array_equal(tp["h1_wqkv"].numpy(), npp["h1_wqkv"])
    half = params_from_numpy(npp, "cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in half.values())


def test_tinygpt_rejects_indivisible_heads():
    with pytest.raises(MXNetError, match="not divisible"):
        TinyGPT(units=10, num_heads=3)


def test_full_logits_matches_jax(weights):
    jp, _npp, tp = weights
    toks = _tokens(0, 2, 7)
    want = np.asarray(jax.jit(JMODEL.full_logits)(jp, jnp.asarray(toks)))
    got = MODEL.full_logits(tp, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 7, GEOM["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_prefill_kv_matches_jax(weights):
    jp, _npp, tp = weights
    toks = _tokens(1, 1, 9)
    wl, wk, wv = jax.jit(JMODEL.prefill_kv)(jp, jnp.asarray(toks))
    gl, gk, gv = MODEL.prefill_kv(tp, torch.from_numpy(toks))
    assert tuple(gk.shape) == (2, 9, 2, 8)
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)


@pytest.mark.parametrize("kernels,kv_dtype,atol", [
    ("0", "float32", 1e-5),              # JAX XLA reference path
    ("1", "float32", 1e-5),              # JAX Pallas kernel, interpret
    ("0", "bfloat16", 2e-2),
], ids=["xla", "pallas_interpret", "bf16_cache"])
def test_decode_step_matches_jax(weights, monkeypatch, kernels, kv_dtype,
                                 atol):
    monkeypatch.setenv("MXNET_TPU_KERNELS", kernels)
    jp, _npp, tp = weights
    rng = np.random.default_rng(3)
    bs, nb, mb = 4, 16, 8
    slab = (2, nb, bs, 2, 8)
    keys = rng.standard_normal(slab).astype(np.float32)
    values = rng.standard_normal(slab).astype(np.float32)
    # slot 0: context 6 on blocks 3,5; slot 1: context 9 on 7,2,9;
    # slot 2: a padded slot on the all-scratch table
    tables = np.zeros((3, mb), np.int32)
    tables[0, :2] = [3, 5]
    tables[1, :3] = [7, 2, 9]
    tokens = np.array([4, 17, 0], np.int32)
    positions = np.array([5, 8, 0], np.int32)
    jdt = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if kv_dtype == "bfloat16" else torch.float32

    step = jax.jit(lambda p, k, v, t, pos, bt:
                   JMODEL.decode_logits(p, k, v, t, pos, bt, bs))
    wn, wl, wk, wv = step(jp, jnp.asarray(keys).astype(jdt),
                          jnp.asarray(values).astype(jdt),
                          jnp.asarray(tokens), jnp.asarray(positions),
                          jnp.asarray(tables))
    tk = torch.from_numpy(keys).to(tdt)
    tv = torch.from_numpy(values).to(tdt)
    gn, gl, gk, gv = MODEL.decode_logits(
        tp, tk, tv, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), bs)
    assert gk is tk and gv is tv         # slabs updated in place
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=atol)
    if kv_dtype == "float32":
        assert gn.tolist() == np.asarray(wn).tolist()
    # every live row of the slabs agrees (the scratch block is garbage
    # by design: the padded slot's write lands there)
    live = np.ones(nb, bool)
    live[0] = False
    for got, want in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(got.float().numpy()[:, live],
                                   np.asarray(want, np.float32)[:, live],
                                   atol=atol)


def _jax_greedy(jp, prompt, n):
    """JAX ``reference_decode``'s loop -- one full forward per token --
    over a jitted ``full_logits`` at the fixed width max_seq (the causal
    mask makes the padding inert), so it compiles once."""
    fwd = jax.jit(JMODEL.full_logits)
    toks = list(prompt)
    out = []
    for _ in range(n):
        row = np.zeros((1, GEOM["max_seq"]), np.int32)
        row[0, :len(toks)] = toks
        logits = fwd(jp, jnp.asarray(row))
        nxt = int(jnp.argmax(logits[0, len(toks) - 1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def test_reference_decode_matches_jax(weights):
    jp, _npp, tp = weights
    for prompt in ([3, 7, 1, 9, 2], [5, 5, 6]):
        assert MODEL.reference_decode(tp, prompt, 8) \
            == _jax_greedy(jp, prompt, 8)
    eos = MODEL.reference_decode(tp, [5, 5, 6], 8)[2]
    stopped = MODEL.reference_decode(tp, [5, 5, 6], 8, eos_id=eos)
    assert stopped[-1] == eos and len(stopped) <= 3
