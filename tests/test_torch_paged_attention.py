"""Decode-step paged attention in the PyTorch port against the JAX
package: the port's plain version (the CPU path, and the oracle of the
Hopper kernel) against ``paged_attention_reference`` and the Pallas
kernel run in interpret mode, and the registry's device rule.  The
CUDA kernel against the plain version is in test_torch_cuda_kernels.py.

Tolerances: 1e-5 in fp32 (the same sums in another order), 2e-2 with
bf16 caches (the JAX package's own bf16 tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas as jax_pallas,
    paged_attention_reference as jax_reference)
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.kernels.paged_attention import paged_attention
from mxnet_tpu_torch.ops.paged_attention import (NEG_INF,
                                                 paged_attention_cuda,
                                                 paged_attention_reference,
                                                 partition_blocks)


def _case(seed, slots, nb, bs, h, d, ctx):
    """Random q/caches, block tables over distinct non-scratch blocks
    (scratch padding after), and the given context lengths."""
    rng = np.random.default_rng(seed)
    mb = max(1, max(-(-c // bs) for c in ctx))
    tables = np.zeros((slots, mb), np.int32)
    pool = rng.permutation(np.arange(1, nb)).astype(np.int32)
    used = 0
    for i, c in enumerate(ctx):
        n = -(-c // bs)
        tables[i, :n] = pool[used:used + n]
        used += n
    q = rng.standard_normal((slots, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, bs, h, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, h, d)).astype(np.float32)
    return q, k, v, tables, np.asarray(ctx, np.int32).reshape(slots, 1)


def _torch(q, k, v, bt, ctx, kv_dtype=torch.float32):
    return (torch.from_numpy(q), torch.from_numpy(k).to(kv_dtype),
            torch.from_numpy(v).to(kv_dtype), torch.from_numpy(bt),
            torch.from_numpy(ctx))


def _jax(q, k, v, bt, ctx, kv_dtype=jnp.float32):
    return (jnp.asarray(q), jnp.asarray(k).astype(kv_dtype),
            jnp.asarray(v).astype(kv_dtype), jnp.asarray(bt),
            jnp.asarray(ctx))


# (seed, slots, num_blocks, block_size, heads, head_dim, contexts)
CASES = [
    (0, 3, 12, 4, 2, 8, [10, 5, 16]),       # the JAX test geometry
    (1, 5, 16, 4, 2, 8, [1, 3, 4, 5, 8]),   # one token; block edges
    (2, 4, 32, 8, 3, 16, [7, 8, 9, 24]),
    (3, 2, 12, 16, 1, 32, [16, 33]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "seed%d" % c[0])
def test_reference_matches_jax_reference(case):
    q, k, v, bt, ctx = _case(*case)
    want = np.asarray(jax_reference(*_jax(q, k, v, bt, ctx), scale=0.35))
    got = paged_attention_reference(*_torch(q, k, v, bt, ctx), scale=0.35)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("case", CASES + [
    (4, 4, 16, 4, 2, 8, [0, 1, 4, 9]),      # ctx 0 gives zeros
], ids=lambda c: "seed%d" % c[0])
def test_reference_matches_pallas_interpret(case):
    q, k, v, bt, ctx = _case(*case)
    want = np.asarray(jax_pallas(*_jax(q, k, v, bt, ctx), scale=0.35,
                                 interpret=True))
    got = paged_attention_reference(*_torch(q, k, v, bt, ctx), scale=0.35)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_context_zero_gives_zeros_like_the_tpu_kernel():
    # the JAX reference averages V over the dead positions at ctx 0;
    # the Pallas kernel (and so the port) returns zeros there
    q, k, v, bt, ctx = _case(5, 2, 8, 4, 2, 8, [0, 6])
    got = paged_attention_reference(*_torch(q, k, v, bt, ctx)).numpy()
    ref = np.asarray(jax_reference(*_jax(q, k, v, bt, ctx)))
    assert np.all(got[0] == 0.0)
    assert np.abs(ref[0]).max() > 1e-3
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


def test_reference_masks_dead_context():
    # positions past the context must not contribute: poison them
    q, k, v, bt, ctx = _case(6, 1, 4, 4, 1, 4, [5])
    base = paged_attention_reference(*_torch(q, k, v, bt, ctx))
    blk = bt[0, 1]                       # positions 4..7; 5..7 are dead
    k[blk, 1:], v[blk, 1:] = 1e6, 1e6
    poisoned = paged_attention_reference(*_torch(q, k, v, bt, ctx))
    np.testing.assert_allclose(poisoned.numpy(), base.numpy(), atol=1e-6)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "seed%d" % c[0])
def test_bf16_cache_matches_jax(case):
    q, k, v, bt, ctx = _case(*case)
    want = np.asarray(jax_pallas(*_jax(q, k, v, bt, ctx, jnp.bfloat16),
                                 scale=0.35, interpret=True))
    got = paged_attention_reference(*_torch(q, k, v, bt, ctx,
                                            torch.bfloat16), scale=0.35)
    assert got.dtype == torch.float32    # the dtype of q
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_registry_runs_plain_version_on_cpu_without_counting():
    q, k, v, bt, ctx = _torch(*_case(*CASES[0]))
    registry.reset_launches()
    got = paged_attention(q, k, v, bt, ctx, scale=0.35)
    want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
    assert torch.equal(got, want)
    assert registry.launches("paged_attention") == 0
    assert registry.list_kernels() == [
        "bn_relu_apply", "bn_relu_bwd", "flash_attention_bwd",
        "flash_attention_fwd", "lamb_phase1", "lars_flat", "layernorm_fwd",
        "paged_attention"]
    spec = registry.get("paged_attention")
    assert spec.source == "csrc/paged_attention.cu"
    assert "paged_attention_pallas" in spec.replaces
    with pytest.raises(MXNetError, match="unknown kernel"):
        registry.get("nope")


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, bt, ctx = _torch(*_case(*CASES[0]))
    with pytest.raises(MXNetError, match="CUDA tensors"):
        paged_attention_cuda(q, k, v, bt, ctx)


def test_kernel_source_is_in_the_package():
    from mxnet_tpu_torch import _build
    srcs = _build.sources()
    assert "paged_attention" in srcs
    text = srcs["paged_attention"].read_text()
    assert "paged_attention_pallas" in text      # the note on what it ports
    assert 'extern "C" int paged_attention_launch' in text



# -- the CUDA kernel's decomposition: split the context, merge the parts --

def _split_merge(q, k_cache, v_cache, block_tables, context_lens, scale,
                 part_blocks, with_parts=False):
    """The arithmetic of the CUDA kernel in plain PyTorch: each slot's
    table cut into partitions of ``part_blocks`` blocks; per partition
    (m, l, acc) with m = NEG_INF, l = 0, acc = 0 where no token is live;
    then out = sum e^(m_p - M) acc_p / sum e^(m_p - M) l_p."""
    s_, h, d = q.shape
    bs = k_cache.shape[1]
    mb = block_tables.shape[1]
    n_parts = -(-mb // part_blocks)
    tok = part_blocks * bs
    pad = n_parts * tok - mb * bs
    idx = block_tables.long()
    k = torch.nn.functional.pad(
        k_cache[idx].reshape(s_, mb * bs, h, d).float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(
        v_cache[idx].reshape(s_, mb * bs, h, d).float(), (0, 0, 0, 0, 0, pad))
    k = k.reshape(s_, n_parts, tok, h, d)
    v = v.reshape(s_, n_parts, tok, h, d)
    scores = torch.einsum("shd,spthd->shpt", q.float(), k) * scale
    n_live = context_lens.reshape(s_).clamp(0, mb * bs)
    pos = torch.arange(n_parts * tok).reshape(n_parts, tok)
    live = (pos[None] < n_live[:, None, None])[:, None]     # s 1 p t
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)                                  # s h p
    p = torch.where(live, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    acc = torch.einsum("shpt,spthd->shpd", p, v)
    big = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - big)
    out = (w[..., None] * acc).sum(dim=2) \
        / (w * l).sum(dim=2, keepdim=True).clamp_min(1e-30)
    out = out.to(q.dtype)
    return (out, (m, l, acc)) if with_parts else out


# the existing CASES, the ctx 0 case, and contexts that span several of
# the kernel's 64-token partitions (16 blocks of 4): at, one below and
# one above a boundary, beside ctx 0
SPLIT_CASES = CASES + [
    (4, 4, 16, 4, 2, 8, [0, 1, 4, 9]),
    (7, 4, 80, 4, 2, 8, [0, 63, 64, 65]),
    (8, 3, 100, 4, 1, 16, [130, 0, 200]),
]


def _part_ids(val):
    return "kernel" if val is None else "%dblk" % val


@pytest.mark.parametrize("part", [None, 1, 3], ids=_part_ids)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "seed%d" % c[0])
def test_split_merge_matches_pallas_interpret(case, part):
    q, k, v, bt, ctx = _case(*case)
    blocks = part or partition_blocks(case[3])
    want = np.asarray(jax_pallas(*_jax(q, k, v, bt, ctx), scale=0.35,
                                 interpret=True))
    got = _split_merge(*_torch(q, k, v, bt, ctx), 0.35, blocks)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("part", [None, 1, 3], ids=_part_ids)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "seed%d" % c[0])
def test_split_merge_matches_port_reference(case, part):
    t = _torch(*_case(*case))
    blocks = part or partition_blocks(case[3])
    want = paged_attention_reference(*t, scale=0.35)
    got = _split_merge(*t, 0.35, blocks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_split_merge_empty_partitions_contribute_nothing():
    # slot 0 has ctx 0 (every partition empty), slot 1 one live
    # partition of four: empty ones give m = NEG_INF, l = 0, acc = 0
    # and no NaN reaches the output
    t = _torch(*_case(9, 2, 80, 4, 2, 8, [0, 10]))
    bt = torch.zeros(2, 64, dtype=torch.int32)  # 4 partitions of 16
    bt[:, :3] = t[3]
    t = t[:3] + (bt, t[4])
    out, (m, l, acc) = _split_merge(*t, 0.35, partition_blocks(4),
                                    with_parts=True)
    assert m.shape[-1] == 4
    assert torch.all(m[0] == NEG_INF) and torch.all(l[0] == 0)
    assert torch.all(l[1, :, 1:] == 0) and torch.all(acc[1, :, 1:] == 0)
    assert bool(torch.isfinite(out).all()) and torch.all(out[0] == 0)
    np.testing.assert_allclose(
        out.numpy(), paged_attention_reference(*t, scale=0.35).numpy(),
        atol=1e-5)


def test_partition_rule():
    # about 64 tokens a partition, at least one table block
    assert [partition_blocks(bs) for bs in (1, 4, 16, 64, 128, 1000)] \
        == [64, 16, 4, 1, 1, 1]
