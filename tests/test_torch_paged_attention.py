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
from mxnet_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                 paged_attention_reference)


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

