"""The port's CUDA kernels on an NVIDIA GPU: each against its plain
PyTorch version, the wrapper's input checks, and the decode engine
through the kernel.  Every test here needs the card and skips without
one.  The file imports neither JAX nor the JAX package, so on a machine
with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances: 1e-4 with fp32 caches (fp32 sums in another order), 2e-2
with bf16 caches or a bf16 query (bf16 rounding of the output)."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.kernels.paged_attention import paged_attention
from mxnet_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                 paged_attention_reference)

pytestmark = pytest.mark.gpu

# (seed, slots, num_blocks, block_size, heads, head_dim, contexts)
CASES = [
    (0, 3, 12, 4, 2, 8, [10, 5, 16]),
    (1, 5, 16, 4, 2, 8, [1, 3, 4, 5, 8]),
    (2, 4, 32, 8, 3, 16, [7, 8, 9, 24]),
    (3, 2, 12, 16, 1, 32, [16, 33]),
    (4, 4, 16, 4, 2, 8, [0, 1, 4, 9]),
    (5, 3, 64, 16, 12, 64, [1, 200, 512]),   # GPT-2 small head geometry
    (6, 2, 40, 16, 2, 160, [17, 300]),       # head_dim past the block
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _case(dev, seed, slots, nb, bs, h, d, ctx, q_dtype=torch.float32,
          kv_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    mb = max(1, max(-(-c // bs) for c in ctx))
    tables = np.zeros((slots, mb), np.int32)
    pool = rng.permutation(np.arange(1, nb)).astype(np.int32)
    used = 0
    for i, c in enumerate(ctx):
        n = -(-c // bs)
        tables[i, :n] = pool[used:used + n]
        used += n

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return (normal((slots, h, d), q_dtype), normal((nb, bs, h, d), kv_dtype),
            normal((nb, bs, h, d), kv_dtype),
            torch.from_numpy(tables).to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev).reshape(-1, 1))


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.float32, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.bfloat16, 2e-2),
], ids=["fp32", "bf16_cache", "bf16_all"])
def test_kernel_matches_plain(cuda, q_dtype, kv_dtype, atol):
    for case in CASES:
        q, k, v, bt, ctx = _case(cuda, *case, q_dtype=q_dtype,
                                 kv_dtype=kv_dtype)
        before = registry.launches("paged_attention")
        got = paged_attention(q, k, v, bt, ctx, scale=0.35)
        assert registry.launches("paged_attention") == before + 1
        want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
        torch.cuda.synchronize()
        assert got.dtype == q_dtype and got.shape == q.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, (case[0], err)
        zero = [i for i, c in enumerate(case[-1]) if c == 0]
        for i in zero:
            assert not got[i].any()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, bt, ctx = _case(cuda, *CASES[0])
    with pytest.raises(MXNetError, match="int32"):
        paged_attention_cuda(q, k, v, bt.long(), ctx)
    with pytest.raises(MXNetError, match="contiguous"):
        paged_attention_cuda(q.transpose(0, 1), k, v, bt, ctx)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        paged_attention_cuda(q.half(), k, v, bt, ctx)
    with pytest.raises(MXNetError, match="differ in dtype"):
        paged_attention_cuda(q, k, v.bfloat16(), bt, ctx)
    with pytest.raises(MXNetError, match="on cpu"):
        paged_attention_cuda(q, k, v, bt.cpu(), ctx)
    with pytest.raises(MXNetError, match="do not match"):
        paged_attention_cuda(q, k, v, bt[:2].contiguous(), ctx)


def test_decode_engine_runs_through_the_kernel(cuda):
    from mxnet_tpu_torch.serving.decode import DecodeEngine, tiny_gpt
    model = tiny_gpt(vocab_size=64, units=32, num_layers=2, num_heads=2,
                     max_seq=64)
    params = model.init_params(seed=2, device=cuda)
    registry.reset_launches()
    eng = DecodeEngine(model, params, prefill_buckets=(8, 16),
                       decode_buckets=(1, 2, 4), block_size=4,
                       num_blocks=64, device=cuda)
    eng.warmup()
    eng.start()
    try:
        prompts = [[3, 7, 1, 9, 2], [5, 5, 6], [1, 2, 3, 4]]
        streams = [eng.submit(p, 10) for p in prompts]
        for p, s in zip(prompts, streams):
            assert s.tokens() == model.reference_decode(params, p, 10)
        assert eng.cache.blocks_in_use() == 0
    finally:
        eng.close()
    assert registry.launches("paged_attention") \
        == model.num_layers * eng.decode_steps > 0
