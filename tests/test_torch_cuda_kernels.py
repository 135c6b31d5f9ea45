"""The port's CUDA kernels on an NVIDIA GPU: each against its plain
PyTorch version, the wrappers' input checks, and the decode engine, a
ResNet training step, a BERT training step and a bf16 LARS ResNet
``run_steps`` through the kernels.  Every test here needs the card and
skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances: paged attention 1e-4 with fp32 caches (fp32 sums in another
order), 2e-2 with bf16 caches or a bf16 query (bf16 rounding of the
output).  Fused BN+ReLU, LayerNorm and LAMB phase 1, relative to the
largest output: 1e-5 in fp32 (FMA contraction), 1e-2 in bf16 (one
rounding step of the stored value); the LARS flat pass likewise, and the
bucketed LARS card against CPU 2e-5 relative / 2e-6 absolute (trust-ratio
norms summed in another order).  Flash attention, relative to the
largest output: 2e-5 forward and 1e-4 backward in fp32 (sums in another
order; the backward sums 512 products an element, and its dq sums
arrive through reductions in device memory in an order that changes
from call to call), 2e-2 in bf16."""
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


# the kernel's context partitions: 4 table blocks (64 tokens) at block
# size 16, 16 blocks at block size 4, one block at block size 128
PARTITION_CASES = [
    (7, 5, 64, 16, 2, 64, [63, 64, 65, 0, 700]),   # at, below, above a
    # partition boundary; ctx 0 beside the slot with the most partitions
    (8, 4, 200, 4, 2, 8, [0, 63, 64, 65]),
    (9, 3, 40, 128, 2, 24, [129, 0, 300]),
    (10, 3, 64, 16, 12, 64, [128, 191, 192]),
]


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.float32, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2),
    (torch.bfloat16, torch.bfloat16, 2e-2),
], ids=["fp32", "bf16_cache", "bf16_q", "bf16_all"])
def test_kernel_partitions_match_plain(cuda, q_dtype, kv_dtype, atol):
    from mxnet_tpu_torch.ops.paged_attention import partition_blocks
    assert [partition_blocks(bs) for bs in (4, 16, 128)] == [16, 4, 1]
    for case in PARTITION_CASES + [CASES[5], CASES[6]]:
        q, k, v, bt, ctx = _case(cuda, *case, q_dtype=q_dtype,
                                 kv_dtype=kv_dtype)
        for _ in range(2):               # the merge tickets are reused
            got = paged_attention_cuda(q, k, v, bt, ctx, scale=0.35)
            want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
            torch.cuda.synchronize()
            assert got.dtype == q_dtype
            assert bool(torch.isfinite(got.float()).all()), case[0]
            err = (got.float() - want.float()).abs().max().item()
            assert err <= atol, (case[0], err)
            for i, c in enumerate(case[-1]):
                if c == 0:
                    assert not got[i].any()


def test_kernel_scratch_is_kept_per_stream(cuda):
    # two streams in flight at once each merge in their own partials and
    # tickets; a smaller call after a larger one reuses the larger scratch
    big = _case(cuda, 14, 5, 64, 16, 2, 64, [63, 64, 65, 0, 700])
    small = _case(cuda, 15, 2, 64, 16, 2, 64, [200, 1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_side = [paged_attention_cuda(*big, scale=0.35)
                    for _ in range(3)]
    got = [paged_attention_cuda(*t, scale=0.35) for t in (big, small, big)]
    torch.cuda.synchronize()
    want_big = paged_attention_reference(*big, scale=0.35)
    want_small = paged_attention_reference(*small, scale=0.35)
    for out, want in zip(got_side + got,
                         [want_big] * 3 + [want_big, want_small, want_big]):
        assert (out - want).abs().max().item() <= 1e-4


def test_kernel_reads_whole_table_past_its_end(cuda):
    # contexts past max_blocks * block_size read the whole table
    q, k, v, bt, _ = _case(cuda, 11, 3, 64, 16, 2, 64, [128, 128, 64])
    ctx = torch.tensor([[500], [5000], [64]], dtype=torch.int32,
                       device=cuda)      # the tables hold 8 blocks, 128
    got = paged_attention_cuda(q, k, v, bt, ctx, scale=0.35)
    want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
    capped = paged_attention_reference(q, k, v, bt, ctx.clamp(max=128),
                                       scale=0.35)
    torch.cuda.synchronize()
    assert torch.equal(want, capped)
    assert (got - want).abs().max().item() <= 1e-4


def test_kernel_d160_with_bf16_caches(cuda):
    for q_dtype in (torch.float32, torch.bfloat16):
        q, k, v, bt, ctx = _case(cuda, 12, 3, 64, 16, 2, 160, [17, 300, 65],
                                 q_dtype=q_dtype, kv_dtype=torch.bfloat16)
        got = paged_attention_cuda(q, k, v, bt, ctx, scale=0.35)
        want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("kv_dtype,atol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_kernel_takes_unaligned_cache_views(cuda, kv_dtype, atol):
    # slabs that start one element into their storage break the 16-byte
    # alignment of the vector loads: the kernel takes its scalar path
    q, k, v, bt, ctx = _case(cuda, 13, 3, 64, 16, 2, 64, [65, 130, 3],
                             kv_dtype=kv_dtype)
    k2 = torch.empty(k.numel() + 1, dtype=kv_dtype, device=cuda)[1:] \
        .view(k.shape).copy_(k)
    v2 = torch.empty(v.numel() + 1, dtype=kv_dtype, device=cuda)[1:] \
        .view(v.shape).copy_(v)
    assert k2.data_ptr() % 16 and v2.data_ptr() % 16 and k2.is_contiguous()
    got = paged_attention_cuda(q, k2, v2, bt, ctx, scale=0.35)
    want = paged_attention_reference(q, k, v, bt, ctx, scale=0.35)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= atol


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


# -- fused BatchNorm+ReLU ------------------------------------------------

BN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _bn_case(dev, rows, c, dtype, seed=0):
    from mxnet_tpu_torch.ops.fused_bn_relu import bn_relu_apply_reference
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, c, generator=g, device=dev) * 2 + 1).to(dtype)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    offset = torch.randn(c, generator=g, device=dev)
    y = bn_relu_apply_reference(x, scale, offset)
    dy = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    vecs = [torch.randn(c, generator=g, device=dev) for _ in range(5)]
    return x, scale, offset, y, dy, vecs


def _close(got, want, dtype):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err <= BN_RTOL[dtype] * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,c", [(1001, 64), (37, 512), (4097, 64),
                                    (9, 3), (5, 12)])
def test_bn_relu_kernels_match_plain(cuda, dtype, rows, c):
    from mxnet_tpu_torch.kernels.registry import dispatch
    from mxnet_tpu_torch.ops.fused_bn_relu import bn_relu_bwd_reference
    x, scale, offset, y, dy, vecs = _bn_case(cuda, rows, c, dtype)
    f0 = registry.launches("bn_relu_apply")
    b0 = registry.launches("bn_relu_bwd")
    got = dispatch("bn_relu_apply", x, scale, offset)
    assert registry.launches("bn_relu_apply") == f0 + 1
    dx = dispatch("bn_relu_bwd", x, dy, y, *vecs)
    assert registry.launches("bn_relu_bwd") == b0 + 1
    want_dx = bn_relu_bwd_reference(x, dy, y, *vecs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and dx.dtype == dtype
    ok, err = _close(got, y, dtype)
    assert ok, ("fwd", err)
    ok, err = _close(dx, want_dx, dtype)
    assert ok, ("bwd", err)


def test_bn_relu_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mxnet_tpu_torch.ops.fused_bn_relu import (bn_relu_apply_cuda,
                                                   bn_relu_bwd_cuda)
    x, scale, offset, y, dy, vecs = _bn_case(cuda, 64, 8, torch.float32)
    with pytest.raises(MXNetError, match="contiguous"):
        bn_relu_apply_cuda(x.t().contiguous().t(), scale, offset)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        bn_relu_apply_cuda(x.half(), scale, offset)
    with pytest.raises(MXNetError, match="float32 of shape"):
        bn_relu_apply_cuda(x, scale.double(), offset)
    with pytest.raises(MXNetError, match="on cpu"):
        bn_relu_apply_cuda(x, scale.cpu(), offset)
    with pytest.raises(MXNetError, match="needs CUDA"):
        bn_relu_apply_cuda(x.cpu(), scale, offset)
    with pytest.raises(MXNetError, match=r"\(rows, C\)"):
        bn_relu_apply_cuda(x.reshape(4, 16, 8), scale, offset)
    with pytest.raises(MXNetError, match="dy is"):
        bn_relu_bwd_cuda(x, dy[:32].contiguous(), y, *vecs)
    with pytest.raises(MXNetError, match="float32 of shape"):
        bn_relu_bwd_cuda(x, dy, y, vecs[0][:4].contiguous(), *vecs[1:])


@pytest.mark.parametrize("training,use_global,fix_gamma", [
    (True, False, False), (True, False, True), (False, False, False),
    (True, True, False)])
def test_fused_op_on_the_card_matches_the_cpu(cuda, training, use_global,
                                              fix_gamma):
    """The whole fused op (statistics, running-stat update, kernels,
    autograd) on the card against the same op on the CPU."""
    from mxnet_tpu_torch.kernels.fused_bn_relu import fused_bn_relu
    rng = np.random.default_rng(1)
    arrs = [(rng.standard_normal((4, 5, 5, 16)) * 2 + 1),
            rng.random(16) + 0.5, rng.standard_normal(16),
            rng.standard_normal(16) * 0.1, rng.random(16) + 0.5]
    cot = rng.standard_normal((4, 5, 5, 16))
    res = {}
    for dev in ("cpu", cuda):
        x, g, b, mm, mv = (torch.tensor(a, dtype=torch.float32,
                                        device=dev) for a in arrs)
        for t in (x, g, b):
            t.requires_grad_(True)
        out, nm, nv = fused_bn_relu(x, g, b, mm, mv, fix_gamma=fix_gamma,
                                    use_global_stats=use_global, axis=3,
                                    training=training)
        (out * torch.tensor(cot, dtype=torch.float32, device=dev)).sum() \
            .backward()
        res[str(dev)] = [t.detach().cpu() if t is not None else None
                         for t in (out, nm, nv, x.grad, g.grad, b.grad)]
    for name, a, b in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"),
                          res["cpu"], res[str(cuda)]):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_resnet_train_step_runs_through_the_kernels(cuda):
    """A narrow NHWC ResNet v1 (four bottlenecks, 8 fused sites) trains
    on the card: every site launches both kernels on every step."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.parallel import TrainStep
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, thumbnail=True, layout="NHWC")
    net.initialize(device=cuda, generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.float32)
    first = float(step(x, y))
    registry.reset_launches()
    losses = [float(step(x, y)) for _ in range(3)]
    assert registry.launches("bn_relu_apply") == 8 * 3
    assert registry.launches("bn_relu_bwd") == 8 * 3
    assert np.isfinite([first] + losses).all() and losses[-1] < first


# -- flash attention -----------------------------------------------------

# relative to the largest output: fp32 sums in another order (the
# backward sums 512 products per element, dq's through reductions in
# device memory whose order changes from call to call), bf16 one
# rounding step
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _flash_case(dev, bh, seq, d, dtype, heads=2, masked=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn():
        return torch.randn(bh, seq, d, generator=g, device=dev).to(dtype)

    q, k, v, do = randn(), randn(), randn(), randn()
    mask = None
    if masked:
        lens = torch.randint(1, seq + 1, (bh // heads,), generator=g,
                             device=dev)
        mask = (torch.arange(seq, device=dev)[None, None, :]
                < lens[:, None, None]).float().expand(
                    bh // heads, seq, seq).contiguous()
        mask[0, min(3, seq - 1), :] = 0.0          # a row with no key
    return q, k, v, do, mask


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,seq,d,causal,masked", [
    (4, 64, 64, False, False), (4, 100, 64, True, False),
    (6, 77, 32, False, True), (2, 130, 128, True, False),
    (4, 33, 20, False, False), (2, 1, 64, False, False),
    (24, 512, 64, False, False), (384, 512, 64, False, False),
    (4, 70, 18, True, False)])   # d % 4 != 0: plain loads, dq atomics
def test_flash_kernels_match_plain(cuda, dtype, bh, seq, d, causal, masked):
    from mxnet_tpu_torch.kernels.registry import dispatch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, mask = _flash_case(cuda, bh, seq, d, dtype, masked=masked)
    kw = dict(mask=mask, causal=causal, scale=d ** -0.5, heads=2)
    f0 = registry.launches("flash_attention_fwd")
    b0 = registry.launches("flash_attention_bwd")
    out, lse = dispatch("flash_attention_fwd", q, k, v, **kw)
    assert registry.launches("flash_attention_fwd") == f0 + 1
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * want_out.float()).sum(-1)
    grads = dispatch("flash_attention_bwd", q, k, v, want_lse, do, delta,
                     **kw)
    assert registry.launches("flash_attention_bwd") == b0 + 1
    want = fa.flash_attention_bwd_reference(q, k, v, want_lse, do, delta,
                                            **kw)
    torch.cuda.synchronize()
    tol_f, tol_b = FLASH_TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _rel_err(out, want_out) <= tol_f
    assert _rel_err(lse, want_lse) <= 2e-5
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype
        assert _rel_err(got, w) <= tol_b, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bwd_repeats_to_fp32_rounding(cuda, dtype):
    """dq is summed with atomics, in an order that changes from call to
    call: two calls on the same inputs agree to fp32 rounding of the
    sums (1e-6 of the largest value; bf16 adds at most one rounding
    step of the stored value), dk and dv, each written by one block,
    bit for bit."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, mask = _flash_case(cuda, 24, 512, 64, dtype, masked=True)
    kw = dict(mask=mask, scale=0.125, heads=2)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    one = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, **kw)
    two = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, **kw)
    torch.cuda.synchronize()
    assert _rel_err(one[0], two[0]) <= (1e-6 if dtype == torch.float32
                                        else 1e-2)
    assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, mask = _flash_case(cuda, 4, 16, 8, torch.float32,
                                    masked=True)
    with pytest.raises(MXNetError, match="head_dim 160"):
        big = torch.zeros(2, 4, 160, device=cuda)
        fa.flash_attention_fwd_cuda(big, big, big)
    with pytest.raises(MXNetError, match="contiguous"):
        fa.flash_attention_fwd_cuda(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), k, v)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fa.flash_attention_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(MXNetError, match="k is"):
        fa.flash_attention_fwd_cuda(q, k.bfloat16(), v)
    with pytest.raises(MXNetError, match="mask must be"):
        fa.flash_attention_fwd_cuda(q, k, v, mask=mask[:1].contiguous(),
                                    heads=2)
    with pytest.raises(MXNetError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, v, torch.zeros(4, 15,
                                                         device=cuda),
                                    do, torch.zeros(4, 16, device=cuda))


def test_flash_op_on_the_card_matches_the_cpu(cuda):
    """The autograd function (forward kernel, delta, backward kernels)
    on the card against the same op on the CPU."""
    from mxnet_tpu_torch.ops.transformer import (flash_attention,
                                                 flash_attention_masked)
    q, k, v, do, mask = _flash_case(cuda, 4, 96, 64, torch.float32,
                                    masked=True)
    for masked in (False, True):
        res = {}
        for dev in ("cpu", cuda):
            ins = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
            if masked:
                out = flash_attention_masked(*ins, mask.to(dev), heads=2)
            else:
                out = flash_attention(*ins, causal=True)
            out.backward(do.to(dev))
            res[str(dev)] = [out.detach().cpu()] + [t.grad.cpu()
                                                    for t in ins]
        for name, a, b in zip(("out", "dq", "dk", "dv"), res["cpu"],
                              res[str(cuda)]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


# -- LayerNorm -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,dim", [(16384, 768), (1000, 100), (7, 3),
                                      (33, 1), (5, 4096)])
def test_layernorm_kernel_matches_plain(cuda, dtype, rows, dim):
    from mxnet_tpu_torch.kernels.layernorm import layernorm_reference
    from mxnet_tpu_torch.kernels.registry import dispatch
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(rows, dim, generator=g, device=cuda) * 3 + 1).to(dtype)
    gamma = torch.rand(dim, generator=g, device=cuda) + 0.5
    beta = torch.randn(dim, generator=g, device=cuda)
    n0 = registry.launches("layernorm_fwd")
    got = dispatch("layernorm_fwd", x, gamma, beta, eps=1e-5)
    assert registry.launches("layernorm_fwd") == n0 + 1
    want = layernorm_reference(x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    ok, err = _close(got, want, dtype)
    assert ok, err


def test_layernorm_op_on_the_card_matches_the_cpu(cuda):
    from mxnet_tpu_torch import ops
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal((3, 50, 96)), rng.random(96) + 0.5,
            rng.standard_normal(96)]
    cot = torch.tensor(rng.standard_normal((3, 50, 96)), dtype=torch.float32)
    res = {}
    for dev in ("cpu", cuda):
        ins = [torch.tensor(a, dtype=torch.float32, device=dev)
               .requires_grad_() for a in arrs]
        out = ops.LayerNorm(*ins)
        out.backward(cot.to(dev))
        res[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
    for name, a, b in zip(("out", "dx", "dgamma", "dbeta"), res["cpu"],
                          res[str(cuda)]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -- LAMB phase 1 ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,offset,clip", [(133547324, 0, 0.0),
                                           (1 << 20, 0, 0.0),
                                           (100003, 0, 1.0),
                                           (4099, 1, 0.0), (3, 0, 0.0)])
def test_lamb_phase1_kernel_matches_plain(cuda, dtype, n, offset, clip):
    """BERT-base's bucket (133,547,324 values), aligned and unaligned
    buffers (``offset`` shifts every stream off its 16-byte boundary)
    and a scalar tail."""
    from mxnet_tpu_torch.kernels.optimizer_update import lamb1_reference
    from mxnet_tpu_torch.kernels.registry import dispatch
    g = torch.Generator(device=cuda).manual_seed(3)

    def buf(dt=dtype, positive=False):
        t = torch.randn(n + offset, generator=g, device=cuda)
        return (t.abs() if positive else t).to(dt)[offset:]

    w, gr, m, v = buf(), buf(), buf(), buf(positive=True)
    wd = buf(torch.float32, positive=True) * 0.01
    scalars = (0.5, 1.0 / (1 - 0.9 ** 4), 1.0 / (1 - 0.999 ** 4))
    c0 = registry.launches("lamb_phase1")
    got = dispatch("lamb_phase1", w, gr, m, v, wd, scalars, beta1=0.9,
                   beta2=0.999, eps=1e-6, clip=clip)
    assert registry.launches("lamb_phase1") == c0 + 1
    want = lamb1_reference(w, gr, m, v, wd, scalars, beta1=0.9,
                           beta2=0.999, eps=1e-6, clip=clip)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    for name, a, b in zip(("gw", "m", "v"), got, want):
        ok, err = _close(a, b, dtype)
        assert ok, (name, err)


def test_bert_lamb_train_step_runs_through_the_kernels(cuda):
    """A narrow BERT trains on the card with LAMB: every step launches the
    flash kernels once per layer, LayerNorm at every site and one
    phase-1 pass."""
    from mxnet_tpu_torch import gluon, random
    from mxnet_tpu_torch.gluon.model_zoo import BERTModel
    from mxnet_tpu_torch.parallel import TrainStep
    random.seed(0)
    vocab, layers = 100, 2
    net = BERTModel(vocab_size=vocab, units=64, hidden_size=128,
                    num_layers=layers, num_heads=2, max_length=64,
                    dropout=0.1)
    net.initialize(device=cuda, generator=torch.Generator().manual_seed(0))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    class MLMLoss(gluon.HybridBlock):
        def hybrid_forward(self, F, outs, labels):
            return ce(outs[0].reshape(-1, vocab), labels.reshape(-1))

    tr = gluon.Trainer(net.collect_params(), "lamb",
                       {"learning_rate": 5e-3, "wd": 0.01})
    step = TrainStep(net, MLMLoss(), tr)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (4, 48)).astype(np.float32)
    labels = rng.integers(0, vocab, (4, 48)).astype(np.float32)
    first = float(step(ids, labels))
    registry.reset_launches()
    losses = [float(step(ids, labels)) for _ in range(3)]
    assert registry.launches("flash_attention_fwd") == layers * 3
    assert registry.launches("flash_attention_bwd") == layers * 3
    assert registry.launches("layernorm_fwd") == (2 * layers + 2) * 3
    assert registry.launches("lamb_phase1") == 3
    assert np.isfinite([first] + losses).all() and losses[-1] < first


# -- LARS flat update ------------------------------------------------------

# ResNet-50 v1's trainable values (193 tensors; the flat bucket of the
# large-batch training path)
RESNET50_BUCKET = 25_575_912


def _lars_case(dev, n, offset, dtype, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)

    def buf(dt=dtype):
        return torch.randn(n + offset, generator=g, device=dev).to(dt)[offset:]

    w, gr, m = buf(), buf(), buf() * 0.1
    lr = buf(torch.float32).abs() * 0.1
    wd = buf(torch.float32).abs() * 1e-3
    sign = torch.where(buf(torch.float32) < 0, -1.0, 1.0)[:n].contiguous()
    return w, gr, m, lr, wd, sign


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,offset,clip", [(RESNET50_BUCKET, 0, 0.0),
                                           (4099, 1, 1.0), (4099, 0, 0.0),
                                           (127, 1, 0.0), (1, 0, 1.0),
                                           (1, 1, 0.0)])
def test_lars_flat_kernel_matches_plain(cuda, dtype, n, offset, clip):
    """ResNet-50's bucket, aligned and unaligned buffers (``offset``
    starts every stream at element 1, off its 16-byte boundary), a
    scalar tail, with and without clipping, mixed signs."""
    from mxnet_tpu_torch.kernels.optimizer_update import lars_flat_reference
    from mxnet_tpu_torch.kernels.registry import dispatch
    w, gr, m, lr, wd, sign = _lars_case(cuda, n, offset, dtype)
    c0 = registry.launches("lars_flat")
    got = dispatch("lars_flat", w, gr, m, lr, wd, sign, 0.25,
                   momentum=0.9, clip=clip)
    assert registry.launches("lars_flat") == c0 + 1
    want = lars_flat_reference(w, gr, m, lr, wd, sign, 0.25, momentum=0.9,
                               clip=clip)
    torch.cuda.synchronize()
    for name, a, b in zip(("w", "m"), got, want):
        assert a.dtype == dtype and a.shape == (n,)
        ok, err = _close(a, b, dtype)
        assert ok, (name, err)


def test_lars_flat_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from mxnet_tpu_torch.kernels.optimizer_update import lars_flat_cuda
    w, gr, m, lr, wd, sign = _lars_case(cuda, 64, 0, torch.float32)
    cases = [
        ((w.cpu(), gr, m, lr, wd, sign), "needs CUDA"),
        ((w, gr.bfloat16(), m, lr, wd, sign), "g must be"),
        ((w, gr, m.double(), lr, wd, sign), "m must be"),
        ((w, gr, m, lr.bfloat16(), wd, sign), "lr must be"),
        ((w, gr, m, lr, wd[:32], sign), "wd must be"),
        ((w.view(8, 8), gr, m, lr, wd, sign), "flat"),
        ((w.double(), gr.double(), m.double(), lr, wd, sign),
         "float32 or bfloat16"),
        ((w, gr, m, lr, wd, torch.ones(128, device=cuda)[::2]),
         "not contiguous")]
    for args, msg in cases:
        with pytest.raises(MXNetError, match=msg):
            lars_flat_cuda(*args, 1.0)


def test_lars_bucket_update_on_the_card_matches_the_cpu(cuda):
    """The bucketed LARS (trust ratios, per-element vectors, one kernel
    pass, the split back) on the card against the same update on the
    CPU (the plain pass), with skips, rescale and clip."""
    from mxnet_tpu_torch.kernels.optimizer_update import lars_bucket_update
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (16,), (3, 4, 2), (9,), (64, 3, 3, 8), (1000,)]
    skips = [False, True, False, True, False, True]
    lrs = [0.1, 0.2, 0.05, 0.15, 0.1, 0.3]
    wds = [1e-4, 0.0, 1e-4, 5e-5, 1e-3, 0.0]
    arrays = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
              for _ in range(3)]
    res = {}
    for dev in ("cpu", cuda):
        ws, gs, ms = ([torch.tensor(a, device=dev) for a in arrs]
                      for arrs in arrays)
        c0 = registry.launches("lars_flat")
        lars_bucket_update(ws, gs, ms, lrs, wds, skips, momentum=0.9,
                           eta=0.001, epsilon=1e-9, rescale=0.5, clip=1.0)
        res[str(dev)] = ([w.cpu() for w in ws], [m.cpu() for m in ms],
                         registry.launches("lars_flat") - c0)
    assert res["cpu"][2] == 0 and res[str(cuda)][2] == 1
    for what, (a, b) in {"w": (res["cpu"][0], res[str(cuda)][0]),
                         "m": (res["cpu"][1], res[str(cuda)][1])}.items():
        for i, (u, v) in enumerate(zip(a, b)):
            np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=2e-5,
                                       atol=2e-6, err_msg="%s%d" % (what, i))


def test_resnet_bf16_lars_run_steps_runs_through_the_kernels(cuda):
    """A narrow NHWC ResNet v1 under ``amp.scope("bfloat16")`` with LARS
    through ``run_steps`` on the card: every step launches both fused
    BatchNorm+ReLU kernels at each of its 8 sites on bf16 rows, and one
    fp32 ``lars_flat`` pass."""
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.parallel import TrainStep
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, thumbnail=True, layout="NHWC")
    net.initialize(device=cuda, generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "lars",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "eta": 0.001})
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
    rng = np.random.default_rng(0)
    k = 3
    x = np.repeat(rng.standard_normal((1, 4, 32, 32, 3)), k, 0)
    y = np.repeat(rng.integers(0, 10, (1, 4)), k, 0)
    with amp.scope("bfloat16"):
        step.run_steps(x.astype(np.float32), y.astype(np.float32))
        registry.reset_launches()
        losses = step.run_steps(x.astype(np.float32), y.astype(np.float32))
    assert losses.device.type == "cuda" and losses.shape == (k,)
    losses = losses.cpu().numpy()
    assert registry.launch_dtypes("bn_relu_apply") == {"bfloat16": 8 * k}
    assert registry.launch_dtypes("bn_relu_bwd") == {"bfloat16": 8 * k}
    assert registry.launch_dtypes("lars_flat") == {"float32": k}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for p in net.collect_params().values():
        assert p.data().dtype == torch.float32
