"""The port's CUDA kernels on an NVIDIA GPU: each against its plain
PyTorch version, the wrappers' input checks, and the decode engine, a
ResNet training step, a BERT training step and a bf16 LARS ResNet
``run_steps`` through the kernels, and the imperative API on the card
(NDArrays on the default context, context round trips, pinned
DataLoader batches, an NDArray training step).  Every test here needs the card and
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
from call to call), 2e-2 in bf16; the fp32 forward against fp64, its
mean error within 4x the plain fp32 version's; its MMA fragment
helpers against fp64 products, within 4e-6 of the sum of |x||y| an
element."""
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


@pytest.mark.parametrize("bucket", [1, 2, 32])
def test_bn_relu_apply_at_a_serving_buckets_stem_shape(cuda, bucket):
    """The forward kernel at the stem site of a ResNet-50 serving
    bucket (rows = bucket x 112 x 112, 64 channels), in inference: the
    scale and offset fold the running statistics."""
    from mxnet_tpu_torch.kernels.registry import dispatch
    x, scale, offset, y, _dy, _vecs = _bn_case(cuda, bucket * 112 * 112,
                                                64, torch.float32)
    f0 = registry.launches("bn_relu_apply")
    got = dispatch("bn_relu_apply", x, scale, offset)
    assert registry.launches("bn_relu_apply") == f0 + 1
    torch.cuda.synchronize()
    ok, err = _close(got, y, torch.float32)
    assert ok, err


def test_served_resnet_runs_through_the_kernel(cuda, tmp_path,
                                               monkeypatch):
    """A narrow NHWC ResNet v1 saved by ``save_training`` and served on
    the card by ``register(block=, checkpoint=)``: each executor call
    launches ``bn_relu_apply`` at every one of the 8 fused sites, and
    every response agrees with the net's own batch-1 forward (TF32
    off: cuDNN may pick another algorithm per batch size)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.serving import ModelRegistry

    def narrow():
        return ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                        classes=10, thumbnail=True, layout="NHWC")

    net = narrow()
    net.initialize(device=cuda, generator=torch.Generator().manual_seed(0))
    xs = np.random.default_rng(0).standard_normal(
        (11, 32, 32, 3)).astype(np.float32)
    with autograd.pause():
        net(torch.from_numpy(xs[:1]).to(cuda))
    CheckpointManager(str(tmp_path)).save_training(1, net)
    fresh = narrow()
    fresh.initialize(device=cuda)
    reg = ModelRegistry()
    try:
        s = reg.register("r", block=fresh, checkpoint=str(tmp_path),
                         input_shape=(32, 32, 3), buckets=(1, 2, 4, 8),
                         max_wait_ms=20)
        registry.reset_launches()
        futs = [s.submit(x, timeout=60) for x in xs]
        got = [f.result(timeout=60) for f in futs]
        calls = s.stats()["batches"]
        assert registry.launches("bn_relu_apply") == 8 * calls
    finally:
        reg.shutdown(drain=True)
    with autograd.pause():
        for x, g in zip(xs, got):
            want = net(torch.from_numpy(x[None]).to(cuda))[0].cpu().numpy()
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5)


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


def _flash_vs_plain(dtype, q, k, v, do, mask, causal, heads=2):
    """Both kernels, through the registry, against their plain versions
    on the same inputs."""
    from mxnet_tpu_torch.kernels.registry import dispatch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    what = (tuple(q.shape), dtype, causal, mask is not None)
    kw = dict(mask=mask, causal=causal, scale=q.shape[-1] ** -0.5,
              heads=heads)
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
    assert _rel_err(out, want_out) <= tol_f, what
    assert _rel_err(lse, want_lse) <= 2e-5, what
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype
        assert _rel_err(got, w) <= tol_b, (name,) + what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,seq,d,causal,masked", [
    (4, 64, 64, False, False), (4, 100, 64, True, False),
    (6, 77, 32, False, True), (2, 130, 128, True, False),
    (4, 33, 20, False, False), (2, 1, 64, False, False),
    (24, 512, 64, False, False), (384, 512, 64, False, False),
    (4, 70, 18, True, False),    # d % 4 != 0: plain loads, dq atomics
    (4, 300, 64, True, True),    # the empty row 3 left of skipped tiles
    (3072, 128, 64, False, False),   # bf16 BERT-base, batch 256 x seq 128
    (768, 512, 64, False, False)])   # bf16 BERT-base, batch 64 x seq 512
def test_flash_kernels_match_plain(cuda, dtype, bh, seq, d, causal, masked):
    q, k, v, do, mask = _flash_case(cuda, bh, seq, d, dtype, masked=masked)
    _flash_vs_plain(dtype, q, k, v, do, mask, causal)


def test_masked_flash_kernels_at_the_bert_pretraining_shape(cuda):
    """Masked flash forward and backward in bf16 at BERT-base
    pretraining's (64 x 12, 512, 64), with its key-only ragged mask (one
    row in ten of a length in [8, 512], the others in [448, 512]; every
    query row keeps its keys), against the plain versions; each launch
    counts as a masked bf16 launch."""
    b, heads, seq, d = 64, 12, 512, 64
    g = torch.Generator(device=cuda).manual_seed(3)

    def randn():
        return torch.randn(b * heads, seq, d, generator=g, device=cuda) \
            .to(torch.bfloat16)

    q, k, v, do = randn(), randn(), randn(), randn()
    rng = np.random.default_rng(3)
    lens = np.where(rng.random(b) < 0.1, rng.integers(8, seq + 1, b),
                    rng.integers(448, seq + 1, b))
    mask = (torch.arange(seq, device=cuda)[None, None, :]
            < torch.tensor(lens, device=cuda)[:, None, None]).float() \
        .expand(b, seq, seq).contiguous()
    registry.reset_launches()
    _flash_vs_plain(torch.bfloat16, q, k, v, do, mask, False, heads=heads)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert registry.launch_dtypes(name) == {"bfloat16 masked": 1}, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("seq", [1, 15, 64, 65, 500, 512])
@pytest.mark.parametrize("d", [8, 16, 18, 32, 64, 100, 128])
def test_flash_kernels_match_plain_over_shapes(cuda, dtype, d, seq):
    """Head dims padded to 32, 64 and 128 (and to the MMA's k-step
    inside them), edge tiles, each without and with the causal mask and
    the float mask (row 3 without a key)."""
    q, k, v, do, mask = _flash_case(cuda, 4, seq, d, dtype, masked=True,
                                    seed=seq + d)
    for causal in (False, True):
        for m in (None, mask):
            _flash_vs_plain(dtype, q, k, v, do, m, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernels_take_unaligned_views(cuda, dtype, d):
    """Tensors that start one element into their storage break the
    16-byte alignment of cp.async: the kernels take their plain loads."""
    q, k, v, do, mask = _flash_case(cuda, 4, 300, d, dtype, masked=True)

    def shifted(x):
        return torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:] \
            .view(x.shape).copy_(x)

    q, k, v, do = (shifted(x) for x in (q, k, v, do))
    assert q.data_ptr() % 16 and q.is_contiguous()
    for causal in (False, True):
        _flash_vs_plain(dtype, q, k, v, do, mask, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_keeps_fp32_accuracy(cuda, causal):
    """The fp32 forward (3xTF32) against an fp64 reference: its mean
    error on out within 4x the plain fp32 version's, with v's mean far
    from 0, where summing P V over 512 keys in the tensor cores' own
    accumulators (which round toward zero) misses by ~20x."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, _, _ = _flash_case(cuda, 24, 512, 64, torch.float32, seed=3)
    v = v * 0.05 + 1
    kw = dict(causal=causal, scale=0.125)
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * 0.125
    if causal:
        s = s.masked_fill(torch.ones(512, 512, dtype=torch.bool,
                                     device=cuda).triu(1), -1e30)
    ref = torch.matmul(torch.softmax(s, -1), v.double())
    errs = {}
    for name, fn in (("kernel", fa.flash_attention_fwd_cuda),
                     ("plain", fa.flash_attention_fwd_reference)):
        out, _ = fn(q, k, v, **kw)
        errs[name] = (out.double() - ref).abs().mean().item()
    torch.cuda.synchronize()
    assert errs["kernel"] <= 4 * errs["plain"], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["tf32x3", "bf16"])
def test_flash_mma_fragments_match_fp64(cuda, dtype):
    """The forward's MMA fragment helpers in one warp
    (``flash_mma_test_launch``): a b^T through the score product's
    fragments, and p v through the output product's with p read from
    score accumulators, against fp64 products.  Within 4e-6 of sum
    |x||y| an element: 3xTF32 keeps about fp32's precision (one TF32
    product misses by ~2^-11 = 4.9e-4), bf16 products are exact in
    fp32, and p is rounded to bf16 first, as the kernel rounds it."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    kk = 8 if dtype == torch.float32 else 16
    rng = np.random.default_rng(5)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, dtype)

    a, b, v = normal((16, kk)), normal((8, kk)), normal((kk, 8))
    p = torch.from_numpy(rng.random((16, kk)).astype(np.float32)).to(cuda)
    c = torch.zeros(2, 16, 8, device=cuda)
    rc = fa._lib().flash_mma_test_launch(
        a.data_ptr(), b.data_ptr(), p.data_ptr(), v.data_ptr(), c.data_ptr(),
        0 if dtype == torch.float32 else 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    p64 = p.to(dtype).double()
    for got, x, y in ((c[0], a.double(), b.double().T),
                      (c[1], p64, v.double())):
        err = (got.double() - x @ y).abs()
        assert (err <= 4e-6 * (x.abs() @ y.abs())).all(), err.max().item()


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
                                      (33, 1), (5, 4096),
                                      (32768, 768),    # bf16 BERT-base
                                      (300, 2048),     # the fp32 cap
                                      (37, 12288)])    # above both caps
def test_layernorm_kernel_matches_plain(cuda, dtype, rows, dim):
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_reference,
                                                   layernorm_route)
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
    assert layernorm_route(x, gamma, beta) == _ln_expected_route(x,
                                                                 "aligned")


def _ln_case(dev, rows, dim, dtype, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, dim, generator=g, device=dev) * 3 + 1).to(dtype)
    gamma = torch.rand(dim, generator=g, device=dev) + 0.5
    beta = torch.randn(dim, generator=g, device=dev)
    return x, gamma, beta


def _ln_misaligned(x):
    """``x`` as a contiguous view one element into a flat buffer, so its
    data pointer is not 16-byte aligned."""
    flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    flat[1:].copy_(x.reshape(-1))
    return flat[1:].view(x.shape)


def _ln_expected_route(x, pointer):
    v = 16 // x.element_size()
    dim = x.shape[1]
    held = dim % v == 0 and dim // v <= 512
    return "ring" if held and pointer == "aligned" else "generic"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pointer", ["aligned", "misaligned"])
@pytest.mark.parametrize("rows,dim", [(1, 768), (7, 768), (4099, 768),
                                      (32771, 768), (2113, 64), (9, 2048),
                                      (3, 4096), (515, 1000)])
def test_layernorm_routes_match_plain(cuda, dtype, pointer, rows, dim):
    """Each route through the launcher, picked by shape and pointer:
    aligned rows of whole packs up to the cap take the ring, a
    misaligned x or a width above the cap the generic route.  Rows fewer
    than the persistent grid's warps (1, 7), rows not a multiple of the
    ring's depth, the register caps (2,048 fp32 a lane's 16 packs; 4,096
    bf16), a width whose packs do not fill the last lane's (1,000); one
    counted launch a call."""
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference,
                                                   layernorm_route)
    x, gamma, beta = _ln_case(cuda, rows, dim, dtype)
    if pointer == "misaligned":
        x = _ln_misaligned(x)
    assert layernorm_route(x, gamma, beta) == _ln_expected_route(x, pointer)
    n0 = registry.launches("layernorm_fwd")
    got = layernorm_fwd_cuda(x, gamma, beta)
    assert registry.launches("layernorm_fwd") == n0 + 1
    want = layernorm_reference(x, gamma, beta)
    torch.cuda.synchronize()
    ok, err = _close(got, want, dtype)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["x", "gamma"])
def test_layernorm_takes_misaligned_pointers(cuda, dtype, which):
    """A contiguous ``(rows, dim)`` view one element into a flat buffer
    (x), or gamma one element into its buffer: the generic route, scalar
    loads, the same result."""
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_reference,
                                                   layernorm_route)
    from mxnet_tpu_torch.kernels.registry import dispatch
    rows, dim = 1030, 768
    x, gamma, beta = _ln_case(cuda, rows, dim, dtype)
    if which == "x":
        x = _ln_misaligned(x)
    else:
        gamma = _ln_misaligned(gamma)
    assert x.is_contiguous() and gamma.is_contiguous()
    assert layernorm_route(x, gamma, beta) == "generic"
    got = dispatch("layernorm_fwd", x, gamma, beta)
    want = layernorm_reference(x, gamma, beta)
    torch.cuda.synchronize()
    ok, err = _close(got, want, dtype)
    assert ok, err


@pytest.mark.parametrize("pointer", ["aligned", "misaligned"])
def test_layernorm_large_mean_rows_keep_the_variance(cuda, pointer):
    """fp32 rows of mean 1e4 and std 0.1, on the ring (aligned) and the
    generic route (misaligned).  The fp32 mean is good only to a few of
    its ulps (2**-10, 1% of the std) whatever the order of the sum, so
    two two-pass versions differ there by ~1e-3 of the output, not 1e-5:
    each route and the plain version are held to the fp64 truth within 8
    such ulps carried through 1/std and |gamma|, and a one-pass
    E[x^2] - E[x]^2 on the same rows must fail that bound."""
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference,
                                                   layernorm_route)
    g = torch.Generator(device=cuda).manual_seed(6)
    rows, dim = 4099, 768
    x = 1e4 + 0.1 * torch.randn(rows, dim, generator=g, device=cuda)
    gamma = torch.rand(dim, generator=g, device=cuda) + 0.5
    beta = torch.randn(dim, generator=g, device=cuda)
    if pointer == "misaligned":
        x = _ln_misaligned(x)
    assert layernorm_route(x, gamma, beta) == _ln_expected_route(x, pointer)
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    truth = (xd - mean) * inv * gamma.double() + beta.double()
    unit = (2.0 ** (mean.abs().log2().floor() - 23)) * inv \
        * gamma.double().abs()

    def units(out):
        return float(((out.double() - truth).abs() / unit).max())

    got = layernorm_fwd_cuda(x, gamma, beta)
    plain = layernorm_reference(x, gamma, beta)
    m = x.mean(-1, keepdim=True)
    one = (x - m) * torch.rsqrt((x * x).mean(-1, keepdim=True) - m * m
                                + 1e-5) * gamma + beta
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert units(got) <= 8, units(got)
    assert units(plain) <= 8, units(plain)
    assert not torch.isfinite(one).all() or units(one) > 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,dim", [(32768, 768), (1000, 100)])
def test_layernorm_replays_from_a_cuda_graph(cuda, dtype, rows, dim):
    """The launcher captured into a CUDA graph: the replay equals the
    eager call bitwise, on new input copied into the static one."""
    from mxnet_tpu_torch.kernels.layernorm import layernorm_fwd_cuda
    x, gamma, beta = _ln_case(cuda, rows, dim, dtype)
    fresh = _ln_case(cuda, rows, dim, dtype, seed=2)[0]
    layernorm_fwd_cuda(x, gamma, beta)   # eager first, as GraphOwner does
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = layernorm_fwd_cuda(x, gamma, beta)
    x.copy_(fresh)
    graph.replay()
    want = layernorm_fwd_cuda(fresh, gamma, beta)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_flash_and_layernorm_count_launches_by_dtype(cuda):
    """The flash and LayerNorm launchers count each launch under the
    dtype it ran on (``registry.launch_dtypes``), as a bf16 path reads
    them."""
    from mxnet_tpu_torch.kernels.registry import dispatch
    registry.reset_launches()
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        q, k, v, do, _m = _flash_case(cuda, 4, 64, 64, dtype)
        out, lse = dispatch("flash_attention_fwd", q, k, v, scale=0.125)
        delta = (do.float() * out.float()).sum(-1)
        dispatch("flash_attention_bwd", q, k, v, lse, do, delta,
                 scale=0.125)
        x = torch.ones(8, 768, device=cuda, dtype=dtype)
        dispatch("layernorm_fwd", x, torch.ones(768, device=cuda),
                 torch.zeros(768, device=cuda))
    want = {"bfloat16": 2, "float32": 1}
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "layernorm_fwd"):
        assert registry.launch_dtypes(name) == want, name


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
    scalars = torch.tensor((0.5, 1.0 / (1 - 0.9 ** 4),
                            1.0 / (1 - 0.999 ** 4)), device=cuda)
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
    rescale = torch.tensor([0.25], device=cuda)
    got = dispatch("lars_flat", w, gr, m, lr, wd, sign, rescale,
                   momentum=0.9, clip=clip)
    assert registry.launches("lars_flat") == c0 + 1
    want = lars_flat_reference(w, gr, m, lr, wd, sign, rescale,
                               momentum=0.9, clip=clip)
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
            lars_flat_cuda(*args, torch.ones(1, device=cuda))
    for rescale in (1.0, torch.ones(1), torch.ones(2, device=cuda)):
        with pytest.raises(MXNetError, match="per-step scalars"):
            lars_flat_cuda(w, gr, m, lr, wd, sign, rescale)


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


@pytest.mark.parametrize("which", ["lars", "lamb"])
def test_flat_update_functions_differentiate_on_the_card_as_on_the_cpu(
        cuda, which):
    """``FlatLars`` and ``FlatLamb1``: the forward launches the kernel on
    the card (its plain version on the CPU), the backward replays
    autodiff of the plain math; outputs and the gradient w.r.t. every
    input on the card equal the CPU's within 1e-5 relative."""
    from mxnet_tpu_torch.kernels import optimizer_update as ou
    n = 4099
    rng = np.random.default_rng(9)

    def arr(scale=1.0, positive=False):
        a = rng.standard_normal(n).astype(np.float32) * scale
        return np.abs(a) if positive else a

    if which == "lars":
        fn, name = ou.FlatLars, "lars_flat"
        arrays = [arr(), arr(), arr(0.1), arr(0.1, True), arr(1e-3, True),
                  np.where(rng.random(n) < 0.5, -1.0, 1.0)
                  .astype(np.float32), np.array([0.5], np.float32)]
        extra = (0.9, 1.0)
    else:
        fn, name = ou.FlatLamb1, "lamb_phase1"
        arrays = [arr(), arr(), arr(0.1), arr(0.1, True), arr(1e-3, True),
                  np.array([0.5, 10.0, 1000.0], np.float32)]
        extra = (0.9, 0.999, 1e-6, 1.0)
    weights = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    got = {}
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in arrays]
        c0 = registry.launches(name)
        outs = fn.apply(*leaves, *extra)
        loss = sum((o * torch.tensor(w, device=dev)).sum()
                   for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, leaves)
        got[str(dev)] = ([o.detach().cpu() for o in outs],
                         [g.cpu() for g in grads],
                         registry.launches(name) - c0)
    cpu, card = got["cpu"], got[str(cuda)]
    assert cpu[2] == 0 and card[2] == 1
    for what, a, b in (("out", cpu[0], card[0]), ("grad", cpu[1], card[1])):
        for i, (u, w) in enumerate(zip(a, b)):
            np.testing.assert_allclose(w.numpy(), u.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg="%s%d" % (what, i))


def test_single_process_kvstore_stays_on_the_card(cuda):
    """``pushpull`` (a list merged, then 2-bit compressed), ``push`` and
    ``pull`` on card tensors, with every host synchronization refused:
    the results stay on the card and ``out`` is written in place."""
    from mxnet_tpu_torch import NDArray, kvstore
    g = [torch.randn(1000, device=cuda) for _ in range(3)]
    out = NDArray(torch.zeros(1000, device=cuda))
    held = out._data
    kv = kvstore.create("device")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kv.pushpull(0, [NDArray(t) for t in g], out=out)
        merged = held.clone()
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(1, NDArray(g[0]))
        kv.push(1, NDArray(g[1]))
        kv.pull(1, out=out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out._data is held and held.is_cuda
    torch.testing.assert_close(merged, g[0] + g[1] + g[2])
    q = torch.where(g[1] >= 0.5, 0.5, torch.where(g[1] <= -0.5, -0.5, 0.0))
    torch.testing.assert_close(held, q)


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
        assert p.data()._data.dtype == torch.float32


# -- the imperative API on the card ------------------------------------

def test_ndarray_default_context_is_the_card(cuda):
    import mxnet_tpu_torch as mx
    assert mx.current_context() == mx.gpu(0) and mx.num_gpus() >= 1
    a = mx.nd.array([[1.0, 2.0], [3.0, 4.0]])
    z = mx.nd.zeros((2, 3))
    r = mx.nd.random.uniform(shape=(4,))
    n = mx.nd.NDArray(np.ones(3))
    for x in (a, z, r, n, a + 1, mx.nd.dot(a, a)):
        assert x._data.device == torch.device("cuda", 0)
        assert x.context == mx.gpu(0)
    with mx.cpu():
        assert mx.nd.ones((2,)).context == mx.cpu()
    assert mx.nd.ones((2,), ctx=mx.cpu()).context == mx.cpu()


def test_ndarray_as_in_context_round_trips(cuda):
    import mxnet_tpu_torch as mx
    host = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = mx.nd.array(host, ctx=mx.cpu())
    g = a.as_in_context(mx.gpu())
    assert g.context == mx.gpu(0) and g.as_in_context(mx.gpu()) is g
    back = (g * 2).as_in_context(mx.cpu())
    assert back.context == mx.cpu()
    np.testing.assert_array_equal(back.asnumpy(), host * 2)
    p = a.as_in_context(mx.cpu_pinned())
    assert p._data.is_pinned() and p.context == mx.cpu_pinned()
    np.testing.assert_array_equal(
        p.as_in_context(mx.gpu()).asnumpy(), host)


def test_waitall_and_wait_to_read(cuda):
    import mxnet_tpu_torch as mx
    a = mx.nd.ones((256, 256))
    for _ in range(5):
        a = mx.nd.dot(a, a) / 256.0
    mx.nd.waitall()
    a.wait_to_read()
    np.testing.assert_allclose(a.asnumpy(), np.ones((256, 256)), rtol=1e-5)


def test_dataloader_pin_memory_batches(cuda):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    x = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    y = np.arange(10, dtype=np.int32)
    loader = DataLoader(ArrayDataset(x, y), batch_size=4, pin_memory=True,
                        last_batch="discard")
    got = []
    for xb, yb in loader:
        assert xb._data.is_pinned() and yb._data.is_pinned()
        assert xb.context == mx.cpu_pinned()
        xg, yg = xb.as_in_context(mx.gpu()), yb.as_in_context(mx.gpu())
        assert xg._data.is_cuda and yg.dtype == np.int32
        got.append(xg.asnumpy())
    np.testing.assert_array_equal(np.concatenate(got), x[:8])


def test_ndarray_training_step_on_the_card(cuda):
    """One step of a small conv net driven with NDArrays on the card:
    the gradients ``loss.backward()`` leaves are what ``Trainer.step``
    applies, and a ``write`` gradient is overwritten by the next
    backward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, kernel_size=3, activation="relu"),
            gluon.nn.Flatten(), gluon.nn.Dense(3))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x = mx.nd.random.uniform(shape=(2, 1, 6, 6))
    y = mx.nd.array([0, 2], dtype="int32")
    for _ in range(2):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
    g = net[2].weight.grad()._data.clone()
    with autograd.record():
        loss_fn(net(x), y).backward()
    torch.testing.assert_close(net[2].weight.grad()._data, g)
    w = net[2].weight.data()._data.clone()
    gluon.Trainer(net.collect_params(), "sgd",
                  {"learning_rate": 0.1}).step(2)
    torch.testing.assert_close(net[2].weight.data()._data, w - 0.1 * g / 2)


# DenseNet-121's smallest and largest fused-site shapes at batch 64:
# (rows, C) of the head (3136, 1024), of the smallest rows with the
# fewest channels (3136, 128) and of the stem (802816, 64)
@pytest.mark.parametrize("rows,c", [(3136, 1024), (3136, 128),
                                    (802816, 64)])
def test_bn_relu_kernels_at_densenets_site_shapes(cuda, rows, c):
    from mxnet_tpu_torch.kernels.registry import dispatch
    from mxnet_tpu_torch.ops.fused_bn_relu import bn_relu_bwd_reference
    x, scale, offset, y, dy, vecs = _bn_case(cuda, rows, c, torch.float32)
    got = dispatch("bn_relu_apply", x, scale, offset)
    dx = dispatch("bn_relu_bwd", x, dy, y, *vecs)
    want_dx = bn_relu_bwd_reference(x, dy, y, *vecs)
    torch.cuda.synchronize()
    ok, err = _close(got, y, torch.float32)
    assert ok, ("fwd", err)
    ok, err = _close(dx, want_dx, torch.float32)
    assert ok, ("bwd", err)


def _nd_route(fn, ins, head):
    """``fn(*ins)`` on NDArrays under ``record``, backward under
    ``head``: the output, the inputs' gradients and the launches of the
    fused and flash kernels it made."""
    from mxnet_tpu_torch import autograd
    names = ("flash_attention_fwd", "flash_attention_bwd", "bn_relu_apply",
             "bn_relu_bwd")
    before = {n: registry.launches(n) for n in names}
    for a in ins:
        a.attach_grad()
    with autograd.record():
        out = fn(*ins)
    out = out[0] if isinstance(out, (list, tuple)) else out
    out.backward(head)
    torch.cuda.synchronize()
    launched = {n: registry.launches(n) - before[n] for n in names
                if registry.launches(n) != before[n]}
    return out.asnumpy(), [a.grad.asnumpy() for a in ins], launched


def _nd(cuda, rng, *shape):
    import mxnet_tpu_torch as mx
    return mx.nd.array(rng.standard_normal(shape).astype(np.float32),
                       ctx=mx.gpu())


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
def test_nd_flash_attention_routes_launch_the_kernels(cuda, masked):
    """``mx.nd.flash_attention`` / ``flash_attention_masked`` on CUDA
    NDArrays launch the forward and backward kernels once each and match
    the same ops on the CPU (their plain versions)."""
    import mxnet_tpu_torch as mx
    rng = np.random.default_rng(4)
    q, k, v, head = (_nd(cuda, rng, 8, 64, 32) for _ in range(4))
    mask = (rng.random((2, 64, 64)) > 0.3).astype(np.float32)
    mask[:, :, 0] = 1.0

    def fn(nd, mask_):
        if masked:
            return lambda a, b, c: nd.flash_attention_masked(
                a, b, c, mask_, heads=4)
        return lambda a, b, c: nd.flash_attention(a, b, c, causal=True)
    out, grads, launched = _nd_route(
        fn(mx.nd, mx.nd.array(mask, ctx=mx.gpu())), [q, k, v], head)
    assert launched == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    with mx.cpu():
        cpu = [mx.nd.array(a.asnumpy(), ctx=mx.cpu())
               for a in (q, k, v, head)]
        want, wgrads, none = _nd_route(
            fn(mx.nd, mx.nd.array(mask, ctx=mx.cpu())), cpu[:3], cpu[3])
    assert none == {}
    scale = max(1.0, np.abs(want).max())
    assert np.abs(out - want).max() <= FLASH_TOL[torch.float32][0] * scale
    for g, w in zip(grads, wgrads):
        assert np.abs(g - w).max() <= FLASH_TOL[torch.float32][1] * max(
            1.0, np.abs(w).max())


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_nd_fused_batch_norm_relu_route(cuda, layout):
    """``mx.nd.fused_batch_norm_relu`` on a CUDA NDArray: on the last
    axis it launches ``bn_relu_apply`` and ``bn_relu_bwd`` once each, on
    NCHW none (it is ``relu(BatchNorm)`` there, as the JAX op); both
    match the op on the CPU."""
    import mxnet_tpu_torch as mx
    rng = np.random.default_rng(5)
    shape = (4, 6, 6, 32) if layout == "NHWC" else (4, 32, 6, 6)
    axis = 3 if layout == "NHWC" else 1
    x, head = _nd(cuda, rng, *shape), _nd(cuda, rng, *shape)
    g = mx.nd.array(rng.random(32).astype(np.float32) + 0.5, ctx=mx.gpu())
    b, mm = _nd(cuda, rng, 32), _nd(cuda, rng, 32)
    mv = mx.nd.array(rng.random(32).astype(np.float32) + 0.5, ctx=mx.gpu())

    def fn(a, ga, be, mm_, mv_):
        return mx.nd.fused_batch_norm_relu(a, ga, be, mm_, mv_, axis=axis,
                                           fix_gamma=False)
    out, grads, launched = _nd_route(lambda a, ga, be: fn(a, ga, be, mm, mv),
                                     [x, g, b], head)
    want_launches = {"bn_relu_apply": 1, "bn_relu_bwd": 1} \
        if layout == "NHWC" else {}
    assert launched == want_launches
    with mx.cpu():
        cpu = [mx.nd.array(a.asnumpy(), ctx=mx.cpu())
               for a in (x, g, b, mm, mv, head)]
        want, wgrads, _ = _nd_route(
            lambda a, ga, be: fn(a, ga, be, cpu[3], cpu[4]), cpu[:3],
            cpu[5])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    for gg, w in zip(grads, wgrads):
        np.testing.assert_allclose(gg, w, rtol=1e-4, atol=1e-4)
