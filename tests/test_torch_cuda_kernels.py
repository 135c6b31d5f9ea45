"""The port's CUDA kernels on an NVIDIA GPU: each against its plain
PyTorch version, the wrappers' input checks, and the decode engine and
a ResNet training step through the kernels.  Every test here needs the
card and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances: paged attention 1e-4 with fp32 caches (fp32 sums in another
order), 2e-2 with bf16 caches or a bf16 query (bf16 rounding of the
output).  Fused BN+ReLU, relative to the largest output: 1e-5 in fp32
(FMA contraction), 1e-2 in bf16 (one rounding step of the stored
value)."""
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
