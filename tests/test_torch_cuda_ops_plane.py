"""The ops plane on an NVIDIA GPU: each hand kernel's launch, walked by
``mx.profiling``, is charged its bound formula's operations and bytes
once (the launch is invisible to the dispatcher; the registry charges
it at ``count_launch``); a walked ``TrainStep`` warm-up names the fused
kernels with their launches; and ``mx.profiler`` over a replayed CUDA
graph names the kernel inside the graph.  Every test here needs the
card and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_ops_plane.py
"""
import json

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _randn(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _charged(fn):
    from mxnet_tpu_torch.profiling import aten
    with aten.Walk() as walk:
        fn()
    torch.cuda.synchronize()
    return walk.kernels()


def _cases():
    """(kernel, launch thunk, (flops, bytes) by the bound formulas)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import layernorm, optimizer_update as ou
    from mxnet_tpu_torch.ops import fused_bn_relu as fb
    from mxnet_tpu_torch.ops.paged_attention import paged_attention_cuda
    out = []
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        rows, c = 3136, 64
        x, dy = _randn(rows, c, dtype=dtype), _randn(rows, c, dtype=dtype,
                                                    seed=1)
        v = [_randn(c, seed=s) for s in range(2, 7)]
        y = fb.bn_relu_apply_cuda(x, v[0], v[1])
        out.append(("bn_relu_apply",
                    lambda x=x, v=v: fb.bn_relu_apply_cuda(x, v[0], v[1]),
                    (3 * rows * c, 2 * rows * c * size + 4 * 2 * c)))
        out.append(("bn_relu_bwd",
                    lambda x=x, dy=dy, y=y, v=v: fb.bn_relu_bwd_cuda(
                        x, dy, y, *v),
                    (8 * rows * c, 4 * rows * c * size + 4 * 5 * c)))
        n = 10000
        w, g, m = (_randn(n, dtype=dtype, seed=s) for s in (7, 8, 9))
        lr, wd = torch.full((n,), 0.1, device="cuda"), \
            torch.full((n,), 1e-4, device="cuda")
        sign = torch.ones(n, device="cuda")
        rescale = torch.ones(1, device="cuda")
        out.append(("lars_flat",
                    lambda w=w, g=g, m=m, lr=lr, wd=wd, sign=sign,
                    rescale=rescale: ou.lars_flat_cuda(w, g, m, lr, wd,
                                                       sign, rescale),
                    (8 * n, n * (5 * size + 12) + 4)))
        bh, seq, d = 24, 128, 64
        q, k, vv = (_randn(bh, seq, d, dtype=dtype, seed=s)
                    for s in (10, 11, 12))
        nq = bh * seq * d * size
        out.append(("flash_attention_fwd",
                    lambda q=q, k=k, vv=vv: fa.flash_attention_fwd_cuda(
                        q, k, vv, scale=0.125),
                    (4 * bh * seq * seq * d, 4 * nq + 4 * bh * seq)))
        o, lse = fa.flash_attention_fwd_cuda(q, k, vv, scale=0.125)
        do = _randn(bh, seq, d, dtype=dtype, seed=13)
        delta = (do.float() * o.float()).sum(-1)
        out.append(("flash_attention_bwd",
                    lambda q=q, k=k, vv=vv, lse=lse, do=do, delta=delta:
                    fa.flash_attention_bwd_cuda(q, k, vv, lse, do, delta,
                                                scale=0.125),
                    (10 * bh * seq * seq * d, 7 * nq + 8 * bh * seq)))
        rows, dim = 512, 768
        xl = _randn(rows, dim, dtype=dtype, seed=14)
        gam, bet = _randn(dim, seed=15), _randn(dim, seed=16)
        out.append(("layernorm_fwd",
                    lambda xl=xl, gam=gam, bet=bet:
                    layernorm.layernorm_fwd_cuda(xl, gam, bet),
                    (8 * rows * dim, 2 * rows * dim * size + 2 * dim * 4)))
    n = 10000
    w, g, m, v2 = (_randn(n, seed=s) for s in (17, 18, 19, 20))
    v2 = v2.abs()
    wd = torch.full((n,), 0.01, device="cuda")
    sc = torch.tensor([1.0, 0.9, 0.99], device="cuda")
    out.append(("lamb_phase1",
                lambda: ou.lamb_phase1_cuda(w, g, m, v2, wd, sc),
                (12 * n, 8 * n * 4 + 12)))
    slots, nb, bs, heads, d = 3, 16, 16, 12, 64
    ctx = [5, 40, 152]
    tables = torch.zeros(slots, 10, dtype=torch.int32, device="cuda")
    for i, cl in enumerate(ctx):
        for b in range(-(-cl // bs)):
            tables[i, b] = 1 + (i * 5 + b) % (nb - 1)
    qp = _randn(slots, heads, d, seed=21)
    kc, vc = _randn(nb, bs, heads, d, seed=22), _randn(nb, bs, heads, d,
                                                       seed=23)
    cl_t = torch.tensor(ctx, dtype=torch.int32, device="cuda").reshape(-1, 1)
    live = sum(ctx)
    out.append(("paged_attention",
                lambda: paged_attention_cuda(qp, kc, vc, tables, cl_t,
                                             scale=0.125),
                (4 * live * heads * d,
                 2 * qp.numel() * 4 + 4 * slots
                 + 4 * sum(-(-cl // bs) for cl in ctx)
                 + 2 * live * heads * d * 4)))
    return out


def test_each_kernel_is_charged_its_bound_formula(card):
    from mxnet_tpu_torch.kernels import registry
    cases = _cases()
    assert {name for name, _fn, _c in cases} == set(registry.list_kernels())
    for name, fn, (flops, nbytes) in cases:
        before = registry.launches(name)
        got = _charged(fn)
        assert registry.launches(name) == before + 1, name
        assert list(got) == [name], (name, got)
        assert (got[name]["flops"], got[name]["bytes"]) == (flops, nbytes), \
            name
        assert got[name]["launches"] == 1 == got[name]["calls"], name


def _narrow_resnet():
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, thumbnail=True, layout="NHWC")
    net.initialize(device="cuda", generator=torch.Generator().manual_seed(0))
    return net


def test_walked_train_step_names_the_fused_kernels(card):
    from mxnet_tpu_torch import gluon, parallel, profiling
    from mxnet_tpu_torch.kernels import registry
    net = _narrow_resnet()
    tr = gluon.Trainer(net.collect_params(), "lars",
                       {"learning_rate": 0.1, "momentum": 0.9})
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x, y = _randn(8, 32, 32, 3), torch.randint(0, 10, (8,),
                                               device="cuda").float()
    from mxnet_tpu_torch import autograd
    with autograd.pause():          # deferred shapes, outside the count
        net(x[:1])
    profiling.reset()
    profiling.enable()
    try:
        registry.reset_launches()
        step(x, y)                  # the walked eager warm-up
        warm = {n: registry.launches(n)
                for n in ("bn_relu_apply", "bn_relu_bwd", "lars_flat")}
        step(x, y)                  # capture and first replay
        torch.cuda.synchronize()
        rep = profiling.reports()[0]
    finally:
        profiling.disable()
        profiling.reset()
    prov = {p["op_name"]: p for p in rep["provenance"] if p.get("kernel")}
    for name, n in warm.items():
        assert n > 0 and prov[name]["launches"] == n, (name, n, prov)
    assert rep["backend"] == "cuda"
    assert rep["device"] == torch.cuda.get_device_name(0)
    assert sum(c["flops"] for c in rep["categories"].values()) == \
        rep["totals"]["flops"]
    assert rep["memory"]["peak_hbm_bytes"] >= \
        rep["memory"]["argument_bytes"]


def test_profiler_trace_names_the_kernel_inside_a_replayed_graph(
        card, tmp_path):
    from mxnet_tpu_torch import autograd, profiler
    net = _narrow_resnet()
    net.hybridize()
    x = _randn(4, 32, 32, 3)
    with autograd.pause():
        for _ in range(2):          # eager, then captured
            net(x)
        torch.cuda.synchronize()
        profiler.set_config(filename=str(tmp_path / "trace.json"))
        profiler.set_state("run")
        for _ in range(3):
            net(x)
        torch.cuda.synchronize()
        path = profiler.dump()
    names = [e.get("name", "") for e in json.load(open(path))["traceEvents"]]
    assert any("bn_relu_fwd_kernel" in n for n in names), \
        sorted(set(names))[:40]
    assert "mx.cachedop:ResNetV1" in names
    rows = profiler.kernel_rows()
    assert any("bn_relu_fwd_kernel" in r["name"] for r in rows)
