#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build every CUDA kernel of ``mxnet_tpu_torch/csrc`` with ``nvcc``;
2. the decode path: ``ModelRegistry.register_generative`` a decoder at
   GPT-2 small's published widths (vocab 50257, 768 units, 12 layers,
   12 heads, 1024 positions; random weights from seed 0), then eight
   concurrent ``generate`` calls, two of them joining the running
   batch.  The launch counters are zeroed just before and read just
   after.  Every stream is held against the model's own full-forward
   oracle on the card; the counter must show that every decode step of
   every layer went through the kernel, and the KV cache must be empty
   after the drain.  Then one decode step is profiled to show where its
   time goes;
3. the training path: ``resnet50_v1(layout="NHWC")`` at full width,
   fp32, batch 128 of 224x224 synthetic images (seed 0), SGD (lr 0.05,
   momentum 0.9) through ``gluon.Trainer`` and ``parallel.TrainStep``:
   one warm-up step, the counters zeroed, eight steps, the counters
   read.  The loss must be finite and fall, and every BatchNorm+ReLU
   site of every step must have launched the fused forward and backward
   kernels.  Then one step is profiled;
4. the training oracle: the same net and weights take one ``TrainStep``
   at batch 8 on the card (kernels) and one on the CPU (plain
   versions); loss, every parameter's update and every running
   statistic must agree;
5. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it, and time kernel, plain version and a library
   call computing the same function.

The last two lines of standard output are a JSON object of per-kernel
numbers and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside tensor cores
TIE_TOL = 1e-3                     # near-tie: oracle top-2 logit gap below
GPT2_SMALL = dict(vocab_size=50257, units=768, num_layers=12, num_heads=12,
                  max_seq=1024)
BN_RELU_SITES = 33                 # fused sites per ResNet-50 v1 forward
TRAIN_STEPS = 8
# card-vs-CPU limits of the one-step training oracle.  One ResNet-50
# step at batch 8 moves updates by ~1% in fp32 under a mere change of
# summation order (the oracle prints that floor); a fault of plumbing
# (a stride, a mask, a stream) moves them by O(1)
ORACLE_LIMITS = {"loss_rel_err": 1e-5, "running_stat_rel_err": 1e-4,
                 "update_rel_err": 2e-2, "update_rel_err_worst": 5e-2,
                 "conv_bias_abs_err": 1e-5}
# NHWC shapes of the fused sites the kernel phase runs: the stem and a
# stage-4 site of ResNet-50 at batch 128
BN_SHAPES = ((128, 112, 112, 64), (128, 7, 7, 512))
BN_EPS = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=50, flush_bytes=128 << 20):
    """Median milliseconds of ``fn()`` with the L2 cache flushed before
    each call (the decode step finds the cache cold: each layer's slab
    was last touched one step ago)."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ---------------------------------------------------------------------
# phase 5: paged_attention against its plain version
# ---------------------------------------------------------------------

def paged_attention_inputs(kv_dtype, seed=0):
    """The decode step's shapes at GPT-2 small width with the default
    cache (512 blocks of 16): 8 slots, contexts over the edge cases."""
    import torch
    rng = np.random.default_rng(seed)
    slots, heads, d, nb, bs, max_seq = 8, 12, 64, 512, 16, 1024
    mb = max_seq // bs
    ctx = np.array([0, 1, 15, 16, 17, 333, 1000, 1024], np.int32)
    tables = np.zeros((slots, mb), np.int32)
    pool = rng.permutation(np.arange(1, nb)).astype(np.int32)
    used = 0
    for i, c in enumerate(ctx):
        n = -(-int(c) // bs)
        tables[i, :n] = pool[used:used + n]
        used += n
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((slots, heads, d),
                                             np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((nb, bs, heads, d),
                                             np.float32)).to(dev, kv_dtype)
    v = torch.from_numpy(rng.standard_normal((nb, bs, heads, d),
                                             np.float32)).to(dev, kv_dtype)
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx.reshape(slots, 1)).to(dev))


def paged_attention_bound(q, k, tables, ctx):
    """Least time for the function: every byte it must move once (q,
    out, the live table entries and context lengths, the live K/V rows)
    over the memory rate, against its flops over the fp32 rate."""
    bs, heads, d = k.shape[1], k.shape[2], k.shape[3]
    lens = ctx.flatten().tolist()
    live = sum(lens)
    nbytes = (2 * q.numel() * q.element_size() + 4 * len(lens)
              + 4 * sum(-(-c // bs) for c in lens)
              + 2 * live * heads * d * k.element_size())
    flops = 4 * live * heads * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kernel_phase(scale):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    result = {}
    for name, kv_dtype, atol in (("float32", torch.float32, 1e-4),
                                 ("bfloat16", torch.bfloat16, 2e-2)):
        q, k, v, bt, ctx = paged_attention_inputs(kv_dtype)
        got = paged_attention_cuda(q, k, v, bt, ctx, scale=scale)
        want = paged_attention_reference(q, k, v, bt, ctx, scale=scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()),
              "paged_attention (%s cache): non-finite output" % name)
        per_slot = (got - want).abs().amax(dim=(1, 2)).tolist()
        check(err <= atol, "paged_attention (%s cache): max |kernel - "
              "plain| = %g > atol %g (per slot %s, contexts %s)"
              % (name, err, atol, per_slot, ctx.flatten().tolist()))
        check(float(got[0].abs().max()) == 0.0,
              "paged_attention: ctx 0 must give zeros")
        print("paged_attention %s cache: max_abs_err %.3g (atol %g)"
              % (name, err, atol))
        result[name] = err
    # times at the main path's cache dtype (float32)
    q, k, v, bt, ctx = paged_attention_inputs(torch.float32)
    slots, heads, d = q.shape
    mb, bs = bt.shape[1], k.shape[1]
    kg = k[bt.long()].reshape(slots, mb * bs, heads, d).transpose(1, 2)
    vg = v[bt.long()].reshape(slots, mb * bs, heads, d).transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    mask = (torch.arange(mb * bs, device="cuda")[None]
            < ctx.reshape(slots, 1))[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = time_ms(lambda: paged_attention_cuda(q, k, v, bt, ctx, scale=scale))
    plain_ms = time_ms(
        lambda: paged_attention_reference(q, k, v, bt, ctx, scale=scale))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, scale=scale))
    bound_ms, bound_by, nbytes = paged_attention_bound(q, k, bt, ctx)
    print("paged_attention times (float32 cache): kernel_ms %.5f "
          "plain_ms %.5f library_ms %.5f (SDPA over pre-gathered K/V) "
          "bound %.3f us (%d bytes at 3.35 TB/s)"
          % (ms, plain_ms, library_ms, 1e3 * bound_ms, nbytes))
    return {"max_abs_err": result["float32"],
            "max_abs_err_bf16": result["bfloat16"], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------
# phase 2: the decode path
# ---------------------------------------------------------------------

def oracle_check(model, params, prompt, tokens, ref):
    """Hold an engine stream against the full-forward oracle.  Tokens
    must agree, except at a step where the oracle's top-2 logit gap is
    under TIE_TOL; from such a near-tie on, each step is checked by
    teacher forcing on the engine's own tokens.  Returns the number of
    near-ties where the two took different tokens."""
    import torch
    check(len(tokens) == len(ref),
          "stream length %d != oracle %d" % (len(tokens), len(ref)))
    if tokens == ref:
        return 0
    seq = torch.tensor([list(prompt) + tokens[:-1]],
                       device=params["embed"].device)
    logits = model.full_logits(params, seq)[0, len(prompt) - 1:]
    check(bool(torch.isfinite(logits).all()), "oracle logits not finite")
    ties = 0
    for i, tok in enumerate(tokens):
        row = logits[i]
        best = int(row.argmax())
        if tok == best:
            continue
        gap = float(row[best] - row[tok])
        check(gap < TIE_TOL, "step %d: engine token %d, oracle %d, logit "
              "gap %.3g >= %g" % (i, tok, best, gap, TIE_TOL))
        ties += 1
    return ties


def decode_step_breakdown(engine, ctx_len=152, iters=20):
    """Where one decode step's time goes at the main path's widest
    shape (8 slots, each at context ``ctx_len``): host wall time per
    step, device busy time per step from ``torch.profiler``, the
    paged_attention kernel's share, and the top device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    slots = engine.decode_buckets[-1]
    tables = [engine.cache.allocate(ctx_len) for _ in range(slots)]
    try:
        bt = np.stack([engine.cache.padded_table(
            t, engine.max_blocks_per_seq) for t in tables])
        tokens = np.zeros((slots,), np.int32)
        positions = np.full((slots,), ctx_len - 1, np.int32)

        def step():
            engine._run_decode(tokens, positions, bt)

        for _ in range(3):
            step()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
    finally:
        for t in tables:
            engine.cache.free(t)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time")
    busy_us = sum(e.self_device_time_total for e in kernels) / iters
    attn_us = sum(e.self_device_time_total for e in kernels
                  if "paged_attention_kernel" in e.key) / iters
    check(attn_us > 0, "the profiler saw no paged_attention kernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"slots": slots, "context": ctx_len, "step_wall_ms": wall_ms,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": max(0.0, 1 - busy_us / 1e3 / wall_ms),
           "paged_attention_ms": attn_us / 1e3,
           "top_kernels": [[e.key[:60], e.self_device_time_total / iters
                            / 1e3, e.count // iters] for e in top]}
    print("decode step breakdown: %s" % json.dumps(out))
    return out


def main_path(widths=GPT2_SMALL, device="cuda"):
    import torch
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import ModelRegistry
    from mxnet_tpu_torch.serving.decode import tiny_gpt

    model = tiny_gpt(**widths)
    params = model.init_params(seed=0, device=device)
    rng = np.random.default_rng(0)
    lengths = [5, 21, 37, 54, 70, 87, 103, 120]
    prompts = [rng.integers(0, model.vocab_size, n).tolist()
               for n in lengths]
    max_new = 32
    late = {6, 7}                  # these join the running batch

    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    sv = reg.register_generative("gpt2s", model, params=params,
                                 device=device)
    warm_s = time.perf_counter() - t0

    results = [None] * len(prompts)
    arrivals = [[] for _ in prompts]
    errors = []
    started = threading.Event()

    def client(i):
        try:
            if i in late:
                check(started.wait(120), "first stream never started")
            stream = reg.generate("gpt2s", prompts[i], max_new)
            toks = []
            for tok in stream:
                toks.append(tok)
                arrivals[i].append(time.perf_counter())
                if i == 0 and len(toks) == 4:
                    started.set()
            results[i] = (stream, toks)
        except BaseException as e:     # reported by the main thread
            errors.append((i, e))
            started.set()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    t_end = time.perf_counter()
    check(not any(t.is_alive() for t in threads), "a client hung")
    check(not errors, "client errors: %r" % (errors,))
    in_use = sv.kvcache_stats()["blocks_in_use"]
    steps = sv.engine.decode_steps
    reg.shutdown(drain=True)
    launches = registry.launches("paged_attention")
    peak = torch.cuda.max_memory_allocated()

    check(in_use == 0, "%d KV blocks still in use after the drain" % in_use)
    check(launches > 0, "paged_attention kernel never launched")
    check(launches == model.num_layers * steps,
          "paged_attention launches %d != %d layers x %d decode steps"
          % (launches, model.num_layers, steps))
    # a late stream joined while an early one was still generating
    first_done = min(arrivals[i][-1] for i in range(len(prompts))
                     if i not in late)
    check(all(results[i][0].t_submit < first_done for i in late),
          "no stream joined mid-batch")

    ties = 0
    for i, (stream, toks) in enumerate(results):
        check(stream.finish_reason == "length" and len(toks) == max_new,
              "stream %d ended %r after %d tokens"
              % (i, stream.finish_reason, len(toks)))
        check(all(0 <= t < model.vocab_size for t in toks),
              "stream %d: token out of vocabulary" % i)
        ref = model.reference_decode(params, prompts[i], max_new)
        ties += oracle_check(model, params, prompts[i], toks, ref)

    n_tok = sum(len(t) for _s, t in results)
    ttft = [s.ttft_s for s, _t in results]
    gaps = [b - a for arr in arrivals for a, b in zip(arr, arr[1:])]
    stats = {"tokens": n_tok, "tokens_per_s": n_tok / (t_end - t_start),
             "ttft_p50_ms": 1e3 * float(np.median(ttft)),
             "inter_token_p50_ms": 1e3 * float(np.median(gaps)),
             "warmup_s": warm_s, "decode_steps": steps,
             "paged_attention_launches": launches,
             "near_ties": ties, "near_tie_tol": TIE_TOL,
             "peak_mem_bytes": peak}
    print("main path (GPT-2 small widths, 8 streams x %d tokens): %s"
          % (max_new, json.dumps(stats)))
    if device == "cuda":
        decode_step_breakdown(sv.engine)
    return stats, model.scale


# ---------------------------------------------------------------------
# phase 3: the training path
# ---------------------------------------------------------------------

def resnet50_nhwc():
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    return resnet50_v1(layout="NHWC")


def make_train_step(net):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)


def train_main_path(make_net=resnet50_nhwc, batch=128, image=224,
                    steps=TRAIN_STEPS, sites=BN_RELU_SITES, device="cuda"):
    """Train ``make_net()`` for ``steps`` SGD steps on one repeated
    synthetic batch after one warm-up step; the launch counters are
    zeroed after the warm-up and read after the last step."""
    import torch
    from mxnet_tpu_torch.kernels import registry
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    step = make_train_step(net)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, image, image, 3), generator=gen, device=device)
    y = torch.randint(0, net.output._units, (batch,), generator=gen,
                      device=device).float()
    cuda = device == "cuda"
    t0 = time.perf_counter()
    step(x, y)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    warm_s = time.perf_counter() - t0

    registry.reset_launches()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(steps)]
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = registry.launches("bn_relu_apply")
    bwd = registry.launches("bn_relu_bwd")
    losses = [float(v) for v in losses]

    check(all(np.isfinite(losses)), "non-finite training loss: %s" % losses)
    check(losses[-1] < losses[0], "training loss did not fall: %s"
          % losses)
    check(fwd == sites * steps, "bn_relu_apply launches %d != %d sites x "
          "%d steps" % (fwd, sites, steps))
    check(bwd == sites * steps, "bn_relu_bwd launches %d != %d sites x "
          "%d steps" % (bwd, sites, steps))
    stats = {"batch": batch, "image": image, "steps": steps,
             "losses": losses, "ms_per_step": 1e3 * wall / steps,
             "img_per_s": batch * steps / wall, "warmup_s": warm_s,
             "bn_relu_apply_launches": fwd, "bn_relu_bwd_launches": bwd,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "card": gpu_line() if cuda else None}
    print("training main path (ResNet-50 v1 NHWC fp32, SGD 0.05/0.9): %s"
          % json.dumps(stats))
    return net, step, (x, y), stats


KERNEL_CATEGORIES = (
    ("bn_relu", ("bn_relu_fwd_kernel", "bn_relu_bwd_kernel")),
    ("layout_transform", ("nhwctonchw", "nchwtonhwc")),
    ("convolution", ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm")),
    ("copy", ("copy",)),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "gemv")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def kernel_category(name):
    low = name.lower()
    for cat, marks in KERNEL_CATEGORIES:
        if any(m in low for m in marks):
            return cat
    return "other"


def train_step_breakdown(step, x, y, step_ms):
    """Where one training step's time goes: device busy time from
    ``torch.profiler``, by kernel category (ms and launches) and by the
    operator that launched it, the fused kernels' share, the top device
    kernels, and every copy kernel, cuDNN's own NHWC/NCHW layout
    transforms included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time")

    def ms(es):
        return sum(e.self_device_time_total for e in es) / 1e3

    busy = ms(kernels)
    fwd = [e for e in kernels if "bn_relu_fwd_kernel" in e.key]
    bwd = [e for e in kernels if "bn_relu_bwd_kernel" in e.key]
    check(fwd and bwd, "the profiler saw no fused BN+ReLU kernel")
    copies = [e for e in kernels
              if kernel_category(e.key) in ("copy", "layout_transform")]
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    top = ranked[:12]
    other = [e for e in ranked if kernel_category(e.key) == "other"][:6]
    # the same device time by the host-side op that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    by_cat = {}
    for e in kernels:
        cat = kernel_category(e.key)
        ms_, n_ = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms_ + e.self_device_time_total / 1e3, n_ + e.count)
    out = {"step_ms": step_ms, "device_busy_ms": busy,
           "by_category": {k: [v[0], v[1]] for k, v in sorted(
               by_cat.items(), key=lambda kv: -kv[1][0])},
           "device_idle_share": max(0.0, 1 - busy / step_ms),
           "bn_relu_fwd_ms": ms(fwd), "bn_relu_bwd_ms": ms(bwd),
           "bn_relu_share": (ms(fwd) + ms(bwd)) / busy,
           "copy_ms": ms(copies),
           "copy_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in copies],
           "top_kernels": [[e.key[:72], e.self_device_time_total / 1e3,
                            e.count] for e in top],
           "top_other_kernels": [[e.key[:72],
                                  e.self_device_time_total / 1e3, e.count]
                                 for e in other],
           "top_ops": [[e.key[:48], e.self_device_time_total / 1e3,
                        e.count] for e in ops]}
    print("training step breakdown: %s" % json.dumps(out))
    return out


def oracle_step(net, x, y):
    """One ``TrainStep`` of ``net`` from a fresh trainer: ``(loss,
    {name: w' - w}, {name: running statistic after}, params)``, names
    relative to the net's prefix."""
    params = {p.name[len(net.prefix):]: p
              for p in net.collect_params().values()}
    before = {k: p.data().detach().cpu().double()
              for k, p in params.items()}
    loss = float(make_train_step(net)(x, y))
    after = {k: p.data().detach().cpu().double() for k, p in params.items()}
    updates = {k: after[k] - before[k] for k, p in params.items()
               if p.grad_req != "null"}
    stats = {k: after[k] for k, p in params.items() if p.grad_req == "null"}
    return loss, updates, stats


def _is_conv_bias(name):
    return "conv" in name and name.endswith("bias")


def update_errors(ua, ub):
    """Norm-wise relative error of updates ``ua`` against ``ub``: over
    all of them together, and the worst single parameter.  Conv biases
    are left out: each feeds a BatchNorm, whose batch mean cancels it,
    so its exact gradient is 0 and its update is rounding noise."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for k, b in ub.items():
        if _is_conv_bias(k):
            continue
        d = float((ua[k] - b).norm())
        n = float(b.norm())
        num, den = num + d * d, den + n * n
        if n > 0 and d / n > worst:
            worst, worst_name = d / n, k
    return (num / den) ** 0.5, worst, worst_name


def train_oracle(net, make_net=resnet50_nhwc, batch=8, image=224):
    """One ``TrainStep`` of ``net`` (on the card: the kernels) and of a
    CPU copy with the same weights (the plain versions), on the same
    batch.  A third step, on the CPU with the batch permuted, computes
    the same function in another fp32 summation order: its distance
    from the CPU step is the noise floor the card is read against."""
    import torch
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    arrays = {p.name: p.data().detach().cpu().numpy()
              for p in net.collect_params().values()}

    def cpu_copy():
        n = make_net()
        n.initialize(device="cpu")
        params_from_numpy(n, arrays, prefix=net.prefix)
        return n

    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    y = rng.integers(0, net.output._units, batch).astype(np.float32)
    perm = rng.permutation(batch)
    nets = {"cpu": cpu_copy(), "cpu_permuted": cpu_copy()}
    l_cpu, u_cpu, s_cpu = oracle_step(nets["cpu"], x, y)
    l_perm, u_perm, _ = oracle_step(nets["cpu_permuted"], x[perm], y[perm])
    l_card, u_card, s_card = oracle_step(net, x, y)
    glob, worst, worst_name = update_errors(u_card, u_cpu)
    floor, floor_worst, _ = update_errors(u_perm, u_cpu)
    stat_err = max(float((s_card[k] - s_cpu[k]).norm() / s_cpu[k].norm())
                   for k in s_cpu)
    bias_err = max(float((u_card[k] - u_cpu[k]).abs().max())
                   for k in u_cpu if _is_conv_bias(k))
    out = {"batch": batch, "loss_card": l_card, "loss_cpu": l_cpu,
           "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
           "update_rel_err": glob, "update_rel_err_worst": worst,
           "update_worst_param": worst_name,
           "floor_update_rel_err": floor,
           "floor_update_rel_err_worst": floor_worst,
           "floor_loss_rel_err": abs(l_perm - l_cpu) / abs(l_cpu),
           "running_stat_rel_err": stat_err, "conv_bias_abs_err": bias_err,
           "limits": ORACLE_LIMITS}
    print("training oracle (card vs CPU): %s" % json.dumps(out))
    check(np.isfinite(l_card), "oracle loss on the card is not finite")
    for key, limit in ORACLE_LIMITS.items():
        check(out[key] <= limit, "training oracle: %s %.3g > limit %g"
              % (key, out[key], limit))
    return out


# ---------------------------------------------------------------------
# phase 5: fused BN+ReLU kernels against their plain versions
# ---------------------------------------------------------------------

def bn_relu_inputs(shape, dtype, seed=0):
    """One fused site's tensors at NHWC ``shape``: the activation (as
    ``(rows, C)``), the folded forward vectors, the forward output, a
    cotangent and the backward vectors."""
    import torch
    from mxnet_tpu_torch.ops.fused_bn_relu import bn_relu_apply_reference
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    rows = int(np.prod(shape[:-1]))

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    x = (randn(rows, c) * 2 + 1).to(dtype)
    gamma = torch.rand(c, generator=gen, device="cuda") + 0.5
    beta = randn(c)
    mean = randn(c) * 0.5 + 1
    var = torch.rand(c, generator=gen, device="cuda") + 3.5
    inv = torch.rsqrt(var + BN_EPS)
    scale = gamma * inv
    offset = beta - mean * scale
    y = bn_relu_apply_reference(x, scale, offset)
    dy = randn(rows, c).to(dtype)
    return {"x": x, "scale": scale, "offset": offset, "y": y, "dy": dy,
            "gamma": gamma, "beta": beta, "mean": mean, "var": var,
            "bwd": (gamma * inv, mean, inv, randn(c) * 0.1,
                    randn(c) * 0.1)}


def bn_relu_bound(rows, c, itemsize, passes, vectors, flops):
    """Least time: ``passes`` activation-sized reads and writes plus the
    fp32 (C,) vectors, over the memory rate; against ``flops`` an
    element over the fp32 rate."""
    nbytes = passes * rows * c * itemsize + 4 * vectors * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops * rows * c / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def bn_relu_kernel_phase():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.fused_bn_relu import (
        bn_relu_apply_cuda, bn_relu_apply_reference, bn_relu_bwd_cuda,
        bn_relu_bwd_reference)
    # tolerance relative to the largest output: fp32 differs by FMA
    # contraction; bf16 by one rounding step of the stored result
    rtol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    errs = {"fwd": {}, "bwd": {}}
    for shape in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = bn_relu_inputs(shape, dtype)
            pairs = {
                "fwd": (bn_relu_apply_cuda(t["x"], t["scale"], t["offset"]),
                        t["y"]),
                "bwd": (bn_relu_bwd_cuda(t["x"], t["dy"], t["y"], *t["bwd"]),
                        bn_relu_bwd_reference(t["x"], t["dy"], t["y"],
                                              *t["bwd"]))}
            torch.cuda.synchronize()
            for kind, (got, want) in pairs.items():
                check(bool(torch.isfinite(got.float()).all()),
                      "bn_relu %s %s %s: non-finite" % (kind, shape, dtype))
                err = float((got.float() - want.float()).abs().max())
                limit = rtol[dtype] * max(1.0, float(want.float().abs()
                                                     .max()))
                check(err <= limit, "bn_relu %s %s %s: max |kernel - "
                      "plain| %.3g > %.3g" % (kind, shape, dtype, err,
                                              limit))
                key = str(dtype).split(".")[-1]
                errs[kind][key] = max(errs[kind].get(key, 0.0), err)
                print("bn_relu %s %s %s: max_abs_err %.3g (limit %.3g)"
                      % (kind, shape, key, err, limit))
            del t, pairs

    times = {}
    for shape in BN_SHAPES:
        n, c = shape[0], shape[-1]
        rows = int(np.prod(shape[:-1]))
        t = bn_relu_inputs(shape, torch.float32)
        x, y, dy = t["x"], t["y"], t["dy"]
        # the same tensors as NCHW views over channels-last memory
        x4, y4, dy4 = (v.view(shape).permute(0, 3, 1, 2)
                       for v in (x, y, dy))
        inv = t["bwd"][2]

        def lib_fwd():
            out = F.batch_norm(x4, t["mean"], t["var"], t["gamma"],
                               t["beta"], False, 0.0, BN_EPS)
            return out.relu_()

        def lib_bwd():
            g = torch.ops.aten.threshold_backward(dy4, y4, 0)
            return torch.ops.aten.native_batch_norm_backward(
                g, x4, t["gamma"], None, None, t["mean"], inv, True,
                BN_EPS, [True, True, True])

        fwd = {"ms": time_ms(lambda: bn_relu_apply_cuda(x, t["scale"],
                                                         t["offset"])),
               "plain_ms": time_ms(lambda: bn_relu_apply_reference(
                   x, t["scale"], t["offset"])),
               "library_ms": time_ms(lib_fwd)}
        bwd = {"ms": time_ms(lambda: bn_relu_bwd_cuda(x, dy, y, *t["bwd"])),
               "plain_ms": time_ms(lambda: bn_relu_bwd_reference(
                   x, dy, y, *t["bwd"])),
               "library_ms": time_ms(lib_bwd)}
        # forward: x read, out written, 2 vectors, fma + max;
        # backward: x, dy, y read, dx written, 5 vectors, ~8 flops
        fwd["bound_ms"], fwd["bound_by"], fb = bn_relu_bound(rows, c, 4, 2,
                                                             2, 3)
        bwd["bound_ms"], bwd["bound_by"], bb = bn_relu_bound(rows, c, 4, 4,
                                                             5, 8)
        times[shape] = {"fwd": fwd, "bwd": bwd}
        print("bn_relu times %s fp32 (batch %d): fwd %s (%d bytes at "
              "3.35 TB/s); bwd %s (%d bytes); library fwd = "
              "batch_norm(eval)+relu_, bwd = threshold_backward + "
              "native_batch_norm_backward"
              % (shape, n, json.dumps(fwd), fb, json.dumps(bwd), bb))
        del t, x4, y4, dy4
    main = times[BN_SHAPES[0]]
    return {kind: dict(main[kind], max_abs_err=errs[kind]["float32"],
                       max_abs_err_bf16=errs[kind]["bfloat16"])
            for kind in ("fwd", "bwd")}


def kernel_entry(name, launches, kern):
    """One kernel's entry of the per-kernel JSON line."""
    from mxnet_tpu_torch.kernels import registry
    spec = registry.get(name)
    return {"name": spec.name, "route": "cuda",
            "source": "mxnet_tpu_torch/" + spec.source,
            "replaces": spec.replaces.split()[0], "launches": launches,
            "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import _build
    print(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    print("built %s in %.1f s" % (", ".join(sorted(libs)),
                                  time.perf_counter() - t0))
    decode, scale = main_path()
    net, step, (x, y), train = train_main_path()
    train_step_breakdown(step, x, y, train["ms_per_step"])
    del step, x, y
    train_oracle(net)
    del net
    torch.cuda.empty_cache()
    attn = kernel_phase(scale)
    bn = bn_relu_kernel_phase()
    print(json.dumps({"kernels": [
        kernel_entry("paged_attention", decode["paged_attention_launches"],
                     attn),
        kernel_entry("bn_relu_apply", train["bn_relu_apply_launches"],
                     bn["fwd"]),
        kernel_entry("bn_relu_bwd", train["bn_relu_bwd_launches"],
                     bn["bwd"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAIL: %s" % e, file=sys.stderr)
        sys.exit(1)
