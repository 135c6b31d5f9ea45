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
5. the BERT pretraining path: ``bert_base`` at its published widths
   (vocab 30522, 768 units, 12 layers, 12 heads, 512 positions),
   dropout 0.1, fp32, batch 32 x seq 512 of synthetic token ids and
   labels (seed 0), masked-LM loss, LAMB (lr 1e-4, wd 0.01) through
   ``gluon.Trainer`` and ``parallel.TrainStep``: one warm-up step, the
   counters zeroed, eight steps, the counters read.  The loss must be
   finite and fall; every step must launch the flash forward and
   backward kernels at each of the 12 layers, the LayerNorm kernel at
   each of the 26 sites and one LAMB phase-1 pass.  Then one step is
   profiled;
6. the BERT oracle: one step of the same weights (dropout 0) at batch
   2 x seq 512 on the card and on the CPU; loss, every gradient and
   every update must agree within limits above the permuted-batch
   floor;
7. the AMP LARS path: ``resnet50_v1(layout="NHWC")`` at full width,
   1000 classes, LARS (lr 0.1, momentum 0.9, eta 0.001) through
   ``gluon.Trainer`` and ``TrainStep.run_steps`` under
   ``amp.scope("bfloat16")``, batch 512 of 224x224 synthetic images,
   K = 10 steps a call over one batch: one warm-up call, the counters
   zeroed, one timed call, the counters read.  Every loss must be
   finite and step K below step 1; every step must launch both fused
   BatchNorm+ReLU kernels at each of the 33 sites on bf16 rows and one
   fp32 ``lars_flat`` pass.  Then one step is profiled;
8. the AMP LARS oracle: one bf16 step of the same weights at batch 8 on
   the card and on the CPU: equal output dtypes at every layer; the
   loss, and every gradient and update whose CPU floors (the bf16 step
   with the batch permuted, the fp32 step) are small enough to mean
   something, the output layer's among them, within limits set from
   those floors; and the card's bucketed LARS step against the plain
   one on the CPU fed the card's own weights, gradients and momenta;
9. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it, and time kernel, plain version and a library
   call computing the same function (``paged_attention`` at the
   edge-case contexts and at the decode step's own shape, 8 slots at
   context 152).

The last two lines of standard output are a JSON object of per-kernel
numbers and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
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
# the AMP LARS path: bench.py's bench_resnet50_lars settings
LARS_BATCH = 512
LARS_STEPS = 10                    # K steps per run_steps call
LARS_HYPER = {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001}
# card-vs-CPU limits of the one-step bf16 oracle: a multiple of the
# CPU's own bf16 floor (the same CPU step with the batch permuted: bf16
# rounding in other places), and no less than how far bf16 moves the
# CPU step from fp32.  A plumbing fault moves loss, gradients and
# updates by O(1), so a tensor is held only where both floors stay below
# AMP_FLOOR_CAP.  The LARS replay
# holds the card's bucketed update against the plain one fed the card's
# own tensors: there only fp32 arithmetic differs
AMP_ORACLE_FACTOR = 8.0
AMP_FLOOR_CAP = 0.25
LARS_REPLAY_LIMIT = 1e-5


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
    """Median milliseconds of ``fn()`` on the device, with the L2 cache
    flushed before each call (the decode step finds the cache cold: each
    layer's slab was last touched one step ago).  A spin kernel of 2e6
    cycles (~1 ms) after the flush keeps the device busy while
    the host enqueues the start event and ``fn``'s launches, so that a
    kernel shorter than its wrapper's host work is timed on the device
    and not at the host's pace."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def host_us(fn, iters=200, repeats=5):
    """Median host microseconds of one ``fn()`` call, over ``repeats``
    runs of ``iters`` back-to-back calls, with a spin kernel of 2e7
    cycles (~10 ms) keeping the device busy so that no call waits for
    it: the wrapper's own host work, which ``time_ms`` keeps out of the
    device time."""
    import torch
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return float(np.median(runs))


# ---------------------------------------------------------------------
# phase 9: paged_attention against its plain version
# ---------------------------------------------------------------------

EDGE_CONTEXTS = (0, 1, 15, 16, 17, 333, 1000, 1024)
DECODE_CONTEXTS = (152,) * 8       # decode_step_breakdown's shape


def paged_attention_inputs(kv_dtype, seed=0, contexts=EDGE_CONTEXTS):
    """The decode step's shapes at GPT-2 small width with the default
    cache (512 blocks of 16): 8 slots at the given contexts (by default
    over the edge cases), each on its own random cache blocks."""
    import torch
    rng = np.random.default_rng(seed)
    slots, heads, d, nb, bs, max_seq = len(contexts), 12, 64, 512, 16, 1024
    mb = max_seq // bs
    ctx = np.array(contexts, np.int32)
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


def paged_attention_times(scale, contexts):
    """Kernel, plain version and SDPA over pre-gathered K/V at the given
    contexts, fp32 cache (the main path's), with the kernel held against
    the plain version there too; the wrapper's host time a call; and
    the byte bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    q, k, v, bt, ctx = paged_attention_inputs(torch.float32,
                                              contexts=contexts)
    got = paged_attention_cuda(q, k, v, bt, ctx, scale=scale)
    want = paged_attention_reference(q, k, v, bt, ctx, scale=scale)
    err = float((got - want).abs().max())
    check(err <= 1e-4, "paged_attention at contexts %s: max |kernel - "
          "plain| = %g > atol 1e-4" % (list(contexts), err))
    slots, heads, d = q.shape
    mb, bs = bt.shape[1], k.shape[1]
    kg = k[bt.long()].reshape(slots, mb * bs, heads, d).transpose(1, 2)
    vg = v[bt.long()].reshape(slots, mb * bs, heads, d).transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    mask = (torch.arange(mb * bs, device="cuda")[None]
            < ctx.reshape(slots, 1))[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = time_ms(lambda: paged_attention_cuda(q, k, v, bt, ctx, scale=scale))
    host = host_us(lambda: paged_attention_cuda(q, k, v, bt, ctx,
                                                scale=scale))
    plain_ms = time_ms(
        lambda: paged_attention_reference(q, k, v, bt, ctx, scale=scale))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, scale=scale))
    bound_ms, bound_by, nbytes = paged_attention_bound(q, k, bt, ctx)
    print("paged_attention times (float32 cache, contexts %s): kernel_ms "
          "%.5f plain_ms %.5f library_ms %.5f (SDPA over pre-gathered K/V) "
          "bound %.3f us (%d bytes at 3.35 TB/s), max_abs_err %.3g, "
          "wrapper host_us %.2f a call"
          % (list(contexts), ms, plain_ms, library_ms, 1e3 * bound_ms,
             nbytes, err, host))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_phase(scale):
    import torch
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
    # times at the main path's cache dtype (float32): the edge-case
    # contexts, then the decode step's own shape
    edge = paged_attention_times(scale, EDGE_CONTEXTS)
    paged_attention_times(scale, DECODE_CONTEXTS)
    return dict(edge, max_abs_err=result["float32"],
                max_abs_err_bf16=result["bfloat16"])


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
    ("flash_attention", ("flash_fwd_kernel", "flash_bwd_kernel",
                         "cast_dq_kernel")),
    ("layernorm", ("layernorm_fwd_kernel",)),
    ("lamb_phase1", ("lamb_phase1_kernel",)),
    ("lars_flat", ("lars_flat_kernel",)),
    ("layout_transform", ("nhwctonchw", "nchwtonhwc")),
    ("convolution", ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm")),
    ("copy", ("copy",)),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "gemv")),
    ("softmax", ("softmax",)),
    ("index", ("index", "gather", "scatter", "embedding")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)
RESNET_KERNELS = ("bn_relu_fwd_kernel", "bn_relu_bwd_kernel")
LARS_KERNELS = RESNET_KERNELS + ("lars_flat_kernel",)
BERT_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel",
                "layernorm_fwd_kernel", "lamb_phase1_kernel")


def kernel_category(name):
    low = name.lower()
    for cat, marks in KERNEL_CATEGORIES:
        if any(m in low for m in marks):
            return cat
    return "other"


def train_step_breakdown(step, x, y, step_ms, hand=RESNET_KERNELS,
                         label="training step breakdown"):
    """Where one training step's time goes: device busy time from
    ``torch.profiler``, by kernel category (ms and launches) and by the
    operator that launched it, the device time of each hand-written
    kernel named in ``hand`` and their share, the top device kernels,
    and every copy kernel, cuDNN's own NHWC/NCHW layout transforms
    included."""
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
    own = {name: [e for e in kernels if name in e.key] for name in hand}
    missing = [name for name, es in own.items() if not es]
    check(not missing, "the profiler saw no %s" % ", ".join(missing))
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
    hand_ms = {name: ms(es) for name, es in own.items()}
    out = {"step_ms": step_ms, "device_busy_ms": busy,
           "by_category": {k: [v[0], v[1]] for k, v in sorted(
               by_cat.items(), key=lambda kv: -kv[1][0])},
           "device_idle_share": max(0.0, 1 - busy / step_ms),
           "hand_kernel_ms": hand_ms,
           "hand_kernel_share": sum(hand_ms.values()) / busy,
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
    print("%s: %s" % (label, json.dumps(out)))
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


def rel_errors(a, b):
    """Norm-wise relative error of ``a`` against ``b`` (dicts of
    tensors): over all together, and the worst single entry."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for k, want in b.items():
        d = float((a[k] - want).norm())
        n = float(want.norm())
        num, den = num + d * d, den + n * n
        if n > 0 and d / n > worst:
            worst, worst_name = d / n, k
    return (num / den) ** 0.5, worst, worst_name


def update_errors(ua, ub):
    """:func:`rel_errors` of updates ``ua`` against ``ub``, conv biases
    left out: each feeds a BatchNorm, whose batch mean cancels it, so
    its exact gradient is 0 and its update is rounding noise."""
    return rel_errors(ua, {k: v for k, v in ub.items()
                           if not _is_conv_bias(k)})


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
# phase 9: fused BN+ReLU kernels against their plain versions
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
    # the stem in bf16, as the AMP LARS path launches it
    shape = BN_SHAPES[0]
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    t = bn_relu_inputs(shape, torch.bfloat16)
    x, y, dy = t["x"], t["y"], t["dy"]
    bf16 = {
        "fwd": {"ms": time_ms(lambda: bn_relu_apply_cuda(x, t["scale"],
                                                          t["offset"])),
                "plain_ms": time_ms(lambda: bn_relu_apply_reference(
                    x, t["scale"], t["offset"]))},
        "bwd": {"ms": time_ms(lambda: bn_relu_bwd_cuda(x, dy, y, *t["bwd"])),
                "plain_ms": time_ms(lambda: bn_relu_bwd_reference(
                    x, dy, y, *t["bwd"]))}}
    bf16["fwd"]["bound_ms"], _, fb = bn_relu_bound(rows, c, 2, 2, 2, 3)
    bf16["bwd"]["bound_ms"], _, bb = bn_relu_bound(rows, c, 2, 4, 5, 8)
    print("bn_relu times %s bf16: fwd %s (%d bytes at 3.35 TB/s); bwd %s "
          "(%d bytes)" % (shape, json.dumps(bf16["fwd"]), fb,
                          json.dumps(bf16["bwd"]), bb))
    del t, x, y, dy
    main = times[BN_SHAPES[0]]
    return {kind: dict(main[kind], max_abs_err=errs[kind]["float32"],
                       max_abs_err_bf16=errs[kind]["bfloat16"])
            for kind in ("fwd", "bwd")}


# ---------------------------------------------------------------------
# phases 5-6: the BERT pretraining path and its oracle
# ---------------------------------------------------------------------

BERT_VOCAB = 30522
BERT_LAYERS = 12
BERT_HEADS = 12
BERT_BATCH, BERT_SEQ = 32, 512
# LAMB of the main path: lr an explicit hyper-parameter, the rest the
# optimizer's published defaults with BERT's weight decay
BERT_LAMB = {"learning_rate": 1e-4, "wd": 0.01, "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-6, "bias_correction": True}
# card-vs-CPU limits of the one-step BERT oracle (batch 2 x seq 512,
# dropout 0).  A plumbing fault (a stride, a mask, a stream, a missed
# gradient) moves gradients and updates by O(1).  Gradients are held
# tightly; fp32 summation order alone moves them by about the floor the
# oracle prints (the same CPU step with the batch permuted).  LAMB's
# first step, m / (sqrt(v) + eps) = g / (|g| + eps), turns the rounding
# noise of gradient entries far below their tensor's norm into updates
# of either sign, so the card-vs-CPU updates are held loosely and the
# update itself sharply: the card's bucketed LAMB against the plain
# versions on the CPU fed the card's own gradients and weights
# ("lamb_*").  The key third of each qkv bias is held apart: softmax
# ignores a shift of the scores along a row, so its exact gradient is 0
# and its update pure noise; its gradient is held against the rest of
# the bias's
BERT_ORACLE_LIMITS = {"loss_rel_err": 1e-5, "grad_rel_err": 1e-4,
                      "grad_rel_err_worst": 1e-3, "lamb_rel_err": 1e-4,
                      "lamb_rel_err_worst": 1e-3, "update_rel_err": 2e-2,
                      "update_rel_err_worst": 2e-1,
                      "key_bias_grad_share": 1e-4}

def bert_base_net(dropout=0.1, vocab_size=BERT_VOCAB):
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    return bert_base(vocab_size=vocab_size, max_length=BERT_SEQ,
                     dropout=dropout)


def make_mlm_loss(vocab):
    """The masked-LM loss of the JAX package's BERT step
    (``bench.py :: bench_bert_base``): softmax cross entropy at every
    position, summed by ``TrainStep``; next-sentence scores unused."""
    from mxnet_tpu_torch import gluon

    class MLMLoss(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, outs, labels):
            return self._ce(outs[0].reshape(-1, vocab), labels.reshape(-1))

    return MLMLoss()


def make_bert_step(net, vocab):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep
    trainer = gluon.Trainer(net.collect_params(), "lamb", dict(BERT_LAMB))
    return TrainStep(net, make_mlm_loss(vocab), trainer)


def bert_main_path(make_net=bert_base_net, vocab=BERT_VOCAB,
                   layers=BERT_LAYERS, batch=BERT_BATCH, seq=BERT_SEQ,
                   steps=TRAIN_STEPS, device="cuda"):
    """Pretrain ``make_net()`` (masked LM, LAMB) for ``steps`` steps on
    one repeated synthetic batch after one warm-up step; the launch
    counters are zeroed after the warm-up and read after the last
    step."""
    import torch
    from mxnet_tpu_torch import random
    from mxnet_tpu_torch.kernels import registry
    random.seed(0)
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    step = make_bert_step(net, vocab)
    gen = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(0, vocab, (batch, seq), generator=gen,
                        device=device).float()
    labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device).float()
    cuda = device == "cuda"
    t0 = time.perf_counter()
    step(ids, labels)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    warm_s = time.perf_counter() - t0

    registry.reset_launches()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(steps)]
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: registry.launches(name) for name in (
        "flash_attention_fwd", "flash_attention_bwd", "layernorm_fwd",
        "lamb_phase1")}
    losses = [float(v) for v in losses]

    check(all(np.isfinite(losses)), "non-finite BERT loss: %s" % losses)
    check(losses[-1] < losses[0], "BERT loss did not fall: %s" % losses)
    want = {"flash_attention_fwd": layers * steps,
            "flash_attention_bwd": layers * steps,
            # two per encoder cell, the embedding LayerNorm, the MLM head's
            "layernorm_fwd": (2 * layers + 2) * steps,
            "lamb_phase1": steps}   # one fp32 bucket a step
    for name, n in want.items():
        check(counts[name] == n, "%s launches %d != %d" % (name,
                                                           counts[name], n))
    bucket = sum(p.data().numel() for p in net.collect_params().values())
    stats = {"batch": batch, "seq": seq, "steps": steps, "losses": losses,
             "ms_per_step": 1e3 * wall / steps,
             "tokens_per_s": batch * seq * steps / wall, "warmup_s": warm_s,
             "launches": counts, "lamb_bucket_elements": bucket,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "card": gpu_line() if cuda else None}
    print("BERT main path (bert_base fp32, masked LM, LAMB, dropout 0.1): "
          "%s" % json.dumps(stats))
    return net, step, (ids, labels), stats


@contextlib.contextmanager
def replaying_bucket_update(record):
    """Within the scope, ``TrainStep``'s bucketed update runs as ever and
    then once more on CPU copies of its inputs (weights, gradients and
    states before the update): the plain versions fed the same
    gradients.  ``record["replay"]`` receives ``{index: weight}`` of
    that replay."""
    from mxnet_tpu_torch.parallel import data_parallel
    original = data_parallel.bucket_update

    def cpu_copy(t):
        if isinstance(t, tuple):        # LAMB's (mean, var)
            return tuple(cpu_copy(u) for u in t)
        return t.detach().cpu().clone()

    def both(opt, items):
        cpu = [(i, cpu_copy(w), cpu_copy(g), cpu_copy(s))
               for i, w, g, s in items]
        original(opt, items)
        original(opt, cpu)
        record["replay"] = {i: w for i, w, _g, _s in cpu}

    data_parallel.bucket_update = both
    try:
        yield record
    finally:
        data_parallel.bucket_update = original


def bert_grads_and_step(net, vocab, ids, labels):
    """One forward/backward of the summed MLM loss, then one
    ``TrainStep`` from a fresh trainer: ``(loss, {name: grad}, {name: w'
    - w}, {name: w'' - w})``, float64 on the CPU, names relative to the
    net's prefix, ``w''`` the replay of the step's LAMB update on the CPU
    from the step's own gradients; parameters without a gradient are
    left out of the gradients."""
    import torch
    from mxnet_tpu_torch import autograd
    params = {p.name[len(net.prefix):]: p
              for p in net.collect_params().values()}
    dev = next(iter(params.values())).data().device
    x = torch.as_tensor(ids, device=dev)
    y = torch.as_tensor(labels, device=dev)
    with autograd.record():
        loss = make_mlm_loss(vocab)(net(x), y)
    loss.sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.data().grad
        if g is not None:
            grads[k] = g.detach().cpu().double()
        p.data().grad = None
    before = {k: p.data().detach().cpu().double() for k, p in params.items()}
    step = make_bert_step(net, vocab)
    with replaying_bucket_update({}) as record:
        loss = float(step(x, y))
    names = {i: p.name[len(net.prefix):]
             for i, p in enumerate(step._trainer._params)}
    updates = {k: p.data().detach().cpu().double() - before[k]
               for k, p in params.items()}
    replay = {names[i]: w.double() - before[names[i]]
              for i, w in record["replay"].items()}
    return loss, grads, updates, replay


def split_key_bias(values, units):
    """``values`` with the key third of every ``qkv_bias`` cut out, and
    the key thirds apart: ``(rest, {name: key part})``."""
    import torch
    rest, keys = {}, {}
    for name, t in values.items():
        if name.endswith("qkv_bias"):
            keys[name] = t[units:2 * units]
            t = torch.cat([t[:units], t[2 * units:]])
        rest[name] = t
    return rest, keys


def bert_oracle(net, make_net=bert_base_net, vocab=BERT_VOCAB, batch=2,
                seq=BERT_SEQ, device="cuda"):
    """One BERT step (dropout 0) with ``net``'s weights on ``device``
    (the kernels) and on the CPU (the plain versions), on the same
    batch: loss, every gradient before the update and every update.  A
    third step, on the CPU with the batch permuted, computes the same
    function in another fp32 summation order: its distance from the CPU
    step is the floor the card is read against."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    arrays = {p.name: p.data().detach().cpu().numpy()
              for p in net.collect_params().values()}
    units = net._units

    def copy_on(dev):
        n = make_net(dropout=0.0)
        n.initialize(device=dev)
        params_from_numpy(n, arrays, prefix=net.prefix)
        return n

    rng = np.random.default_rng(1)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.float32)
    perm = rng.permutation(batch)
    runs = {"cpu": bert_grads_and_step(copy_on("cpu"), vocab, ids, labels),
            "cpu_permuted": bert_grads_and_step(copy_on("cpu"), vocab,
                                                ids[perm], labels[perm]),
            "card": bert_grads_and_step(copy_on(device), vocab, ids,
                                        labels)}
    loss, grads, updates, key_grads = {}, {}, {}, {}
    for run, (l, g, u, _r) in runs.items():
        loss[run] = l
        grads[run], key_grads[run] = split_key_bias(g, units)
        updates[run], _ = split_key_bias(u, units)
    replay, _ = split_key_bias(runs["card"][3], units)
    check(sorted(grads["card"]) == sorted(grads["cpu"]),
          "parameters with a gradient differ: card %d, CPU %d"
          % (len(grads["card"]), len(grads["cpu"])))
    g_glob, g_worst, g_worst_name = rel_errors(grads["card"], grads["cpu"])
    u_glob, u_worst, u_worst_name = rel_errors(updates["card"],
                                               updates["cpu"])
    l_glob, l_worst, l_worst_name = rel_errors(updates["card"], replay)
    fg_glob, fg_worst, _ = rel_errors(grads["cpu_permuted"], grads["cpu"])
    fu_glob, fu_worst, _ = rel_errors(updates["cpu_permuted"],
                                      updates["cpu"])
    # the key parts' gradient (exactly 0) against the rest of the bias's
    key_share = max(float(key_grads[run][k].norm()
                          / grads[run][k].norm())
                    for run in ("card", "cpu") for k in key_grads[run])
    # where the card-vs-CPU update error of the worst qkv weight sits:
    # its query, key and value thirds
    worst_qkv = max((k for k in updates["cpu"] if k.endswith("qkv_weight")),
                    key=lambda k: float((updates["card"][k]
                                         - updates["cpu"][k]).norm()
                                        / updates["cpu"][k].norm()))
    thirds = [float((updates["card"][worst_qkv][j * units:(j + 1) * units]
                     - updates["cpu"][worst_qkv][j * units:(j + 1) * units])
                    .norm() / updates["cpu"][worst_qkv]
                    [j * units:(j + 1) * units].norm()) for j in range(3)]
    out = {"batch": batch, "seq": seq, "loss_card": loss["card"],
           "loss_cpu": loss["cpu"],
           "loss_rel_err": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
           "grad_rel_err": g_glob, "grad_rel_err_worst": g_worst,
           "grad_worst_param": g_worst_name,
           "lamb_rel_err": l_glob, "lamb_rel_err_worst": l_worst,
           "lamb_worst_param": l_worst_name,
           "update_rel_err": u_glob, "update_rel_err_worst": u_worst,
           "update_worst_param": u_worst_name,
           "update_rel_err_qkv_thirds": [worst_qkv, thirds],
           "key_bias_grad_share": key_share,
           "floor_loss_rel_err": abs(loss["cpu_permuted"] - loss["cpu"])
           / abs(loss["cpu"]),
           "floor_grad_rel_err": fg_glob,
           "floor_grad_rel_err_worst": fg_worst,
           "floor_update_rel_err": fu_glob,
           "floor_update_rel_err_worst": fu_worst,
           "params_with_grad": len(grads["cpu"]),
           "params": len(updates["cpu"]), "limits": BERT_ORACLE_LIMITS}
    print("BERT oracle (card vs CPU): %s" % json.dumps(out))
    check(np.isfinite(loss["card"]),
          "BERT oracle loss on the card is not finite")
    for key, limit in BERT_ORACLE_LIMITS.items():
        check(out[key] <= limit, "BERT oracle: %s %.3g > limit %g"
              % (key, out[key], limit))
    return out


# ---------------------------------------------------------------------
# phases 7-8: the AMP LARS path and its oracle
# ---------------------------------------------------------------------

def make_lars_step(net):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep
    trainer = gluon.Trainer(net.collect_params(), "lars", dict(LARS_HYPER))
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)


def amp_step(step, bf16=True):
    """``step(x, y)`` under ``amp.scope("bfloat16")`` (in fp32 when
    ``bf16`` is false)."""
    from mxnet_tpu_torch import amp

    def run(x, y):
        with amp.scope("bfloat16") if bf16 else contextlib.nullcontext():
            return step(x, y)
    return run


def amp_lars_main_path(make_net=resnet50_nhwc, batch=LARS_BATCH, image=224,
                       steps=LARS_STEPS, sites=BN_RELU_SITES, device="cuda"):
    """Train ``make_net()`` with LARS under bf16 AMP through
    ``TrainStep.run_steps``: one warm-up call of ``steps`` steps, then
    one timed call, the launch counters zeroed just before it and read
    just after.  Every step trains on the same batch (an expanded
    view)."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.kernels import registry
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    step = make_lars_step(net)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, image, image, 3), generator=gen, device=device)
    y = torch.randint(0, net.output._units, (batch,), generator=gen,
                      device=device).float()
    xs, ys = x.expand(steps, *x.shape), y.expand(steps, batch)
    cuda = device == "cuda"
    with amp.scope("bfloat16"):
        t0 = time.perf_counter()
        step.run_steps(xs, ys)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        warm_s = time.perf_counter() - t0

        registry.reset_launches()
        t0 = time.perf_counter()
        losses = step.run_steps(xs, ys)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {name: registry.launches(name)
              for name in ("bn_relu_apply", "bn_relu_bwd", "lars_flat")}
    dtypes = {name: registry.launch_dtypes(name) for name in counts}
    check(losses.shape == (steps,) and losses.device.type == device,
          "run_steps returned %s on %s" % (tuple(losses.shape),
                                            losses.device))
    losses = losses.tolist()
    check(all(np.isfinite(losses)), "non-finite LARS loss: %s" % losses)
    check(losses[-1] < losses[0], "LARS loss did not fall: %s" % losses)
    want = {"bn_relu_apply": sites * steps, "bn_relu_bwd": sites * steps,
            "lars_flat": steps}     # one fp32 bucket a step
    for name, n in want.items():
        check(counts[name] == n, "%s launches %d != %d" % (name,
                                                           counts[name], n))
    if cuda:
        for name in ("bn_relu_apply", "bn_relu_bwd"):
            check(dtypes[name] == {"bfloat16": sites * steps},
                  "%s ran on %s, not bf16 rows" % (name, dtypes[name]))
        check(dtypes["lars_flat"] == {"float32": steps},
              "lars_flat ran on %s" % dtypes["lars_flat"])
    live = [p for p in step._trainer._params if p.grad_req != "null"]
    stats = {"batch": batch, "image": image, "steps": steps,
             "losses": losses, "ms_per_step": 1e3 * wall / steps,
             "img_per_s": batch * steps / wall, "warmup_s": warm_s,
             "launches": counts, "launch_dtypes": dtypes,
             "lars_bucket_elements": sum(p.data().numel() for p in live),
             "lars_tensors": len(live),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "card": gpu_line() if cuda else None}
    print("AMP LARS main path (ResNet-50 v1 NHWC, bf16 AMP, LARS "
          "0.1/0.9/0.001, run_steps K=%d): %s" % (steps, json.dumps(stats)))
    return net, step, (x, y), stats


def layer_dtypes(net, x):
    """``[(block type, output dtype)]`` of every block a bf16 forward of
    ``net`` on ``x`` calls, in call order."""
    import torch
    from mxnet_tpu_torch import amp, autograd
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, _a, out: seen.append(
            (type(m).__name__, str(out.dtype).replace("torch.", ""))))
        for m in net.modules()]
    try:
        with amp.scope("bfloat16"), autograd.pause():
            dev = next(iter(net.collect_params().values())).data().device
            net(torch.as_tensor(x, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return seen


def lars_grads_and_step(net, x, y, bf16=True):
    """One bf16 (or fp32) forward/backward of the summed loss, then one
    such ``TrainStep`` with LARS from a fresh trainer: ``(loss, {name:
    grad},
    {name: w' - w}, {name: w'' - w})``, float64 on the CPU, names
    relative to the net's prefix, ``w''`` the replay of the step's LARS
    update on the CPU from the step's own tensors."""
    import torch
    from mxnet_tpu_torch import amp, autograd, gluon
    params = {p.name[len(net.prefix):]: p
              for p in net.collect_params().values()}
    dev = next(iter(params.values())).data().device
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    with amp.scope("bfloat16") if bf16 else contextlib.nullcontext():
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(xt), yt)
        loss.sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.data().grad
        if g is not None:
            grads[k] = g.detach().cpu().double()
        p.data().grad = None
    before = {k: p.data().detach().cpu().double() for k, p in params.items()}
    step = make_lars_step(net)
    with replaying_bucket_update({}) as record:
        loss = float(amp_step(step, bf16)(xt, yt))
    names = {i: p.name[len(net.prefix):]
             for i, p in enumerate(step._trainer._params)}
    updates = {k: p.data().detach().cpu().double() - before[k]
               for k, p in params.items() if p.grad_req != "null"}
    replay = {names[i]: w.double() - before[names[i]]
              for i, w in record["replay"].items()}
    return loss, grads, updates, replay


def per_tensor_errors(a, b):
    """``{name: ||a - b|| / ||b||}`` over the entries of ``b`` with a
    nonzero norm."""
    out = {}
    for k, want in b.items():
        n = float(want.norm())
        if n > 0:
            out[k] = float((a[k] - want).norm()) / n
    return out


def held_against_floors(got, floors, fp32):
    """Hold each tensor's card-vs-CPU error ``got[k]`` to AMP_ORACLE_FACTOR
    times its permuted floor, and no less than its fp32 distance, for the
    tensors whose floors are both below AMP_FLOOR_CAP (elsewhere bf16
    noise alone is O(1), as large as a fault): ``(held names, worst
    ratio of error to limit, its name)``."""
    held = [k for k in floors
            if max(floors[k], fp32[k]) < AMP_FLOOR_CAP]
    worst, worst_name = 0.0, None
    for k in held:
        limit = max(AMP_ORACLE_FACTOR * floors[k], fp32[k])
        ratio = got[k] / limit if limit > 0 else (0.0 if got[k] == 0
                                                  else float("inf"))
        if ratio > worst:
            worst, worst_name = ratio, k
    return held, worst, worst_name


def amp_lars_oracle(net, make_net=resnet50_nhwc, batch=8, image=224,
                    device="cuda"):
    """One bf16 LARS step with ``net``'s weights on the card (the
    kernels) and on the CPU (the plain versions), on the same batch.  Two
    more on the CPU give the floors the card is read against: the same
    bf16 step with the batch permuted (the same function rounded to bf16
    in other places), and the step in fp32 (how far bf16 itself moves
    it).  The loss, and each gradient and update whose floors are below
    AMP_FLOOR_CAP, are held to AMP_ORACLE_FACTOR times the permuted floor
    and no less than the fp32 distance: the permuted floor alone can be 0
    (the loss of a permuted batch can round to the same value).  In the
    deep layers of ResNet-50 at initialization bf16 moves the gradients
    by O(1) (the fp32 step already moves them by ~1% under a mere change
    of summation order), so only the layers near the loss can be held;
    the output layer must be among them: at batch 8 its gradient's
    permuted floor is ~5% and its fp32 distance ~10%.  The card's bucketed LARS step
    is held against the plain one on the CPU fed the card's own tensors.
    Convolution biases are left out (a BatchNorm cancels each: its exact
    gradient is 0)."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    arrays = {p.name: p.data().detach().cpu().numpy()
              for p in net.collect_params().values()}

    def copy_on(dev):
        n = make_net()
        n.initialize(device=dev)
        params_from_numpy(n, arrays, prefix=net.prefix)
        return n

    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    y = rng.integers(0, net.output._units, batch).astype(np.float32)
    perm = rng.permutation(batch)
    card_dtypes = layer_dtypes(copy_on(device), x)
    cpu_dtypes = layer_dtypes(copy_on("cpu"), x)
    check(card_dtypes == cpu_dtypes and len(card_dtypes) > 20,
          "per-layer output dtypes differ card vs CPU: %s"
          % [(a, b) for a, b in zip(card_dtypes, cpu_dtypes) if a != b][:5])
    t0 = time.perf_counter()
    runs = {"cpu": lars_grads_and_step(copy_on("cpu"), x, y)}
    cpu_step_s = time.perf_counter() - t0
    runs["cpu_permuted"] = lars_grads_and_step(copy_on("cpu"), x[perm],
                                               y[perm])
    runs["cpu_fp32"] = lars_grads_and_step(copy_on("cpu"), x, y, bf16=False)
    runs["card"] = lars_grads_and_step(copy_on(device), x, y)
    loss = {run: r[0] for run, r in runs.items()}
    check(sorted(runs["card"][1]) == sorted(runs["cpu"][1]),
          "parameters with a gradient differ card vs CPU")
    out = {"batch": batch, "cpu_step_s": cpu_step_s,
           "layers_compared": len(card_dtypes),
           "bf16_layers": sum(d == "bfloat16" for _t, d in card_dtypes),
           "loss_card": loss["card"], "loss_cpu": loss["cpu"],
           "loss_rel_err": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
           "floor_loss_rel_err": abs(loss["cpu_permuted"] - loss["cpu"])
           / abs(loss["cpu"]),
           "fp32_loss_rel_err": abs(loss["cpu_fp32"] - loss["cpu"])
           / abs(loss["cpu"])}
    out["loss_limit"] = max(AMP_ORACLE_FACTOR * out["floor_loss_rel_err"],
                            out["fp32_loss_rel_err"])
    for what, j in (("grad", 1), ("update", 2)):
        vals = {run: {k: v for k, v in r[j].items() if not _is_conv_bias(k)}
                for run, r in runs.items()}
        got = per_tensor_errors(vals["card"], vals["cpu"])
        floors = per_tensor_errors(vals["cpu_permuted"], vals["cpu"])
        fp32 = per_tensor_errors(vals["cpu_fp32"], vals["cpu"])
        held, worst, worst_name = held_against_floors(got, floors, fp32)
        glob, _, _ = rel_errors({k: vals["card"][k] for k in held},
                                {k: vals["cpu"][k] for k in held})
        out.update({
            "%s_tensors" % what: len(got), "%s_held" % what: len(held),
            "%s_rel_err_held" % what: glob,
            "%s_worst_ratio_to_limit" % what: worst,
            "%s_worst_param" % what: worst_name,
            "%s_output_layer" % what: [got.get("dense0_weight"),
                                       floors.get("dense0_weight"),
                                       fp32.get("dense0_weight")],
            "%s_rel_err_all" % what: rel_errors(vals["card"],
                                                vals["cpu"])[0],
            "floor_%s_rel_err_all" % what: rel_errors(vals["cpu_permuted"],
                                                      vals["cpu"])[0]})
    r_glob, r_worst, r_name = rel_errors(runs["card"][2], runs["card"][3])
    out.update({"lars_replay_rel_err": r_glob,
                "lars_replay_rel_err_worst": r_worst,
                "lars_replay_worst_param": r_name,
                "factor": AMP_ORACLE_FACTOR, "floor_cap": AMP_FLOOR_CAP,
                "lars_replay_limit": LARS_REPLAY_LIMIT})
    print("AMP LARS oracle (card vs CPU, bf16): %s" % json.dumps(out))
    check(np.isfinite(loss["card"]), "AMP oracle loss on the card is not "
          "finite")
    for what in ("grad", "update"):
        check(out["%s_output_layer" % what][0] is not None
              and max(out["%s_output_layer" % what][1:]) < AMP_FLOOR_CAP,
              "AMP oracle: the output layer's %s floors %s reach "
              "AMP_FLOOR_CAP" % (what, out["%s_output_layer" % what][1:]))
        check(out["%s_worst_ratio_to_limit" % what] <= 1.0,
              "AMP LARS oracle: %s of %s %.3g times its limit" % (
                  what, out["%s_worst_param" % what],
                  out["%s_worst_ratio_to_limit" % what]))
    check(out["loss_rel_err"] <= out["loss_limit"], "AMP LARS oracle: loss "
          "%.3g > limit %.3g" % (out["loss_rel_err"], out["loss_limit"]))
    check(max(r_glob, r_worst) <= LARS_REPLAY_LIMIT, "AMP LARS oracle: LARS "
          "replay %.3g (worst %.3g, %s) > %g" % (r_glob, r_worst, r_name,
                                                 LARS_REPLAY_LIMIT))
    return out


# ---------------------------------------------------------------------
# phase 9: flash attention, LayerNorm and LAMB phase 1 against their
# plain versions
# ---------------------------------------------------------------------

# relative to the largest output: fp32 sums in another order (the
# backward sums `seq` products an element, dq's through reductions in
# device memory whose order changes from run to run), bf16 one rounding
# step
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def flash_inputs(bh, seq, d, dtype, heads=BERT_HEADS, masked=False, seed=0):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn():
        return torch.randn(bh, seq, d, generator=gen, device="cuda") \
            .to(dtype)

    q, k, v, do = randn(), randn(), randn(), randn()
    mask = None
    if masked:
        # a random padding length per batch row
        lens = torch.randint(1, seq + 1, (bh // heads,), generator=gen,
                             device="cuda")
        mask = (torch.arange(seq, device="cuda")[None, None, :]
                < lens[:, None, None]).float().expand(
                    bh // heads, seq, seq).contiguous()
    return q, k, v, do, mask


def rel_err(got, want):
    want = want.float()
    return (float((got.float() - want).abs().max())
            / max(1.0, float(want.abs().max())))


def flash_check(bh, seq, d, dtype, causal=False, masked=False):
    """Both flash kernels against their plain versions: the largest
    relative error of the forward (out, lse) and of the backward."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, mask = flash_inputs(bh, seq, d, dtype, masked=masked)
    kw = dict(mask=mask, causal=causal, scale=d ** -0.5, heads=BERT_HEADS)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * want_out.float()).sum(-1)
    grads = fa.flash_attention_bwd_cuda(q, k, v, want_lse, do, delta, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, want_lse, do, delta,
                                            **kw)
    for t in (out, lse) + tuple(grads):
        check(bool(torch.isfinite(t.float()).all()),
              "flash (%d, %d, %d) %s: non-finite output" % (bh, seq, d,
                                                            dtype))
    fwd = max(rel_err(out, want_out), rel_err(lse, want_lse))
    bwd = max(rel_err(a, b) for a, b in zip(grads, want))
    key = str(dtype).split(".")[-1]
    tol_f, tol_b = FLASH_TOL[key]
    what = "flash (bh %d, seq %d, d %d, %s%s%s)" % (
        bh, seq, d, key, ", causal" if causal else "",
        ", masked" if masked else "")
    print("%s: fwd rel err %.3g (limit %g), bwd rel err %.3g (limit %g)"
          % (what, fwd, tol_f, bwd, tol_b))
    check(fwd <= tol_f, "%s forward: %.3g > %g" % (what, fwd, tol_f))
    check(bwd <= tol_b, "%s backward: %.3g > %g" % (what, bwd, tol_b))
    return fwd, bwd


def flash_bounds(bh, seq, d, itemsize):
    """Least times: forward reads q, k, v and writes out and lse, 4 *
    bh * seq^2 * d flops (two products); backward reads q, k, v, dout,
    lse, delta and writes dq, dk, dv, 10 * bh * seq^2 * d flops: the
    five products the function needs (S = q k^T, dP = do v^T, p^T do,
    ds^T q, ds k).  A kernel that recomputes S or dP, as a two-kernel
    backward does, chooses to; the function does not need it.  fp32
    runs on the CUDA cores at 67 TFLOP/s."""
    n = bh * seq * d * itemsize
    out = {}
    for kind, nbytes, flops in (
            ("fwd", 4 * n + 4 * bh * seq, 4 * bh * seq * seq * d),
            ("bwd", 7 * n + 8 * bh * seq, 10 * bh * seq * seq * d)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        out[kind] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     flops)
    return out


def flash_kernel_phase(bh, seq, d):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_attention as fa
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype).split(".")[-1]] = flash_check(bh, seq, d, dtype)
    flash_check(2 * BERT_HEADS, seq, d, torch.float32, causal=True)
    flash_check(2 * BERT_HEADS, seq, d, torch.float32, masked=True)
    flash_check(2 * BERT_HEADS, 500, d, torch.float32)
    flash_check(2 * BERT_HEADS, 500, d, torch.bfloat16, masked=True)

    q, k, v, do, _ = flash_inputs(bh, seq, d, torch.float32)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, scale=scale)
    delta = (do * out).sum(-1)
    b = bh // BERT_HEADS
    q4, k4, v4 = (t.view(b, BERT_HEADS, seq, d) for t in (q, k, v))
    do4 = do.view(b, BERT_HEADS, seq, d)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        return torch.autograd.grad(o, (ql, kl, vl), do4)

    fwd = {"ms": time_ms(lambda: fa.flash_attention_fwd_cuda(
               q, k, v, scale=scale)),
           "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
               q, k, v, scale=scale)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, scale=scale))}
    lib_both = time_ms(lib_fwd_bwd)
    bwd = {"ms": time_ms(lambda: fa.flash_attention_bwd_cuda(
               q, k, v, lse, do, delta, scale=scale)),
           "plain_ms": time_ms(lambda: fa.flash_attention_bwd_reference(
               q, k, v, lse, do, delta, scale=scale)),
           # SDPA's backward alone is no public call: its forward and
           # backward through autograd, less its forward
           "library_ms": lib_both - fwd["library_ms"]}
    bounds = flash_bounds(bh, seq, d, 4)
    for kind, t in (("fwd", fwd), ("bwd", bwd)):
        t["bound_ms"], t["bound_by"], nbytes, flops = bounds[kind]
        print("flash %s times (bh %d, seq %d, d %d, fp32): %s (%d bytes, "
              "%d flops at 67 TFLOP/s fp32)%s"
              % (kind, bh, seq, d, json.dumps(t), nbytes, flops,
                 "; library = SDPA forward+backward %.4f ms less its "
                 "forward" % lib_both if kind == "bwd" else
                 "; library = SDPA forward"))
    return {"fwd": dict(fwd, max_abs_err=errs["float32"][0],
                        max_abs_err_bf16=errs["bfloat16"][0]),
            "bwd": dict(bwd, max_abs_err=errs["float32"][1],
                        max_abs_err_bf16=errs["bfloat16"][1])}


def layernorm_kernel_phase(rows, dim):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference)
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    for r, c in ((rows, dim), (1000, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(r, c, generator=gen, device="cuda") * 3 + 1) \
                .to(dtype)
            g = torch.rand(c, generator=gen, device="cuda") + 0.5
            b = torch.randn(c, generator=gen, device="cuda")
            err = rel_err(layernorm_fwd_cuda(x, g, b),
                          layernorm_reference(x, g, b))
            key = str(dtype).split(".")[-1]
            print("layernorm (%d, %d) %s: rel err %.3g (limit %g)"
                  % (r, c, key, err, ROW_TOL[key]))
            check(err <= ROW_TOL[key], "layernorm (%d, %d) %s: %.3g > %g"
                  % (r, c, key, err, ROW_TOL[key]))
            errs[key] = max(errs.get(key, 0.0), err)
    x = torch.randn(rows, dim, generator=gen, device="cuda")
    g = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    t = {"ms": time_ms(lambda: layernorm_fwd_cuda(x, g, b)),
         "plain_ms": time_ms(lambda: layernorm_reference(x, g, b)),
         "library_ms": time_ms(lambda: F.layer_norm(x, (dim,), g, b))}
    nbytes = 2 * rows * dim * 4 + 2 * dim * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * rows * dim / FP32_FLOPS
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print("layernorm times (%d, %d) fp32: %s (%d bytes at 3.35 TB/s); "
          "library = F.layer_norm" % (rows, dim, json.dumps(t), nbytes))
    return dict(t, max_abs_err=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"])


def lamb_kernel_phase(sizes):
    """``lamb_phase1`` at the main path's bucket (the parameters'
    ``sizes``) and at an unaligned size; times of the kernel, its plain
    version and the eager multi-tensor (``torch._foreach_*``) phase-1
    sequence over the same parameters."""
    import torch
    from mxnet_tpu_torch.kernels.optimizer_update import (lamb1_reference,
                                                          lamb_phase1_cuda)
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = int(sum(sizes))
    b1, b2, eps = BERT_LAMB["beta1"], BERT_LAMB["beta2"], BERT_LAMB["epsilon"]
    scalars = (1.0 / BERT_BATCH, 1.0 / (1 - b1 ** 9), 1.0 / (1 - b2 ** 9))

    def buffers(count, offset=0, dtype=torch.float32):
        def buf(positive=False, dt=dtype):
            t = torch.randn(count + offset, generator=gen, device="cuda")
            return (t.abs() if positive else t).to(dt)[offset:]
        return (buf(), buf(), buf() * 1e-3, buf(True) * 1e-6,
                buf(True, torch.float32) * 0.01)

    errs = {}
    for count, offset, dtype in ((n, 0, torch.float32),
                                 (1000003, 1, torch.float32),
                                 (1000003, 1, torch.bfloat16)):
        w, g, m, v, wd = buffers(count, offset, dtype)
        got = lamb_phase1_cuda(w, g, m, v, wd, scalars, beta1=b1, beta2=b2,
                               eps=eps)
        want = lamb1_reference(w, g, m, v, wd, scalars, beta1=b1, beta2=b2,
                               eps=eps)
        err = max(rel_err(a, b) for a, b in zip(got, want))
        key = str(dtype).split(".")[-1]
        print("lamb_phase1 S=%d offset %d %s: rel err %.3g (limit %g)"
              % (count, offset, key, err, ROW_TOL[key]))
        check(err <= ROW_TOL[key], "lamb_phase1 S=%d %s: %.3g > %g"
              % (count, key, err, ROW_TOL[key]))
        errs[key] = max(errs.get(key, 0.0), err)
        del w, g, m, v, wd, got, want
    w, g, m, v, wd = buffers(n)
    ws, gs, ms, vs = (list(t.split(list(sizes))) for t in (w, g, m, v))
    wds = [0.01] * len(sizes)
    rescale, bc1, bc2 = scalars

    def foreach_phase1():
        gr = torch._foreach_mul(gs, rescale)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gr, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gr, gr, value=1 - b2)
        den = torch._foreach_mul(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        gw = torch._foreach_mul(ms, bc1)
        torch._foreach_div_(gw, den)
        torch._foreach_add_(gw, torch._foreach_mul(ws, wds))
        return gw

    t = {"ms": time_ms(lambda: lamb_phase1_cuda(w, g, m, v, wd, scalars,
                                                beta1=b1, beta2=b2,
                                                eps=eps)),
         "plain_ms": time_ms(lambda: lamb1_reference(
             w, g, m, v, wd, scalars, beta1=b1, beta2=b2, eps=eps)),
         "library_ms": time_ms(foreach_phase1)}
    nbytes = 8 * n * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 12 * n / FP32_FLOPS
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print("lamb_phase1 times S=%d fp32 (%d tensors): %s (%d bytes at "
          "3.35 TB/s); library = torch._foreach_* phase-1 sequence over "
          "the parameter list" % (n, len(sizes), json.dumps(t), nbytes))
    return dict(t, max_abs_err=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"])


def lars_kernel_phase(sizes, skips):
    """``lars_flat`` at the main path's bucket (the parameters' ``sizes``,
    ``skips`` their skip-list flags) in fp32 and bf16, and at an
    unaligned size; times of the kernel, its plain version and the eager
    multi-tensor (``torch._foreach_*``) sequence computing the same
    per-tensor update from the same trust-scaled learning rates."""
    import torch
    from mxnet_tpu_torch.kernels.optimizer_update import (
        lars_flat_cuda, lars_flat_reference)
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = int(sum(sizes))
    mom, rescale = LARS_HYPER["momentum"], 1.0 / LARS_BATCH
    # per tensor: lr times a trust ratio of the size eta gives, wd 0 as
    # on the main path, sign -1 on the skip list
    lrs = [LARS_HYPER["learning_rate"] * (1.0 if sk else 0.01 * (1 + k % 7))
           for k, sk in enumerate(skips)]
    wds = [0.0] * len(sizes)
    signs = [-1.0 if sk else 1.0 for sk in skips]

    def stream(count, offset, dtype=torch.float32, scale=1.0):
        """``count`` values starting at element ``offset`` of a buffer:
        off the 16-byte boundary when ``offset`` is 1."""
        t = torch.randn(count + offset, generator=gen, device="cuda")
        return (t * scale).to(dtype)[offset:]

    def inputs(count, offset, dtype):
        w, g = stream(count, offset, dtype), stream(count, offset, dtype)
        m = stream(count, offset, dtype, 1e-3)
        if count == n and offset == 0:
            vecs = []
            for values in (lrs, wds, signs):
                v = torch.empty(n, device="cuda")
                for piece, value in zip(v.split(list(sizes)), values):
                    piece.fill_(value)
                vecs.append(v)
        else:
            vecs = [stream(count, offset) for _ in range(3)]
            vecs[0].abs_().mul_(0.01)
            vecs[1].abs_().mul_(1e-4)
            vecs[2].sign_()
        return (w, g, m), vecs

    errs = {}
    for count, offset, dtype in ((n, 0, torch.float32),
                                 (n, 0, torch.bfloat16),
                                 (1000003, 1, torch.float32),
                                 (1000003, 1, torch.bfloat16)):
        (w, g, m), (lr, wd, sign) = inputs(count, offset, dtype)
        got = lars_flat_cuda(w, g, m, lr, wd, sign, rescale, momentum=mom)
        want = lars_flat_reference(w, g, m, lr, wd, sign, rescale,
                                   momentum=mom)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        rel = max(rel_err(a, b) for a, b in zip(got, want))
        key = str(dtype).split(".")[-1]
        print("lars_flat S=%d offset %d %s: max_abs_err %.3g, rel err %.3g "
              "(limit %g)" % (count, offset, key, err, rel, ROW_TOL[key]))
        check(rel <= ROW_TOL[key], "lars_flat S=%d offset %d %s: %.3g > %g"
              % (count, offset, key, rel, ROW_TOL[key]))
        errs[key] = max(errs.get(key, 0.0), err)
        del w, g, m, lr, wd, sign, got, want

    out = {}
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        (w, g, m), (lr, wd, sign) = inputs(n, 0, dtype)
        ws, gs, ms = (list(t.split(list(sizes))) for t in (w, g, m))

        def foreach_lars():
            step = torch._foreach_mul(gs, rescale)
            torch._foreach_add_(step, torch._foreach_mul(ws, wds))
            torch._foreach_mul_(step, lrs)
            torch._foreach_mul_(ms, mom)
            torch._foreach_add_(ms, torch._foreach_mul(step, signs))
            torch._foreach_sub_(ws, torch._foreach_mul(ms, signs))

        t = {"ms": time_ms(lambda: lars_flat_cuda(
                 w, g, m, lr, wd, sign, rescale, momentum=mom)),
             "plain_ms": time_ms(lambda: lars_flat_reference(
                 w, g, m, lr, wd, sign, rescale, momentum=mom)),
             "library_ms": time_ms(foreach_lars)}
        # reads w, g, m and the fp32 lr, wd, sign; writes w', m'
        nbytes = n * (5 * itemsize + 12)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * n / FP32_FLOPS
        t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        key = str(dtype).split(".")[-1]
        print("lars_flat times S=%d %s (%d tensors): %s (%d bytes at 3.35 "
              "TB/s); library = torch._foreach_* momentum sequence over the "
              "parameter list" % (n, key, len(sizes), json.dumps(t), nbytes))
        out[key] = t
        del w, g, m, lr, wd, sign, ws, gs, ms
    return dict(out["float32"], max_abs_err=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"], bf16=out["bfloat16"])


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
    net, step, (ids, labels), bert = bert_main_path()
    train_step_breakdown(step, ids, labels, bert["ms_per_step"],
                         hand=BERT_KERNELS, label="BERT step breakdown")
    sizes = [p.data().numel() for p in net.collect_params().values()]
    del step, ids, labels
    torch.cuda.empty_cache()
    bert_oracle(net)
    del net
    torch.cuda.empty_cache()
    net, step, (x, y), lars = amp_lars_main_path()
    train_step_breakdown(amp_step(step), x, y, lars["ms_per_step"],
                         hand=LARS_KERNELS,
                         label="AMP LARS step breakdown")
    live = [p for p in step._trainer._params if p.grad_req != "null"]
    lars_sizes = [p.data().numel() for p in live]
    lars_skips = [step._trainer.optimizer._skip_lars(i)
                  for i, p in enumerate(step._trainer._params)
                  if p.grad_req != "null"]
    del step, x, y, live
    torch.cuda.empty_cache()
    amp_lars_oracle(net)
    del net
    torch.cuda.empty_cache()
    attn = kernel_phase(scale)
    bn = bn_relu_kernel_phase()
    flash = flash_kernel_phase(BERT_BATCH * BERT_HEADS, BERT_SEQ, 64)
    ln = layernorm_kernel_phase(BERT_BATCH * BERT_SEQ, 768)
    lamb = lamb_kernel_phase(sizes)
    lars_k = lars_kernel_phase(lars_sizes, lars_skips)
    counts = bert["launches"]
    print(json.dumps({"kernels": [
        kernel_entry("paged_attention", decode["paged_attention_launches"],
                     attn),
        kernel_entry("bn_relu_apply", train["bn_relu_apply_launches"],
                     bn["fwd"]),
        kernel_entry("bn_relu_bwd", train["bn_relu_bwd_launches"],
                     bn["bwd"]),
        kernel_entry("flash_attention_fwd", counts["flash_attention_fwd"],
                     flash["fwd"]),
        kernel_entry("flash_attention_bwd", counts["flash_attention_bwd"],
                     flash["bwd"]),
        kernel_entry("layernorm_fwd", counts["layernorm_fwd"], ln),
        kernel_entry("lamb_phase1", counts["lamb_phase1"], lamb),
        kernel_entry("lars_flat", lars["launches"]["lars_flat"], lars_k)]}))
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
