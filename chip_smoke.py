#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build every CUDA kernel of ``mxnet_tpu_torch/csrc`` with ``nvcc``;
2. the main path: ``ModelRegistry.register_generative`` a decoder at
   GPT-2 small's published widths (vocab 50257, 768 units, 12 layers,
   12 heads, 1024 positions; random weights from seed 0), then eight
   concurrent ``generate`` calls, two of them joining the running
   batch.  The launch counters are zeroed just before and read just
   after.  Every stream is held against the model's own full-forward
   oracle on the card; the counter must show that every decode step of
   every layer went through the kernel, and the KV cache must be empty
   after the drain.  Then one decode step is profiled to show where its
   time goes;
3. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it, and time kernel, plain version and a library
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
# phase 3: paged_attention against its plain version
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
# phase 2: the main path
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.kernels import registry
    print(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    print("built %s in %.1f s" % (", ".join(sorted(libs)),
                                  time.perf_counter() - t0))
    stats, scale = main_path()
    kern = kernel_phase(scale)
    spec = registry.get("paged_attention")
    line = {"kernels": [{
        "name": spec.name, "route": "cuda",
        "source": "mxnet_tpu_torch/" + spec.source,
        "replaces": spec.replaces.split()[0],
        "launches": stats["paged_attention_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}]}
    print(json.dumps(line))
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
