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
   two warm-up steps (eager, then captured), the counters zeroed, eight
   steps, the counters read.  The loss must be finite and fall, and every BatchNorm+ReLU
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
   ``gluon.Trainer`` and ``parallel.TrainStep``: two warm-up steps
   (eager, then captured), the counters zeroed, eight steps, the
   counters read.  The loss must be
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
9. the bf16 BERT path, ``bench.py :: bench_bert_base``'s
   configuration: ``bert_base(vocab_size=30522, max_length=seq,
   dropout=0.0)`` (random weights from seed 0) under
   ``amp.scope("bfloat16")``, masked-LM loss, Adam (lr 1e-4) through
   ``gluon.Trainer`` and ``TrainStep``, at batch 256 x seq 128 and at
   64 x 512, each with every earlier owner released: two warm-up
   steps (eager, then captured), the counters zeroed, eight steps, the
   counters read.  Every loss must be finite and the last below the
   first; flash forward and backward must launch 12 x 8 times on bf16
   and ``layernorm_fwd`` 26 x 8, 25 sites on fp32 rows and the MLM
   head's on bf16 (the dtypes ``tests/test_torch_bert_bf16.py`` holds
   against the JAX package's).  It prints tokens/s, ms/step, peak
   memory and the graph pool, then profiles one step: device time by
   category (bf16 GEMM, flash forward, flash backward, LayerNorm,
   Adam's elementwise passes, casts, other) and the idle share.  Then
   the bf16 oracle: one Adam step of the 256 x 128 net's weights at 2 x
   128 on the card and on the CPU, the loss and each gradient and
   update held against the permuted-batch bf16 floor and the fp32
   distance (the AMP LARS oracle's method; the tensors it cannot hold
   printed; the card against a CPU step given the flash kernel's
   rounding of P, printed beside it); and
   BERT-base bf16 at 8 x 128 with Adam and a ``PolyScheduler`` in
   warm-up, four calls of one ``TrainStep`` against four eager steps;
9b. BERT pretraining as its users run it: ``bert_base(vocab_size=30522,
   max_length=512, dropout=0)`` hybridized under
   ``amp.scope("bfloat16")``, a padded batch of 64 x 512 made by the
   rules of google-research/bert ``create_pretraining_data.py`` (seed 0:
   short_seq_prob 0.1, two segments with token types, NSP labels 50/50,
   masked_lm_prob 0.15 up to 77 a row) with ``valid_mask[b, i, j] = j <
   len_b``, the loop ``autograd.record()`` -> NSP + MLM losses ->
   ``backward()`` -> ``trainer.step`` with Adam (lr 1e-4, wd 0.01) and
   the default ``Trainer(kvstore="device")``: two warm-up steps (eager,
   then captured), eight timed; the counters zeroed before the warm-up
   and read after.  Losses finite, the MLM loss falling; masked flash
   forward and backward 12 x 10 on bf16, ``layernorm_fwd`` 25 x 10
   fp32 + 10 bf16; one ``pushpull`` a live gradient a step.  It prints
   ms/step, tokens/s over valid and padded tokens, ``trainer.step``
   host ms (pushpull and update), peak memory, graphs and replays, then
   profiles one step (idle share), and runs the oracle: one step of
   the loop at 2 x 128 with lengths 128 and 71, bf16 and fp32, card
   against CPU;
10. the LeNet/MNIST path, ``examples/gluon_mnist.py``'s loop through the
   imperative API at the example's width (Conv2D 32 and 64, MaxPool,
   Dense 128, Dropout 0.5, Dense 10; Xavier, SGD 0.05/0.9, batch 128):
   the synthetic MNIST train set through ``DataLoader`` on the CPU,
   ``as_in_context(mx.gpu())``, ``autograd.record()``,
   ``loss.backward()``, ``trainer.step`` and ``metric.update``, one
   epoch of 468 batches, then hybridized two untimed batches (eager,
   then captured) and 100 timed ones.  Every loss must
   be finite and the accuracy in [0, 1]; a fresh net must cut the loss
   of one fixed batch 3x in 60 steps.  It prints samples/s, ms/step,
   the share of wall time waiting on the loader, the device's idle
   share (``torch.profiler`` over 20 more batches) and peak memory.
   Then the same loop through the DataLoader's device-feed route,
   ``DataLoader(..., ctx=mx.gpu(0))``: one epoch of a fresh net, its
   samples/s and the feed's overlap share beside the host route's;
11. the MNIST oracle: one step of the trained weights at batch 8 with
   dropout off on the card and on the CPU; loss and every update must
   agree;
12. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it, and time kernel, plain version and a library
   call computing the same function (``paged_attention`` at the
   edge-case contexts and at the decode step's own shape, 8 slots at
   context 152; the fused BatchNorm+ReLU kernels in fp32 and bf16; the
   flash forward and backward in fp32 and in bf16, the forward with its
   registers and shared memory, and causal with a float mask that
   leaves a row no key; at phase 9's shapes the flash kernels in bf16
   at (3072, 128, 64) and (768, 512, 64) and LayerNorm on its 32,768 x
   768 rows in fp32 and bf16, beside SDPA and ``F.layer_norm``; at
   phase 9b's shape the masked flash kernels in bf16 at (768, 512, 64)
   with its valid_mask, beside SDPA with the boolean mask);
13. checkpoint and serve.  Right after phase 3's eight steps the net
   and its trainer are saved with ``CheckpointManager.save_training``,
   once synchronously and once with ``async_save=True`` (the two steps'
   files must be identical), and resumed into a fresh net and
   ``Trainer``: every parameter and momentum state must equal the
   saved one bitwise, and one more step of the resumed pair and of the
   original on the same batch (cuDNN deterministic) must agree.  After
   the kernel phases, a third fresh net is served from the checkpoint
   by ``ModelRegistry.register(block=, checkpoint=)`` with buckets 1 to
   32: 8 client threads send 512 single 224x224 images in bursts of
   1-32; every request gets one response, within 1e-4 of the restored
   net's own batch-1 forward, none after the drain, and
   ``bn_relu_apply`` launches 33 times per executor call.  It prints
   requests/s, latency, the bucket histogram, the device's idle share
   (``torch.profiler`` over 128 more requests) and the closed-loop
   images/s of the largest bucket.  Last, the decode path's weights are
   saved as a ``params`` item and served by
   ``register_generative(checkpoint=)``: its greedy streams must equal
   the ``params=`` route's, and ``paged_attention`` must launch once per
   layer per decode step.

14. DenseNet-121 (``densenet121(layout="NHWC")``: growth 32, blocks
   6/12/24/16, 1000 classes; random weights from seed 0, random labels),
   fp32 with TF32 off, batch 64 of 224x224, SGD 0.05/0.9 and
   ``SoftmaxCrossEntropyLoss``, after the MNIST oracle: (a) the captured
   ``TrainStep``, two warm-up and eight timed steps, its breakdown and
   capture line; ``bn_relu_apply`` and ``bn_relu_bwd`` must launch
   exactly 121 times a step (every BatchNorm+ReLU pair of the JAX
   package's fusion plan); (c) its oracle, card against CPU at batch 8
   by the training oracle's limits; (b) the imperative loop users write
   (the hybridized net under ``record``, ``backward``,
   ``Trainer(kvstore="device")`` with ``allreduce_grads``/``update``),
   two warm-up and five timed steps, 121 launches of each kernel a
   step; (d) both fused kernels against their plain versions at every
   distinct ``(rows, C)`` the net gives them at batch 64, and their
   times (beside their bound and the library calls) at the stem, the
   largest site of dense block 3's resolution and the head; (e) every
   ``get_model`` net, NHWC, eval, hybridized, batch 8 at 224x224 (299
   for Inception V3), four forwards: logits (8, 1000) and finite,
   ``bn_relu_apply`` launched ``ZOO_FUSED_SITES[name]`` times a forward;
   (f) ``mx.nd.flash_attention``, ``flash_attention_masked`` and
   ``fused_batch_norm_relu`` on CUDA NDArrays, forward and backward:
   each launches its kernels and matches its plain version, and the
   fused op on an NCHW input launches none.

15. the ImageNet input path (ROADMAP item 6), after DenseNet: 8,192
   raw 224x224x3 records (``bench.py :: _build_rec(fmt="raw")``'s
   images from seed 0, labels ``i % 1000``, 1.23 GB) written by the
   port's ``recordio`` into a temporary directory under ``build/`` and
   removed at the end; ``mx.io.ImageRecordIter(ctx=mx.gpu(0),
   dtype="bfloat16")`` (batch 512, shuffle, random mirror, ImageNet's
   mean and std, 4 threads) -- a ``DeviceFeed`` over an ``ImageIter``
   -- feeding ResNet-50 v1 NHWC under bf16 AMP with bucketed LARS
   (``make_lars_step``) as ``step(batch)`` after an NHWC transpose on
   the card, at most two steps ahead of it.  The step is warmed and
   captured on a zero batch, timed on a synthetic device batch, then the
   counters are zeroed and two streamed epochs (32 steps) timed from
   the first record read to the last step's sync: img/s each epoch
   beside the synthetic rate, the overlap share ``1 - consumer_wait /
   producer_busy``, peak memory and reservation; every loss finite and
   the last below the first; ``bn_relu_apply`` and ``bn_relu_bwd``
   33 x 32 on bf16 rows and ``lars_flat`` 32 on fp32.  Then the card's
   idle share over six profiled streamed steps, the loader's parts each
   timed alone (``read_batch`` native and Python, ``next_np`` at
   0/1/2/4/8 threads, the pinned copy of a 77 MB batch,
   ``DeviceTransform`` and the transpose), a landed batch against ``DeviceTransform``'s plain
   CPU result on its host batch (1 bf16 ulp), which recordio route
   ran and which codecs import; with OpenCV or PIL, 2,048 JPEG records
   at 256x256, quality 90, read with ``rand_crop`` at 1/2/4/8 threads
   and streamed through four steps.  The records were just written; two
   sequential passes over the file show whether the checkout's file
   system serves them at the page cache's pace.

16. the always-on train -> serve loop (ROADMAP item 7), after the
   checkpoint-and-serve phase, outside the sync check (a servable is
   captured while another replays and reads its logits on the host and
   the trainer runs).  (a) ``ContinuousTrainer`` trains ResNet-50 v1
   NHWC fp32 (SGD 0.05/0.9, one synthetic batch of 32 at 224x224,
   seed 0) imperatively on its own thread, 96 steps publishing every 8
   through ``save_training``, after two publish cycles alone; a
   ``RegistryWatcher`` (poll 0.2 s) hot-swaps a second ResNet-50,
   served at buckets 1-32, to each new verified step, while 8
   open-loop clients each send one of 32 seeded images every 20 ms.
   The window's first swap dies at the ``serving.swap`` fail point and
   retries; after the trainer's steps the next publish is torn after
   its commit (``chaos.truncate``) and must be quarantined while the
   previous step keeps serving.  Nothing may be dropped, shed, timed
   out or fail; at least 3 swaps, the served step strictly increasing;
   each answer within 1e-4 of one published step's batch-1 forward
   (restored after the run) and never an older step than its client's
   previous answer; ``bn_relu_apply`` 33 x (trainer steps + executor
   calls + warm-up runs) and ``bn_relu_bwd`` 33 x trainer steps, each
   term from its own counter; ``serving.*`` and ``train_loop.*``
   telemetry equal to the phase's counts.  It prints the swap wall
   (publish committed to step serving), latency p50/p99 steady and
   during swaps as ``bench.py :: bench_serving_hotswap`` splits them,
   requests/s, the trainer's ms/step alone and while serving, and
   ``hbm_plan``'s bucket-32 prediction beside the measured warm-up
   peak.  (b) a ``GenerativeWatcher`` serves GPT-2-small-width
   ``tiny_gpt`` from a checkpoint's ``params`` item; eight streams are
   admitted, step 2 (other weights) is published and swapped in while
   they are mid-decode (each old decode step held at
   ``serving.decode.step`` until the replacement installs), and eight
   more are admitted on it: every stream finishes and equals the
   greedy oracle of the weights it was admitted under, the old engine
   ends with no live sequence, and ``paged_attention`` launches 12 x
   the decode steps of both engines (the new one's warm-up included).
   The kernels line's three rows on these paths carry
   ``launches_hotswap`` and ``launches_generative_swap``.  The hot-swap
   trainer runs with the goodput ledger (window = the publish interval)
   and tracing on: the phase prints its categories a step beside
   serving.

17. the single-process ops plane (ROADMAP item 8) observing ResNet-50
   training, after phase 16, outside the sync check.  (a) the AMP LARS
   step (ResNet-50 v1 NHWC, bf16, LARS, batch 512) with
   ``mx.profiling`` on, twice: two warm-ups (the eager one walked into
   the step's CostReport, then the capture), five timed replays.  The
   report's ``conv_dot`` flops must be within 2% of an independent count
   from the layer shapes (3 x the forward's, less the stem's data
   gradient; a convolution's taps that fall in the padding count no
   work, as XLA counts them), its categories must sum to its totals, and
   ``bn_relu_apply``, ``bn_relu_bwd`` and ``lars_flat`` must appear in
   its provenance with the walked warm-up's launches, equal to the
   registry's launches a replayed step; it prints the roofline and the
   MFU against 989 TFLOP/s; ``mxprof report`` renders the first run's
   file and ``mxprof diff`` of the two runs must name no drift.  (b)
   ``mx.profiler`` over a lead-in and three counted replays of the
   second run: the dumped Chrome trace's device events, grouped by
   graph launch, must name the three kernels inside the replayed graph,
   the counted replays agreeing kernel for kernel, each with every hand
   kernel's launches a step (the lead-in may only lack records: the
   tracer drops those it timestamps before the trace's start);
   ``dumps()`` is printed.
   (c) phase 16's trainer (fp32, batch 32) as a ``ContinuousTrainer``
   without serving, 60 steps publishing every 20, with telemetry into a
   JSONL sink, the goodput ledger (window 10, its flops walked from one
   forward/backward), the leak sentinel, the flight recorder and
   ``obs.serve(port=0)``, and ``memory.leak`` pinning 64 MiB a step from
   step 30: every window must reconcile, the sentinel must flag within
   3 windows of the onset and never before, each window's scrape must
   answer ``/healthz`` 200, ``/metrics`` with the goodput shares and
   live bytes, ``/statusz`` with goodput and memory rows, and
   ``mxtelemetry summarize`` over the sink must count the phase's
   windows, steps and regressions.  (d) ``Supervisor([python, worker],
   1, max_restarts=2)``: the worker is (c)'s trainer, 24 steps
   publishing every 8, with ``chaos.KILL`` at step 13 of generation 0
   (``chaos.arm_from_spec``); generation 1 must resume from step 8 and
   finish, ``run()`` return 0 after one restart, and ``mxtelemetry
   blackbox`` on generation 0's flight file name ``chaos.kill`` and its
   point.  Every artifact lives in a temporary directory.  The kernels
   line's three rows of the AMP LARS step carry ``launches_ops_plane``.

18. multi-process data-parallel training (ROADMAP items 9a and 8b),
   after phase 17, outside the sync check.  First (c)'s oracle: one
   process takes rank 0's initial ResNet-50 v1 NHWC (fp32, TF32 off),
   runs both ranks' step-1 batches (32 each, from a synthetic dataset
   split ``num_parts``/``part_index``-wise) through forward and backward
   in turn, sums the gradients in rank order and takes one SGD step.
   Then the port's ``Supervisor`` starts two ranks of ``dist_worker`` on
   this card (``max_restarts=2``, barrier bound 20 s, lease TTL 4 s),
   each initializing from its own seed, training with
   ``Trainer(kvstore="dist_sync")`` (SGD 0.05/0.9) under
   ``ContinuousTrainer(publish_every=2)`` with the goodput ledger on and
   its own obs server, to step 6; a chaos spec KILLs rank 1 at the
   ``committed`` gate of the step-4 publish in generation 0.  Checks:
   (a) after the initial broadcast every parameter of rank 1 is rank
   0's, bitwise; (b) after every step rank 1's weights and momenta are
   rank 0's, bitwise (each rank writes its digests to its record, and
   this process compares them), and
   each rank launched ``bn_relu_apply`` and ``bn_relu_bwd`` 33 x the
   steps it ran, in fp32; (c) the world's step-1 update is within 1e-6
   (norm-wise) of the oracle's; (d) rank 0 raises a ``BarrierTimeout``
   naming rank 1 and exits 3 through ``failfast_exit`` with step 2 the
   newest and step 4 not visible, the supervisor relaunches generation
   1, both ranks resume from step 2 with weights, momenta and running
   statistics equal to rank 0's step-2 digests, train to step 6, and
   the supervisor returns 0 after one restart; (e) a ``FleetMonitor``
   here polls the endpoint files every 250 ms, and no round raises:
   both ranks up in generation 0, rank 1 presumed down within the lease
   TTL of its death (the chaos KILL's mark in its flight recorder) and
   ``replica_down`` firing, both up in generation 1 on new pids and
   the alert resolved, the goodput skew of the two ranks, ``mxtelemetry
   fleet`` over the live generation 1 (exit 0, both up), and this
   process's ``/alertz`` serving the engine with the resolved alert in
   its history.  It prints each rank's ms a step, the bucketed
   allreduce's ms and bytes a step and its share, the initial broadcast
   and each publish in seconds, kill -> BarrierTimeout and kill -> both
   ranks' first step of generation 1, a scrape round's ms, the alert's
   fire and resolve latencies and each rank's peak memory.  The
   kernels line's ``bn_relu_*`` rows carry ``launches_dist_sync``.

Every path runs from captured CUDA graphs (``mxnet_tpu_torch._capture``),
the port's counterpart of the JAX package's compiled programs: one
graph per decode and prefill bucket, one per ``TrainStep`` key (its
first call runs eagerly, its second captures), the hybridized MNIST
net's forward and backward, one per serving bucket.  The launch counts
above are counted through the replays.  After each path a "captured
..." line gives its graphs, capture seconds, pool bytes, replays, rate
and the device's idle share, and the run fails unless the path
replayed at least one graph per key.  After phase 4 the captured paths
are held against the same work run eagerly ("captured against eager"):
three ``TrainStep`` calls of ResNet-50 fp32 SGD at batch 16 against
three steps of the imperative ``record``/``backward``/``trainer.step``
loop on a copy of the net (losses, weights, momenta), one more step of
each after ``set_learning_rate``, and the MNIST net hybridized against
itself un-hybridized (outputs and gradients under ``record``); then
BERT-base LAMB (dropout 0.1, batch 8 x seq 512) and ResNet-50 bf16 AMP
LARS (batch 16), each four calls of one ``TrainStep`` (eager, captured,
replayed, replayed after ``set_learning_rate``) against four eager
steps on a copy of the net (losses, updates, the last update, every
optimizer state).  Phases 1-15 run under
``_capture.checking_syncs()``: every capture and replay runs under
``torch.cuda.set_sync_debug_mode("error")``, so a host read left inside
a captured region fails it.

The last two lines of standard output are a JSON object of per-kernel
numbers and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside tensor cores
TF32_FLOPS = 495e12                # H100 SXM dense TF32 tensor cores
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
TIE_TOL = 1e-3                     # near-tie: oracle top-2 logit gap below
GPT2_SMALL = dict(vocab_size=50257, units=768, num_layers=12, num_heads=12,
                  max_seq=1024)
BN_RELU_SITES = 33                 # fused sites per ResNet-50 v1 forward
TRAIN_STEPS = 8
# untimed calls before a path's timed window: a TrainStep key's first
# call runs eagerly, its second captures the step's graph
WARM_STEPS = 2
TRAIN_SGD = {"learning_rate": 0.05, "momentum": 0.9}
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
# (H, W, C) of ResNet-50 v1's 33 fused sites at 224: the stem, then the
# two in each bottleneck of the four stages (the stride is on conv1)
RESNET50_SITE_SHAPES = ((112, 112, 64), (56, 56, 64), (28, 28, 128),
                        (14, 14, 256), (7, 7, 512))
BN_EPS = 1e-5
# BatchNorm+ReLU fusion sites a forward of each get_model net with
# layout="NHWC" (the JAX package's fusion plan; tests/test_torch_model_zoo.py
# holds these against it): the zoo sweep's bn_relu_apply launches a forward
ZOO_FUSED_SITES = {
    "alexnet": 0, "densenet121": 121, "densenet161": 161,
    "densenet169": 169, "densenet201": 201, "inceptionv3": 94,
    "mobilenet0.25": 27, "mobilenet0.5": 27, "mobilenet0.75": 27,
    "mobilenet1.0": 27, "mobilenetv2_0.25": 0, "mobilenetv2_0.5": 0,
    "mobilenetv2_0.75": 0, "mobilenetv2_1.0": 0, "resnet101_v1": 67,
    "resnet101_v2": 2, "resnet152_v1": 101, "resnet152_v2": 2,
    "resnet18_v1": 9, "resnet18_v2": 2, "resnet34_v1": 17,
    "resnet34_v2": 2, "resnet50_v1": 33, "resnet50_v2": 2,
    "squeezenet1.0": 0, "squeezenet1.1": 0, "vgg11": 0, "vgg11_bn": 8,
    "vgg13": 0, "vgg13_bn": 10, "vgg16": 0, "vgg16_bn": 13, "vgg19": 0,
    "vgg19_bn": 16,
}
DENSENET_SITES = ZOO_FUSED_SITES["densenet121"]
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


def capture_report(path, stats, rates, idle, graphs_per_key):
    """Print the capture line of a path that runs from CUDA graphs --
    graphs captured, seconds capturing, the bytes its pool took, replays,
    its rate and the device's idle share -- and check that it did: at
    least ``graphs_per_key`` graphs for each of its keys, and replays."""
    keys = stats.get("keys")
    out = {"graphs": stats["graphs"], "capture_s": stats["capture_s"],
           "pool_bytes": stats["pool_bytes"], "replays": stats["replays"],
           "keys": len(keys) if keys is not None else None, **rates,
           "device_idle_share": idle, "card": gpu_line()}
    print("captured %s: %s" % (path, json.dumps(out)))
    n_keys = len(keys) if keys is not None else 1
    check(stats["graphs"] >= graphs_per_key * n_keys,
          "%s: %d graphs for %d keys" % (path, stats["graphs"], n_keys))
    check(stats["replays"] > 0, "%s never replayed a graph" % path)
    return out


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
# phase 12: paged_attention against its plain version
# ---------------------------------------------------------------------

EDGE_CONTEXTS = (0, 1, 15, 16, 17, 333, 1000, 1024)
DECODE_PROMPT_LENGTHS = (5, 21, 37, 54, 70, 87, 103, 120)
DECODE_MAX_NEW = 32
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
    # one slot, as decode from a checkpoint runs it (one request at a
    # time): every context its prompts and steps reach
    ckpt_err = {}
    lo = min(DECODE_PROMPT_LENGTHS)
    hi = max(DECODE_PROMPT_LENGTHS) + DECODE_MAX_NEW
    for name, kv_dtype, atol in (("float32", torch.float32, 1e-4),
                                 ("bfloat16", torch.bfloat16, 2e-2)):
        q, k, v, bt, _ = paged_attention_inputs(kv_dtype, seed=1,
                                                contexts=(hi,))
        worst = 0.0
        for c in range(lo, hi + 1):
            ctx = torch.full((1, 1), c, dtype=torch.int32, device="cuda")
            got = paged_attention_cuda(q, k, v, bt, ctx, scale=scale)
            want = paged_attention_reference(q, k, v, bt, ctx, scale=scale)
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= atol,
                  "paged_attention one slot (%s cache) at context %d: max "
                  "|kernel - plain| = %g > atol %g" % (name, c, err, atol))
            worst = max(worst, err)
        ckpt_err[name] = worst
        result[name] = max(result[name], worst)
    print("paged_attention one slot at contexts %d..%d: max_abs_err %s"
          % (lo, hi, json.dumps(ckpt_err)))
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
    prompts = [rng.integers(0, model.vocab_size, n).tolist()
               for n in DECODE_PROMPT_LENGTHS]
    max_new = DECODE_MAX_NEW
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
        bd = decode_step_breakdown(sv.engine)
        eng = sv.engine
        capture_report("decode (GPT-2 small widths)", eng.capture_stats(),
                       {"tokens_per_s": stats["tokens_per_s"],
                        "step_wall_ms": bd["step_wall_ms"]},
                       bd["device_idle_share"], 1)
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
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)


def train_main_path(make_net=resnet50_nhwc, batch=128, image=224,
                    steps=TRAIN_STEPS, sites=BN_RELU_SITES, device="cuda",
                    label="training main path (ResNet-50 v1 NHWC fp32, "
                          "SGD 0.05/0.9)", peak_with_warmup=False):
    """Train ``make_net()`` for ``steps`` SGD steps on one repeated
    synthetic batch after WARM_STEPS warm-up steps (eager, then
    captured); the launch counters are zeroed after the warm-up and read
    after the last step.  The peak memory is the timed steps' own, or
    with ``peak_with_warmup`` the whole run's (the eager step and the
    graph's pool included)."""
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
    if cuda and peak_with_warmup:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):     # eager, then captured
        step(x, y)
    if cuda:
        torch.cuda.synchronize()
        if not peak_with_warmup:
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
    print("%s: %s" % (label, json.dumps(stats)))
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
    before = {k: p.data()._data.detach().cpu().double()
              for k, p in params.items()}
    loss = float(make_train_step(net)(x, y))
    after = {k: p.data()._data.detach().cpu().double()
             for k, p in params.items()}
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


def train_oracle(net, make_net=resnet50_nhwc, batch=8, image=224,
                 label="training oracle (card vs CPU)", floor_factor=None):
    """One ``TrainStep`` of ``net`` (on the card: the kernels) and of a
    CPU copy with the same weights (the plain versions), on the same
    batch.  A third step, on the CPU with the batch permuted, computes
    the same function in another fp32 summation order: its distance
    from the CPU step is the noise floor the card is read against.
    With ``floor_factor``, a parameter's own update is held to the
    larger of the worst-entry limit and ``floor_factor`` times its own
    floor: one whose update the permuted CPU step already moves past the
    limit (rounding carried back through many BatchNorms) is held to
    its noise, not to a limit the CPU cannot meet."""
    import torch
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    arrays = {p.name: p.data()._data.detach().cpu().numpy()
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
    limits = dict(ORACLE_LIMITS)
    by_floor = {}
    if floor_factor is not None:
        worst_limit = limits.pop("update_rel_err_worst")
        ratio = 0.0
        for k, want in u_cpu.items():
            n = float(want.norm())
            if _is_conv_bias(k) or n == 0:
                continue
            err = float((u_card[k] - want).norm()) / n
            fl = float((u_perm[k] - want).norm()) / n
            lim = max(worst_limit, floor_factor * fl)
            ratio = max(ratio, err / lim)
            if lim > worst_limit:
                by_floor[k] = [err, fl]
        limits["update_worst_over_limit"] = 1.0
    stat_err = max(float((s_card[k] - s_cpu[k]).norm() / s_cpu[k].norm())
                   for k in s_cpu)
    bias_err = max((float((u_card[k] - u_cpu[k]).abs().max())
                    for k in u_cpu if _is_conv_bias(k)), default=0.0)
    out = {"batch": batch, "loss_card": l_card, "loss_cpu": l_cpu,
           "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
           "update_rel_err": glob, "update_rel_err_worst": worst,
           "update_worst_param": worst_name,
           "floor_update_rel_err": floor,
           "floor_update_rel_err_worst": floor_worst,
           "floor_loss_rel_err": abs(l_perm - l_cpu) / abs(l_cpu),
           "running_stat_rel_err": stat_err, "conv_bias_abs_err": bias_err,
           "limits": limits}
    if floor_factor is not None:
        out.update(update_worst_over_limit=ratio, floor_factor=floor_factor,
                   held_by_their_floor=by_floor)
    print("%s: %s" % (label, json.dumps(out)))
    check(np.isfinite(l_card), "%s: loss on the card is not finite" % label)
    for key, limit in limits.items():
        check(out[key] <= limit, "%s: %s %.3g > limit %g"
              % (label, key, out[key], limit))
    return out


# ---------------------------------------------------------------------
# the captured paths held against the same work run eagerly
# ---------------------------------------------------------------------

# A replayed graph runs the kernels the eager call runs, on the same
# inputs, under cuDNN's deterministic algorithms: the captured
# TrainStep's losses, weights and momenta stay within 1e-6 of the
# imperative loop's (relative, norm-wise over all parameters; fp32 sums
# of the update taken in another order by the bucket of scalars fed from
# the device); the step after set_learning_rate within 1e-4 of the
# imperative step's update (a graph that kept the old lr, 0.05 for
# 0.01, would be 4x off); the hybridized MNIST net's outputs and
# gradients within 1e-6 of the un-hybridized net's, relative to the
# larger of 1 and each tensor's largest value
CAPTURE_HOLD_LIMITS = {"loss_rel_err": 1e-6, "weights_rel_err": 1e-6,
                       "momenta_rel_err": 1e-6,
                       "new_lr_update_rel_err": 1e-4,
                       "hybrid_out_rel_err": 1e-6,
                       "hybrid_grad_rel_err": 1e-6}
CAPTURE_HOLD_BATCH = 16
CAPTURE_HOLD_STEPS = 3


def _norm_rel(a, b):
    num = sum(float((x - y).double().norm()) ** 2 for x, y in zip(a, b))
    den = sum(float(y.double().norm()) ** 2 for y in b)
    return (num / den) ** 0.5


def capture_holds(make_net=resnet50_nhwc, batch=CAPTURE_HOLD_BATCH,
                  image=224, steps=CAPTURE_HOLD_STEPS, device="cuda"):
    """Three ``TrainStep`` calls of ResNet-50 fp32 SGD (the first eager,
    the second captured, the third replayed) against three steps of the
    imperative ``record``/``backward``/``trainer.step`` loop on a copy
    of the net; then ``set_learning_rate(0.01)`` on both and one more
    step each; then the MNIST net hybridized against itself
    un-hybridized, forward and gradients under ``record``."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.parallel import TrainStep
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nets = []
        for _ in range(2):
            n = make_net()
            n.initialize(device=device,
                         generator=torch.Generator().manual_seed(0))
            nets.append(n)
        net, ref = nets
        gen = torch.Generator(device=device).manual_seed(3)
        x = torch.randn((batch, image, image, 3), generator=gen,
                        device=device)
        y = torch.randint(0, net.output._units, (batch,), generator=gen,
                          device=device).float()
        tr = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
        step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        rtr = gluon.Trainer(ref.collect_params(), "sgd", TRAIN_SGD)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def imperative():
            with autograd.record():
                loss = loss_fn(ref(x), y)
            loss.sum().backward()
            rtr.step(batch)
            return float(loss.detach().mean())

        def weights(n):
            return [p.data()._data.detach().clone()
                    for p in n.collect_params().values()]

        got = [float(step(x, y)) for _ in range(steps)]
        want = [imperative() for _ in range(steps)]
        w_c, w_r = weights(net), weights(ref)
        live = sorted(tr._updater.states)
        m_c = [tr._updater.states[i] for i in live]
        m_r = [rtr._updater.states[i] for i in live]
        out = {"batch": batch, "steps": steps, "losses_captured": got,
               "losses_imperative": want,
               "loss_rel_err": max(abs(a - b) / abs(b)
                                   for a, b in zip(got, want)),
               "weights_rel_err": _norm_rel(w_c, w_r),
               "momenta_rel_err": _norm_rel(m_c, m_r)}
        tr.set_learning_rate(0.01)
        rtr.set_learning_rate(0.01)
        step(x, y)
        imperative()
        u_c = [a - b for a, b in zip(weights(net), w_c)]
        u_r = [a - b for a, b in zip(weights(ref), w_r)]
        out["new_lr_update_rel_err"] = _norm_rel(u_c, u_r)
        cap = step.capture_stats()
        out["train_step_graphs"] = cap["graphs"]
        cuda = device == "cuda"
        check(not cuda or (cap["graphs"] == 1
                           and cap["replays"] == steps),
              "hold: TrainStep graphs %d, replays %d"
              % (cap["graphs"], cap["replays"]))
        del step, net, ref, nets, x, y

        # the MNIST net, hybridized against itself un-hybridized
        import mxnet_tpu_torch as mx
        ctx = mx.gpu() if cuda else mx.cpu()
        hyb, _t, _l = mnist_setup(ctx, seed=4)
        eager, _t, _l = mnist_setup(ctx, seed=4)
        hyb.hybridize()
        rng = np.random.default_rng(4)
        worst_out = worst_grad = 0.0
        # the first call sizes the deferred parameters, the second runs
        # eagerly, the third captures, the fourth replays
        for _ in range(4):
            xb = mx.nd.array(rng.random((MNIST_BATCH, 1, 28, 28)).astype(
                np.float32), ctx=ctx)
            outs = []
            for n in (hyb, eager):
                with autograd.record(train_mode=False):
                    o = n(xb)
                    loss = (o * o).sum()
                loss.backward()
                outs.append(o._data.detach())
            worst_out = max(worst_out, rel_err(outs[0], outs[1]))
            for a, b in zip(hyb.collect_params().values(),
                            eager.collect_params().values()):
                worst_grad = max(worst_grad, rel_err(a._data.grad,
                                                     b._data.grad))
        out["hybrid_out_rel_err"] = worst_out
        out["hybrid_grad_rel_err"] = worst_grad
        out["hybrid_graphs"] = hyb.cache_stats()["graphs"]
        check(not cuda or out["hybrid_graphs"][str(
            ctx.torch_device())]["graphs"] == 2,
              "hold: the hybridized MNIST net has %s graphs"
              % out["hybrid_graphs"])
    finally:
        torch.backends.cudnn.deterministic = prev
    out["limits"] = CAPTURE_HOLD_LIMITS
    print("captured against eager (ResNet-50 fp32 SGD TrainStep, MNIST "
          "hybridized): %s" % json.dumps(out))
    for key, limit in CAPTURE_HOLD_LIMITS.items():
        check(out[key] <= limit, "capture hold: %s %.3g > limit %g"
              % (key, out[key], limit))
    return out


# The bucketed LAMB and LARS updates read lr, wd, rescale_grad, the
# update count t and LAMB's bias corrections from a device tensor that
# each step refreshes.  Four calls of one TrainStep (eager, captured,
# replayed, replayed after set_learning_rate(lr / 4)) are held against
# four eager steps, a fresh TrainStep each, on a copy of the net:
# losses, the whole update, the last step's update and every optimizer
# state, relative and norm-wise.  The same kernels run on the same
# inputs and dropout draws the same masks (the port's generator
# reseeded before each run, a replay drawing at the offset an eager
# step would).  What is left is the order of fp32 atomics (the flash
# backward's dq), so a second eager run gives the floor, and each
# error is held to the larger of its limit here and
# BUCKET_HOLD_FACTOR times its floor.  ResNet-50's LARS step has no
# atomics: floor 0, captured bitwise.  BERT's floor on an H100 80GB
# HBM3 at 700 W was 3.0e-5 for the update and 6.3e-5 for the last one;
# a graph that kept the old lr is off by O(1) in the last update.
# As in the BERT oracle, the key third of each qkv_bias is held apart
# (printed, no limit): its exact gradient is 0, so LAMB normalizes
# rounding noise into an update of lr's size (0.35-0.41 apart run to
# run)
BUCKET_HOLD_LIMITS = {"loss_rel_err": 1e-5, "update_rel_err": 1e-5,
                      "last_update_rel_err": 1e-5,
                      "states_rel_err": 1e-5}
BUCKET_HOLD_FACTOR = 4.0
BUCKET_HOLD_BERT_BATCH = 8
BUCKET_HOLD_LARS_BATCH = 16


def _hold_run(make_net, opt, hyper, x, y, loss_fn, captured, bf16, units,
              device):
    """Four ``TrainStep`` calls (one step object, or a fresh one each
    call) from seeded weights; the losses, updates and states."""
    import torch
    from mxnet_tpu_torch import amp, autograd, gluon, random
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.data_parallel import _tensors

    def weights(net):
        return {k: p.data()._data.detach().clone()
                for k, p in net._collect_params_with_prefix().items()}

    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        net(x[:1])                      # sizes deferred parameters
    hyper = hyper() if callable(hyper) else dict(hyper)
    tr = gluon.Trainer(net.collect_params(), opt, hyper)
    random.seed(5)
    step = TrainStep(net, loss_fn, tr)
    w0 = weights(net)
    losses = []
    for k in range(4):
        if k == 3:
            tr.set_learning_rate(hyper["learning_rate"] / 4)
            w3 = weights(net)
        if not captured:
            step = TrainStep(net, loss_fn, tr)
        with amp.scope("bfloat16") if bf16 else contextlib.nullcontext():
            losses.append(float(step(x, y)))
    w4 = weights(net)
    states = [t.detach().clone() for i in sorted(tr._updater.states)
              for t in _tensors(tr._updater.states[i])]
    update, key = split_key_bias({k: w4[k] - w0[k] for k in w0}, units)
    last, _ = split_key_bias({k: w4[k] - w3[k] for k in w0}, units)
    return {"losses": losses, "update": update, "last": last, "key": key,
            "states": states,
            "capture": step.capture_stats() if captured else None}


def _hold_errors(got, want):
    names = sorted(want["update"])
    worst = max(names, key=lambda k: float(
        (got["last"][k] - want["last"][k]).norm())
        / max(float(want["last"][k].norm()), 1e-30))
    out = {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
               got["losses"], want["losses"])),
           "update_rel_err": _norm_rel([got["update"][k] for k in names],
                                       [want["update"][k] for k in names]),
           "last_update_rel_err": _norm_rel(
               [got["last"][k] for k in names],
               [want["last"][k] for k in names]),
           "last_update_worst_tensor": worst,
           "last_update_worst_tensor_rel_err": _norm_rel(
               [got["last"][worst]], [want["last"][worst]]),
           "states_rel_err": _norm_rel(got["states"], want["states"])}
    if want["key"]:
        keys = sorted(want["key"])
        out["key_bias_update_rel_err"] = _norm_rel(
            [got["key"][k] for k in keys], [want["key"][k] for k in keys])
    return out


def _bucketed_hold(make_net, opt, hyper, x, y, loss_fn, bf16=False,
                   units=768, device="cuda"):
    """Four calls of one ``TrainStep`` against four eager steps, and a
    second eager run against the first for the floor (see
    BUCKET_HOLD_LIMITS); returns the errors, floors and limits."""
    import torch
    runs = []
    for captured in (True, False, False):
        runs.append(_hold_run(make_net, opt, hyper, x, y, loss_fn, captured,
                              bf16, units, device))
        torch.cuda.empty_cache()
    got, want, again = runs
    cap = got["capture"]
    check(cap["graphs"] == 1 and cap["replays"] == 3,
          "hold: %s TrainStep graphs %d, replays %d"
          % (opt, cap["graphs"], cap["replays"]))
    floor = _hold_errors(again, want)
    out = dict(_hold_errors(got, want), losses_captured=got["losses"],
               losses_eager=want["losses"], graphs=cap["graphs"],
               replays=cap["replays"], floor=floor)
    out["limits"] = {k: max(v, BUCKET_HOLD_FACTOR * floor[k])
                     for k, v in BUCKET_HOLD_LIMITS.items()}
    return out


def bucketed_holds(device="cuda"):
    """BERT-base LAMB (dropout 0.1, batch 8 x seq 512: the main path's
    LAMB bucket of 133,547,324 elements) and ResNet-50 bf16 AMP LARS
    (batch 16 at 224: the main path's LARS bucket), four captured
    ``TrainStep`` calls against four eager steps each, beside the floor
    of two eager runs."""
    import torch
    from mxnet_tpu_torch import gluon
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        gen = torch.Generator(device=device).manual_seed(6)
        ids = torch.randint(0, BERT_VOCAB, (BUCKET_HOLD_BERT_BATCH, BERT_SEQ),
                            generator=gen, device=device).float()
        labels = torch.randint(0, BERT_VOCAB, ids.shape, generator=gen,
                               device=device).float()
        out["bert_lamb"] = _bucketed_hold(
            bert_base_net, "lamb", BERT_LAMB, ids, labels,
            make_mlm_loss(BERT_VOCAB), device=device)
        del ids, labels
        x = torch.randn((BUCKET_HOLD_LARS_BATCH, 224, 224, 3),
                        generator=gen, device=device)
        y = torch.randint(0, 1000, (BUCKET_HOLD_LARS_BATCH,),
                          generator=gen, device=device).float()
        out["resnet50_amp_lars"] = _bucketed_hold(
            resnet50_nhwc, "lars", LARS_HYPER, x, y,
            gluon.loss.SoftmaxCrossEntropyLoss(), bf16=True,
            device=device)
    finally:
        torch.backends.cudnn.deterministic = prev
    out["card"] = gpu_line()
    print("captured against eager (BERT LAMB, ResNet-50 bf16 AMP LARS "
          "TrainStep): %s" % json.dumps(out))
    for path in ("bert_lamb", "resnet50_amp_lars"):
        for key, limit in out[path]["limits"].items():
            check(out[path][key] <= limit,
                  "capture hold %s: %s %.3g > limit %g"
                  % (path, key, out[path][key], limit))
    return out


# ---------------------------------------------------------------------
# phases 10-11: the LeNet/MNIST path (examples/gluon_mnist.py) and its oracle
# ---------------------------------------------------------------------

MNIST_BATCH = 128
MNIST_SGD = {"learning_rate": 0.05, "momentum": 0.9}
MNIST_HYBRID_BATCHES = 100
MNIST_PROFILED_BATCHES = 20
# one fixed batch of random labels, trained on alone: a learning net
# memorises it.  At the example's width, dropout on, 60 steps cut the
# loss 152-277x on the CPU; with a gradient planted wrong the cut is
# 1.3x (conv gradients zeroed), 2.6x (conv gradients x0.1), 1.1x (first
# Dense gradient zeroed), 1.06x (all x0.1), 5.7x (all x0.5) and 66x
# (conv gradients x0.5, the one fault left to the oracle).  The limit
# sits between, 3.8x under the lowest sound reading.
MNIST_MEMORISE_STEPS = 60
MNIST_MEMORISE_FACTOR = 40.0
# card-vs-CPU limits of the one-step oracle (fresh Xavier net, batch 8,
# dropout off).  The loss is held to the ResNet oracle's 1e-5; the
# updates, together and each parameter's alone, to 1e-4, not the
# ResNet's 2e-2: this net has no BatchNorm, and its fp32 floor (the CPU
# step with the batch permuted, printed beside) is 6.1e-7-6.6e-7
# together and 1.7e-6-2.0e-6 for the worst parameter on the CPU
MNIST_ORACLE_LIMITS = {"loss_rel_err": 1e-5, "update_rel_err": 1e-4,
                       "update_rel_err_worst": 1e-4}
# a root with no idx files: the synthetic fallback, byte for byte the
# JAX package's (seed 42)
MNIST_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "mnist-synthetic")


def mnist_net():
    """``examples/gluon_mnist.py :: build_net`` on the port (NCHW)."""
    from mxnet_tpu_torch import gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(32, kernel_size=3, activation="relu"),
            gluon.nn.Conv2D(64, kernel_size=3, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dropout(0.5),
            gluon.nn.Dense(10))
    return net


def mnist_loader(batch=MNIST_BATCH, root=MNIST_ROOT):
    """The example's train loader: synthetic MNIST, each image scaled
    into a (1, 28, 28) float32 NDArray on the CPU, shuffled batches,
    the last partial batch dropped."""
    import mxnet_tpu_torch as mx
    ds = mx.gluon.data.vision.MNIST(root=root, train=True)
    check(ds.synthetic and len(ds) == 60000,
          "MNIST: expected the synthetic train set under %s" % root)
    return mx.gluon.data.DataLoader(
        ds.transform_first(lambda d: mx.nd.array(
            d.asnumpy().reshape(1, 28, 28) / 255.0, ctx=mx.cpu())),
        batch_size=batch, shuffle=True, last_batch="discard")


def mnist_setup(ctx, seed=0):
    import torch
    import mxnet_tpu_torch as mx
    net = mnist_net()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(seed))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", MNIST_SGD)
    return net, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss()


MNIST_SPLIT = ("copy", "forward", "backward", "trainer_step",
               "metric_update")


def mnist_loop(net, trainer, loss_fn, loader, ctx, max_batches=0):
    """``examples/gluon_mnist.py``'s epoch loop through the public API:
    the per-batch mean loss (read after the loop), host seconds waiting
    on ``next(loader)`` and a step each, the step's host seconds by part
    (MNIST_SPLIT: the copy to the card, forward, backward, ``trainer.
    step``, and ``metric.update``, which reads the outputs on the host
    and so waits for the card), the metric and the wall time."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    metric = mx.metric.Accuracy()
    losses, step_s, wait_s = [], [], 0.0
    split = dict.fromkeys(MNIST_SPLIT, 0.0)
    it = iter(loader)
    t_start = time.perf_counter()
    while not max_batches or len(losses) < max_batches:
        t0 = time.perf_counter()
        try:
            data, label = next(it)
        except StopIteration:
            break
        marks = [time.perf_counter()]
        wait_s += marks[0] - t0
        data = data.as_in_context(ctx)
        label = label.as_in_context(ctx)
        marks.append(time.perf_counter())
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        marks.append(time.perf_counter())
        loss.backward()
        marks.append(time.perf_counter())
        trainer.step(data.shape[0])
        marks.append(time.perf_counter())
        metric.update([label], [out])
        marks.append(time.perf_counter())
        losses.append(loss.mean()._data)
        step_s.append(marks[-1] - marks[0])
        for part, a, b in zip(MNIST_SPLIT, marks, marks[1:]):
            split[part] += b - a
    losses = torch.stack(losses).cpu().tolist()
    wall = time.perf_counter() - t_start
    split = {k: 1e3 * v / max(1, len(losses)) for k, v in split.items()}
    return losses, step_s, wait_s, split, metric, wall


def mnist_main_path(ctx=None, epoch_batches=0,
                    hybrid_batches=MNIST_HYBRID_BATCHES,
                    memorise_steps=MNIST_MEMORISE_STEPS,
                    profiled=MNIST_PROFILED_BATCHES):
    """One epoch of the example's loop unhybridized (468 batches of
    128), then ``hybrid_batches`` hybridized, on ``ctx`` (the card by
    default); every loss must be finite and the accuracy in [0, 1].
    Then ``profiled`` more batches under ``torch.profiler`` give the
    device time a step, and a fresh net memorises one fixed batch.
    The launch counters are zeroed before and read after (this path
    has no hand kernel: every count stays 0)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import registry
    ctx = mx.gpu() if ctx is None else ctx
    cuda = ctx.device_type == "gpu"
    np.random.seed(0)
    loader = mnist_loader()
    net, trainer, loss_fn = mnist_setup(ctx)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    losses, step_s, wait_s, split, metric, wall = mnist_loop(
        net, trainer, loss_fn, loader, ctx, epoch_batches)
    name, acc = metric.get()
    n = len(losses)
    check(n == (epoch_batches or 60000 // MNIST_BATCH),
          "MNIST epoch ran %d batches" % n)
    check(all(np.isfinite(losses)), "MNIST: non-finite loss in the epoch")
    check(0.0 <= acc <= 1.0, "MNIST: accuracy %r outside [0, 1]" % acc)
    net.hybridize()
    # untimed: the hybridized entry's first batch runs eagerly, its
    # second captures the forward and backward graphs
    mnist_loop(net, trainer, loss_fn, loader, ctx, WARM_STEPS)
    h_losses, h_step_s, h_wait_s, _split, h_metric, h_wall = mnist_loop(
        net, trainer, loss_fn, loader, ctx, hybrid_batches)
    check(len(h_losses) == hybrid_batches
          and all(np.isfinite(h_losses)),
          "MNIST hybridized: %d batches, losses %s" % (len(h_losses),
                                                        h_losses[-3:]))
    launches = {k: registry.launches(k) for k in registry.list_kernels()}
    if cuda:
        cache = net.cache_stats()
        check(len(cache["keys"]) == 1 and cache["graphs"][str(
            ctx.torch_device())]["graphs"] == 2,
              "MNIST hybridized: keys %s, graphs %s (want one key, its "
              "forward and backward)" % (cache["keys"], cache["graphs"]))
    stats = {"batch": MNIST_BATCH, "epoch_batches": n,
             "samples_per_s": n * MNIST_BATCH / wall, "epoch_s": wall,
             "ms_per_step_median": 1e3 * float(np.median(step_s)),
             "ms_per_batch": 1e3 * wall / n,
             "loader_wait_share": wait_s / wall,
             "loader_wait_ms_per_batch": 1e3 * wait_s / n,
             "step_host_ms_per_batch": split,
             "accuracy": acc, "loss_first": losses[0],
             "loss_last": losses[-1],
             "hybridized": {"batches": len(h_losses),
                            "samples_per_s": len(h_losses) * MNIST_BATCH
                            / h_wall,
                            "ms_per_step_median":
                            1e3 * float(np.median(h_step_s)),
                            "loader_wait_share": h_wait_s / h_wall,
                            "accuracy": h_metric.get()[1]},
             "hand_kernel_launches": launches,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "card": gpu_line() if cuda else None}
    if cuda:
        stats["breakdown"] = mnist_breakdown(net, trainer, loss_fn, loader,
                                             ctx, profiled,
                                             1e3 * wall / n)
        stats["device_idle_share"] = stats["breakdown"]["device_idle_share"]
        h_ms = 1e3 * h_wall / len(h_losses)
        cache = net.cache_stats()
        owner = dict(cache["graphs"][str(ctx.torch_device())],
                     keys=cache["keys"])
        capture_report(
            "MNIST hybridized (forward and backward graphs)", owner,
            {"samples_per_s": len(h_losses) * MNIST_BATCH / h_wall,
             "ms_per_batch": h_ms},
            1 - stats["breakdown"]["device_busy_ms_per_batch"] / h_ms, 2)
    print("MNIST main path (examples/gluon_mnist.py, batch 128, SGD "
          "0.05/0.9): %s" % json.dumps(stats))
    stats["memorise"] = mnist_memorise(ctx, loader, memorise_steps)
    return stats


def mnist_breakdown(net, trainer, loss_fn, loader, ctx, batches,
                    batch_ms):
    """Device time a batch of the loop from ``torch.profiler`` over
    ``batches`` batches, by kernel category, and the device's idle share
    against the unprofiled epoch's wall time a batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mnist_loop(net, trainer, loss_fn, loader, ctx, batches)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0) / batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time in the MNIST loop")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / batches
    by_cat = {}
    for e in kernels:
        cat = kernel_category(e.key)
        ms_, n_ = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms_ + e.self_device_time_total / 1e3 / batches,
                       n_ + e.count / batches)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"batches": batches, "device_busy_ms_per_batch": busy,
            "launches_per_batch": sum(e.count for e in kernels) / batches,
            "batch_ms_unprofiled": batch_ms,
            "batch_ms_profiled": profiled_ms,
            "device_idle_share": max(0.0, 1 - busy / batch_ms),
            "by_category_ms_per_batch": {k: [v[0], v[1]] for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1][0])},
            "top_kernels": [[e.key[:64], e.self_device_time_total / 1e3
                             / batches, e.count / batches] for e in top]}


def mnist_memorise(ctx, loader, steps=MNIST_MEMORISE_STEPS):
    """A fresh net trained on one fixed batch (dropout on): the loss
    must fall by MNIST_MEMORISE_FACTOR, every loss finite."""
    from mxnet_tpu_torch import autograd
    np.random.seed(1)
    data, label = next(iter(loader))
    data, label = data.as_in_context(ctx), label.as_in_context(ctx)
    net, trainer, loss_fn = mnist_setup(ctx, seed=1)
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(data.shape[0])
        losses.append(float(loss.mean().asscalar()))
    out = {"steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
           "factor": losses[0] / losses[-1],
           "limit": MNIST_MEMORISE_FACTOR}
    print("MNIST memorisation (one batch of 128, %d steps): %s"
          % (steps, json.dumps(out)))
    check(all(np.isfinite(losses)), "MNIST memorisation: non-finite loss")
    check(out["factor"] >= MNIST_MEMORISE_FACTOR,
          "MNIST memorisation: loss fell %.3gx < %gx" % (
              out["factor"], MNIST_MEMORISE_FACTOR))
    return out


def mnist_oracle_step(net, x, y, ctx):
    """One SGD step of ``net`` on ``ctx`` from a fresh trainer under
    ``record(train_mode=False)``: (loss, {name: w' - w}) by structural
    name."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    params = net._collect_params_with_prefix()
    before = {k: p.data()._data.detach().cpu().double()
              for k, p in params.items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", MNIST_SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data = mx.nd.array(x, ctx=ctx)
    label = mx.nd.array(y, ctx=ctx)
    with autograd.record(train_mode=False):
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(len(x))
    updates = {k: p.data()._data.detach().cpu().double() - before[k]
               for k, p in params.items()}
    return float(loss.mean().asscalar()), updates


def mnist_oracle(ctx=None, batch=8, seed=2):
    """One step of a fresh Xavier net (seed ``seed``: live, so every
    parameter's update is nonzero) on the card and of a CPU copy, on the
    same synthetic batch with dropout off: the loss, the updates
    together and every parameter's update alone must agree.  A third
    step, on the CPU with the batch permuted, is the fp32 floor."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    ctx = mx.gpu() if ctx is None else ctx
    net = mnist_net()
    net.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    ds = mx.gluon.data.vision.MNIST(root=MNIST_ROOT, train=False)
    x = (ds._data[:batch].reshape(batch, 1, 28, 28) / 255.0).astype(
        np.float32)
    y = ds._label[:batch]
    net(mx.nd.array(x, ctx=mx.cpu()))            # settle deferred shapes
    arrays = {k: p.data()._data.detach().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}

    def copy_on(c):
        n = mnist_net()
        n.initialize(ctx=c)
        params_from_numpy(n, arrays)
        return n

    perm = np.random.default_rng(1).permutation(batch)
    l_cpu, u_cpu = mnist_oracle_step(copy_on(mx.cpu()), x, y, mx.cpu())
    l_perm, u_perm = mnist_oracle_step(copy_on(mx.cpu()), x[perm], y[perm],
                                       mx.cpu())
    l_card, u_card = mnist_oracle_step(copy_on(ctx), x, y, ctx)
    glob, worst, worst_name = rel_errors(u_card, u_cpu)
    floor, floor_worst, floor_name = rel_errors(u_perm, u_cpu)
    norms = {k: float(u.norm()) for k, u in u_cpu.items()}
    out = {"batch": batch, "seed": seed, "params": len(u_cpu),
           "loss_card": l_card, "loss_cpu": l_cpu,
           "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
           "update_rel_err": glob, "update_rel_err_worst": worst,
           "update_worst_param": worst_name,
           "floor_loss_rel_err": abs(l_perm - l_cpu) / abs(l_cpu),
           "floor_update_rel_err": floor,
           "floor_update_rel_err_worst": floor_worst,
           "floor_worst_param": floor_name,
           "update_norm_min": min(norms.values()),
           "limits": MNIST_ORACLE_LIMITS}
    print("MNIST oracle (card vs CPU): %s" % json.dumps(out))
    check(np.isfinite(l_card), "MNIST oracle loss on the card not finite")
    dead = sorted(k for k, n in norms.items() if not n > 0)
    check(not dead, "MNIST oracle: no update to compare for %s" % dead)
    for key, limit in MNIST_ORACLE_LIMITS.items():
        check(out[key] <= limit, "MNIST oracle: %s %.3g > limit %g"
              % (key, out[key], limit))
    return out


# ---------------------------------------------------------------------
# phase 12: fused BN+ReLU kernels against their plain versions
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


def bn_relu_shape_times(shape, dtype):
    """Kernel, plain and library times of both fused passes at one NHWC
    site ``shape``, with their bounds: ``{"fwd": {...}, "bwd": {...}}``.
    The library calls run on NCHW views of the same channels-last
    memory: eval ``F.batch_norm`` + ``relu_``, and ``threshold_backward``
    + ``native_batch_norm_backward``."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.fused_bn_relu import (
        bn_relu_apply_cuda, bn_relu_apply_reference, bn_relu_bwd_cuda,
        bn_relu_bwd_reference)
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    t = bn_relu_inputs(shape, dtype)
    x, y, dy = t["x"], t["y"], t["dy"]
    x4, y4, dy4 = (v.view(shape).permute(0, 3, 1, 2) for v in (x, y, dy))
    inv = t["bwd"][2]

    def lib_fwd():
        out = F.batch_norm(x4, t["mean"], t["var"], t["gamma"], t["beta"],
                           False, 0.0, BN_EPS)
        return out.relu_()

    def lib_bwd():
        g = torch.ops.aten.threshold_backward(dy4, y4, 0)
        return torch.ops.aten.native_batch_norm_backward(
            g, x4, t["gamma"], None, None, t["mean"], inv, True, BN_EPS,
            [True, True, True])

    out = {"fwd": {"ms": time_ms(lambda: bn_relu_apply_cuda(
                       x, t["scale"], t["offset"])),
                   "plain_ms": time_ms(lambda: bn_relu_apply_reference(
                       x, t["scale"], t["offset"])),
                   "library_ms": time_ms(lib_fwd)},
           "bwd": {"ms": time_ms(lambda: bn_relu_bwd_cuda(x, dy, y,
                                                          *t["bwd"])),
                   "plain_ms": time_ms(lambda: bn_relu_bwd_reference(
                       x, dy, y, *t["bwd"])),
                   "library_ms": time_ms(lib_bwd)}}
    # forward: x read, out written, 2 vectors, fma + max;
    # backward: x, dy, y read, dx written, 5 vectors, ~8 flops
    size = x.element_size()
    for kind, passes, vectors, flops in (("fwd", 2, 2, 3),
                                         ("bwd", 4, 5, 8)):
        bound, by, nbytes = bn_relu_bound(rows, c, size, passes, vectors,
                                          flops)
        out[kind].update(bound_ms=bound, bound_by=by, bytes=nbytes)
    del t, x, y, dy, x4, y4, dy4
    return out


# kernel-vs-plain tolerance of the fused passes, relative to the largest
# output: fp32 differs by FMA contraction; bf16 by one rounding step of
# the stored result
BN_RELU_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def bn_relu_errors(shape, dtype, seed=0, kinds=("fwd", "bwd")):
    """Both fused passes at NHWC site ``shape`` against their plain
    versions: ``{kind: (max |kernel - plain|, limit)}``; fails past the
    limit."""
    import torch
    from mxnet_tpu_torch.ops.fused_bn_relu import (
        bn_relu_apply_cuda, bn_relu_bwd_cuda, bn_relu_bwd_reference)
    key = str(dtype).split(".")[-1]
    t = bn_relu_inputs(shape, dtype, seed=seed)
    pairs = {"fwd": lambda: (bn_relu_apply_cuda(t["x"], t["scale"],
                                                t["offset"]), t["y"]),
             "bwd": lambda: (bn_relu_bwd_cuda(t["x"], t["dy"], t["y"],
                                              *t["bwd"]),
                             bn_relu_bwd_reference(t["x"], t["dy"], t["y"],
                                                   *t["bwd"]))}
    out = {}
    for kind in kinds:
        got, want = pairs[kind]()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              "bn_relu %s %s %s: non-finite" % (kind, shape, key))
        err = float((got.float() - want.float()).abs().max())
        limit = BN_RELU_RTOL[key] * max(1.0, float(want.float().abs()
                                                   .max()))
        check(err <= limit, "bn_relu %s %s %s: max |kernel - plain| %.3g "
              "> %.3g" % (kind, shape, key, err, limit))
        out[kind] = (err, limit)
        del got, want
    del t
    return out


def bn_relu_kernel_phase():
    import torch
    errs = {"fwd": {}, "bwd": {}}
    for shape in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            for kind, (err, limit) in bn_relu_errors(shape, dtype).items():
                errs[kind][key] = max(errs[kind].get(key, 0.0), err)
                print("bn_relu %s %s %s: max_abs_err %.3g (limit %.3g)"
                      % (kind, shape, key, err, limit))

    # the serving path's shapes: each of ResNet-50's fused-site shapes at
    # every bucket, in fp32, as the checkpoint-and-serve phase runs them
    serve_err = 0.0
    for b in SERVE_BUCKETS:
        for site in RESNET50_SITE_SHAPES:
            err, _ = bn_relu_errors((b,) + site, torch.float32, seed=b,
                                    kinds=("fwd",))["fwd"]
            serve_err = max(serve_err, err)
    print("bn_relu fwd float32 at the serving shapes (buckets %s x sites "
          "%s): max_abs_err %.3g (rtol %g of the largest output)"
          % (list(SERVE_BUCKETS), list(RESNET50_SITE_SHAPES), serve_err,
             BN_RELU_RTOL["float32"]))
    errs["fwd"]["float32"] = max(errs["fwd"]["float32"], serve_err)

    times = {}
    for shape in BN_SHAPES:
        times[shape] = bn_relu_shape_times(shape, torch.float32)
        print("bn_relu times %s fp32 (batch %d): fwd %s (%d bytes at "
              "3.35 TB/s); bwd %s (%d bytes); library fwd = "
              "batch_norm(eval)+relu_, bwd = threshold_backward + "
              "native_batch_norm_backward"
              % (shape, shape[0], json.dumps(times[shape]["fwd"]),
                 times[shape]["fwd"]["bytes"],
                 json.dumps(times[shape]["bwd"]),
                 times[shape]["bwd"]["bytes"]))
    # the stem in bf16, as the AMP LARS path launches it; the library
    # calls on the same bf16 rows with the fp32 (C,) vectors
    bf16 = bn_relu_shape_times(BN_SHAPES[0], torch.bfloat16)
    print("bn_relu times %s bf16: fwd %s (%d bytes at 3.35 TB/s); bwd %s "
          "(%d bytes); library on bf16 rows as for fp32"
          % (BN_SHAPES[0], json.dumps(bf16["fwd"]), bf16["fwd"]["bytes"],
             json.dumps(bf16["bwd"]), bf16["bwd"]["bytes"]))
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
    one repeated synthetic batch after WARM_STEPS warm-up steps (eager,
    then captured); the launch counters are zeroed after the warm-up
    and read after the last step."""
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
    for _ in range(WARM_STEPS):     # eager, then captured
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
    bucket = sum(p.data().size for p in net.collect_params().values())
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

    def both(opt, items, **kw):
        cpu = [(i, cpu_copy(w), cpu_copy(g), cpu_copy(s))
               for i, w, g, s in items]
        original(opt, items, **kw)
        original(opt, cpu)          # the scalars read on the host
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
    dev = next(iter(params.values())).data()._data.device
    x = torch.as_tensor(ids, device=dev)
    y = torch.as_tensor(labels, device=dev)
    with autograd.record():
        loss = make_mlm_loss(vocab)(net(x), y)
    loss.sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.data()._data.grad
        if g is not None:
            grads[k] = g.detach().cpu().double()
        p.data()._data.grad = None
    before = {k: p.data()._data.detach().cpu().double()
              for k, p in params.items()}
    step = make_bert_step(net, vocab)
    with replaying_bucket_update({}) as record:
        loss = float(step(x, y))
    names = {i: p.name[len(net.prefix):]
             for i, p in enumerate(step._trainer._params)}
    updates = {k: p.data()._data.detach().cpu().double() - before[k]
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
    arrays = {p.name: p.data()._data.detach().cpu().numpy()
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
             "lars_bucket_elements": sum(p.data().size for p in live),
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
            dev = next(iter(net.collect_params().values())).data()._data.device
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
    dev = next(iter(params.values())).data()._data.device
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    with amp.scope("bfloat16") if bf16 else contextlib.nullcontext():
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(xt), yt)
        loss.sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.data()._data.grad
        if g is not None:
            grads[k] = g.detach().cpu().double()
        p.data()._data.grad = None
    before = {k: p.data()._data.detach().cpu().double()
              for k, p in params.items()}
    step = make_lars_step(net)
    with replaying_bucket_update({}) as record:
        loss = float(amp_step(step, bf16)(xt, yt))
    names = {i: p.name[len(net.prefix):]
             for i, p in enumerate(step._trainer._params)}
    updates = {k: p.data()._data.detach().cpu().double() - before[k]
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


def limit_ratios(got, floors, fp32, fp32_factor=1.0):
    """Each tensor's card-vs-CPU error ``got[k]`` over its limit:
    AMP_ORACLE_FACTOR times its permuted floor, and no less than
    ``fp32_factor`` times its fp32 distance.  Only the tensors whose
    floors are both below AMP_FLOOR_CAP are held (elsewhere bf16 noise
    alone is O(1), as large as a fault): ``{held name: ratio}``."""
    out = {}
    for k in floors:
        if max(floors[k], fp32[k]) >= AMP_FLOOR_CAP:
            continue
        limit = max(AMP_ORACLE_FACTOR * floors[k], fp32_factor * fp32[k])
        out[k] = got[k] / limit if limit > 0 else (0.0 if got[k] == 0
                                                   else float("inf"))
    return out


def held_against_floors(got, floors, fp32, fp32_factor=1.0):
    """:func:`limit_ratios` summed up: ``(held names, worst ratio of
    error to limit, its name)``."""
    ratios = limit_ratios(got, floors, fp32, fp32_factor)
    worst, worst_name = 0.0, None
    for k, ratio in ratios.items():
        if ratio > worst:
            worst, worst_name = ratio, k
    return list(ratios), worst, worst_name


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
    arrays = {p.name: p.data()._data.detach().cpu().numpy()
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
# phase 9: BERT-base bf16 AMP pretraining with Adam (bench_bert_base)
# ---------------------------------------------------------------------

# bench.py :: bench_bert_base's configuration: bert_base with
# max_length = seq and dropout 0, masked-LM loss, amp.scope("bfloat16"),
# Adam at lr 1e-4 (its other hyper-parameters the optimizer's defaults)
BERT_BF16_SHAPES = ((256, 128), (64, 512))
BERT_ADAM = {"learning_rate": 1e-4}
# the dtype each kernel site gets under the bf16 policy, per step
# (tests/test_torch_bert_bf16.py holds them against the JAX package's):
# flash attention bf16 q/k/v at every layer; LayerNorm fp32 after the
# embedding sum and each residual add (a widest-type cast of the fp32
# stream and a bf16 branch), bf16 in the MLM head after its bf16 Dense
BERT_BF16_SITE_DTYPES = {
    "flash_attention_fwd": {"bfloat16": BERT_LAYERS},
    "flash_attention_bwd": {"bfloat16": BERT_LAYERS},
    "layernorm_fwd": {"float32": 2 * BERT_LAYERS + 1, "bfloat16": 1}}
BERT_BF16_ORACLE_BATCH, BERT_BF16_ORACLE_SEQ = 2, 128
# the card and the CPU each round to bf16 in their own places, each about
# its fp32 distance from the fp32 step: two such steps lie up to twice
# that apart (bert_bf16_oracle; the flash forward's rounding of P, given
# to the CPU, does not bring them closer: PERF.md section 2)
BF16_PLACEMENT_FACTOR = 2.0
ADAM_REPLAY_LIMIT = 1e-5
BERT_BF16_HOLD_BATCH, BERT_BF16_HOLD_SEQ = 8, 128
# device-time categories of the bf16 step (matched in this order);
# copies whose kernel names a bf16 type are casts
BF16_STEP_CATEGORIES = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_kernel", "cast_dq_kernel")),
    ("layernorm_fwd", ("layernorm_fwd_kernel",)),
    ("bf16_gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
)


def bert_bf16_net(seq, dropout=0.0, vocab_size=BERT_VOCAB):
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    return bert_base(vocab_size=vocab_size, max_length=seq, dropout=dropout)


def make_adam_step(net, vocab, hyper=None):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            dict(hyper or BERT_ADAM))
    return TrainStep(net, make_mlm_loss(vocab), trainer)


def bf16_step_category(name):
    low = name.lower()
    for cat, marks in BF16_STEP_CATEGORIES:
        if any(m in low for m in marks):
            return cat
    if "copy" in low:
        return "casts" if "bfloat16" in low else "copy"
    cat = kernel_category(name)
    return cat if cat in ("softmax", "index", "reduction",
                          "elementwise") else "other"


def bert_bf16_main_path(make_net=bert_bf16_net, vocab=BERT_VOCAB,
                        layers=BERT_LAYERS, batch=256, seq=128,
                        steps=TRAIN_STEPS, site_dtypes=BERT_BF16_SITE_DTYPES,
                        device="cuda"):
    """Pretrain ``make_net(seq)`` (masked LM, Adam, bf16 AMP) for
    ``steps`` steps on one synthetic batch after WARM_STEPS warm-up
    steps (eager, then captured); the launch counters are zeroed after
    the warm-up and read after the last step, with the dtype of each
    launch."""
    import torch
    from mxnet_tpu_torch import amp, random
    from mxnet_tpu_torch.kernels import registry
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() if cuda else None
    random.seed(0)
    net = make_net(seq)
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    step = make_adam_step(net, vocab)
    gen = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(0, vocab, (batch, seq), generator=gen,
                        device=device).float()
    labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device).float()
    with amp.scope("bfloat16"):
        t0 = time.perf_counter()
        for _ in range(WARM_STEPS):     # eager, then captured
            step(ids, labels)
        if cuda:
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        registry.reset_launches()
        t0 = time.perf_counter()
        losses = [step(ids, labels) for _ in range(steps)]
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = ("flash_attention_fwd", "flash_attention_bwd", "layernorm_fwd")
    counts = {name: registry.launches(name) for name in names}
    dtypes = {name: registry.launch_dtypes(name) for name in names}
    losses = [float(v) for v in losses]
    what = "BERT bf16 Adam %dx%d" % (batch, seq)
    check(all(np.isfinite(losses)), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    for name, per_step in site_dtypes.items():
        n = sum(per_step.values()) * steps
        check(counts[name] == n, "%s: %s launches %d != %d"
              % (what, name, counts[name], n))
        if cuda:
            want = {k: v * steps for k, v in per_step.items()}
            check(dtypes[name] == want, "%s: %s ran on %s, not %s"
                  % (what, name, dtypes[name], want))
    stats = {"batch": batch, "seq": seq, "steps": steps, "losses": losses,
             "ms_per_step": 1e3 * wall / steps,
             "tokens_per_s": batch * seq * steps / wall, "warmup_s": warm_s,
             "launches": counts, "launch_dtypes": dtypes,
             "pool_bytes": step.capture_stats().get("pool_bytes"),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "allocated_before_bytes": held_before,
             "card": gpu_line() if cuda else None}
    print("BERT bf16 Adam main path (bert_base, max_length %d, dropout 0, "
          "masked LM, amp.scope('bfloat16'), Adam lr 1e-4): %s"
          % (seq, json.dumps(stats)))
    return net, step, (ids, labels), stats


def adam_device_ms(step, ids, labels):
    """Device time of Adam's elementwise passes in one step: an eager
    step (a fresh ``TrainStep`` on the same net and trainer, whose first
    call runs eagerly) profiled with the optimizer's update of each
    parameter in a ``record_function`` range; the kernels under the
    ranges are the ones the captured step replays."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.parallel import TrainStep
    from torch.profiler import ProfilerActivity, profile, record_function
    opt = step._trainer._optimizer
    apply = opt._apply_multi_precision

    def ranged(*a, **k):
        with record_function("adam_update"):
            return apply(*a, **k)

    opt._apply_multi_precision = ranged
    eager = TrainStep(step._block, step._loss_fn, step._trainer)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                amp.scope("bfloat16"):
            eager(ids, labels)
            torch.cuda.synchronize()
    finally:
        del opt._apply_multi_precision
    events = prof.events()
    ranges = [e for e in events if e.name == "adam_update"]
    check(ranges, "the profiler saw no adam_update range")

    def device_us(e):
        return sum(k.duration for k in e.kernels) + sum(
            device_us(c) for c in e.cpu_children)

    return sum(device_us(e) for e in ranges) / 1e3, len(ranges)


def bert_bf16_breakdown(step, ids, labels, step_ms, label):
    """Device time of one replayed bf16 step by category (bf16 GEMM,
    flash forward, flash backward, LayerNorm forward, Adam's elementwise
    passes, casts, other), and the device's idle share."""
    import torch
    from mxnet_tpu_torch import amp
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            amp.scope("bfloat16"):
        step(ids, labels)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time")
    by_cat = {}
    for e in kernels:
        cat = bf16_step_category(e.key)
        ms_, n_ = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms_ + e.self_device_time_total / 1e3, n_ + e.count)
    busy = sum(v[0] for v in by_cat.values())
    for cat in ("flash_fwd", "flash_bwd", "layernorm_fwd", "bf16_gemm"):
        check(cat in by_cat, "%s: the profiler saw no %s kernel"
              % (label, cat))
    adam_ms, adam_ranges = adam_device_ms(step, ids, labels)
    ew_ms, ew_n = by_cat.pop("elementwise", (0.0, 0))
    by_cat["adam_elementwise"] = (adam_ms, None)
    by_cat["elementwise_other"] = (max(0.0, ew_ms - adam_ms), None)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    out = {"step_ms": step_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1 - busy / step_ms),
           "by_category": {k: [v[0], v[1], v[0] / busy] for k, v in sorted(
               by_cat.items(), key=lambda kv: -kv[1][0])},
           "flash_bwd_share": by_cat["flash_bwd"][0] / busy,
           "adam_updates_profiled": adam_ranges,
           "elementwise_kernels_in_step": ew_n,
           "top_kernels": [[e.key[:72], e.self_device_time_total / 1e3,
                            e.count, bf16_step_category(e.key)]
                           for e in ranked[:14]],
           "card": gpu_line()}
    print("%s: %s" % (label, json.dumps(out)))
    return out


def bert_bf16_grads_and_step(net, vocab, ids, labels, bf16=True,
                             replay=False):
    """One forward/backward of the summed MLM loss under the bf16
    policy (fp32 when ``bf16`` is false), then one such ``TrainStep``
    with Adam from a fresh trainer: ``(loss, {name: grad}, {name: w' -
    w}, {name: w'' - w} or None)``, float64 on the CPU, names relative
    to the net's prefix.  With ``replay``, ``w''`` is the step's Adam
    update replayed on the CPU by the plain ops from the step's own
    weights, gradients, states and device scalars."""
    import torch
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.optimizer import create
    from mxnet_tpu_torch.parallel.data_parallel import _optimizer_reads
    params = {p.name[len(net.prefix):]: p
              for p in net.collect_params().values()}
    dev = next(iter(params.values())).data()._data.device
    x = torch.as_tensor(ids, device=dev)
    y = torch.as_tensor(labels, device=dev)

    def scope():
        return amp.scope("bfloat16") if bf16 else contextlib.nullcontext()

    with scope():
        with autograd.record():
            loss = make_mlm_loss(vocab)(net(x), y)
        loss.sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.data()._data.grad
        if g is not None:
            grads[k] = g.detach().cpu().double()
        p.data()._data.grad = None
    before = {k: p.data()._data.detach().cpu().double()
              for k, p in params.items()}
    step = make_adam_step(net, vocab)
    opt = step._trainer._optimizer
    inputs = {}
    if replay:
        apply = opt._apply_multi_precision

        def recording(i, w, g, state):
            def cpu(t):
                return t.detach().cpu().clone()
            inputs[i] = (cpu(w), cpu(g), tuple(cpu(t) for t in state),
                         [cpu(torch.as_tensor(v)) for v in (
                             opt._get_lr(i), opt._get_wd(i),
                             opt.rescale_grad, opt._index_update_count[i])])
            return apply(i, w, g, state)

        opt._apply_multi_precision = recording
    with scope():
        loss = float(step(x, y))
    updates = {k: p.data()._data.detach().cpu().double() - before[k]
               for k, p in params.items()}
    if not replay:
        return loss, grads, updates, None
    del opt._apply_multi_precision
    names = {i: p.name[len(net.prefix):]
             for i, p in enumerate(step._trainer._params)}
    plain = create("adam", **BERT_ADAM)
    replayed = {}
    for i, (w, g, state, (lr, wd, rescale, t)) in inputs.items():
        w0 = w.double()
        with _optimizer_reads(plain, lambda _i: lr, lambda _i: wd, rescale,
                              t):
            plain._apply_multi_precision(i, w, g, state)
        replayed[names[i]] = w.double() - w0
    return loss, grads, updates, replayed


FLASH_KEY_TILE = 64     # keys of a tile of csrc/flash_attention.cu's forward


def kernel_rounded_flash_fwd(q, k, v, mask=None, causal=False, scale=1.0,
                             heads=1):
    """The plain flash forward with the bf16 kernel's rounding, for a
    CPU step of the pretraining oracle only (never the port's path):
    the kernel walks the keys in tiles of 64 with an online softmax and,
    on bf16 inputs, rounds each tile's unnormalized probabilities
    ``exp(s - m_j)`` (``m_j`` the row's running maximum through tile j)
    to bf16 for its bf16 ``P V`` product, summing them unrounded into
    the row's denominator; the plain version keeps P in fp32.  Other
    dtypes take the plain version."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    if q.dtype != torch.bfloat16:
        return fa.flash_attention_fwd_reference(q, k, v, mask, causal,
                                                scale, heads)
    s = fa._scores(q, k, mask, causal, scale, heads)
    bh, n_q, n_k = s.shape
    tiles = -(-n_k // FLASH_KEY_TILE)
    pad = tiles * FLASH_KEY_TILE - n_k
    st = torch.nn.functional.pad(s, (0, pad), value=-float("inf")) \
        .reshape(bh, n_q, tiles, FLASH_KEY_TILE)
    vt = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)) \
        .reshape(bh, tiles, FLASH_KEY_TILE, -1)
    m_run = torch.cummax(st.amax(-1), dim=-1).values      # (bh, q, tiles)
    m = m_run[..., -1]
    p = torch.exp(st - m_run[..., None]).to(torch.bfloat16).float()
    pv = torch.einsum("bqtk,btkd->bqtd", p, vt)
    o = (pv * torch.exp(m_run - m[..., None])[..., None]).sum(2)
    den = torch.exp(st - m[..., None, None]).sum((-1, -2))
    return (o / den[..., None]).to(q.dtype), m + torch.log(den)


@contextlib.contextmanager
def kernel_rounding():
    """Within the scope, the flash forward's plain version (the CPU
    path) is :func:`kernel_rounded_flash_fwd`."""
    from mxnet_tpu_torch.kernels import registry
    spec = registry.get("flash_attention_fwd")
    plain = spec.plain
    spec.plain = kernel_rounded_flash_fwd
    try:
        yield
    finally:
        spec.plain = plain


def round_mantissa(t, bits):
    """``t`` rounded to ``bits`` explicit mantissa bits (to nearest,
    ties to even), in its dtype and exponent range."""
    import torch
    m, e = torch.frexp(t.float())
    scale = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(m * scale) / scale, e).to(t.dtype)


@contextlib.contextmanager
def coarse_casts(bits):
    """Within the scope, every cast of the AMP policy to bf16 also
    rounds to ``bits`` mantissa bits: the same step at a lower
    precision (the pretraining oracle's control).  The gradient passes
    the extra rounding unchanged, as it passes the cast."""
    import torch
    from mxnet_tpu_torch import amp
    cast = amp._cast_floats

    def coarse(datas, dtype):
        out = cast(datas, dtype)
        if dtype != torch.bfloat16:
            return out
        return [d + (round_mantissa(d.detach(), bits) - d.detach())
                if amp._is_float(d) else d for d in out]

    amp._cast_floats = coarse
    try:
        yield
    finally:
        amp._cast_floats = cast


def bert_bf16_oracle(arrays, prefix, vocab=BERT_VOCAB,
                     batch=BERT_BF16_ORACLE_BATCH,
                     seq=BERT_BF16_ORACLE_SEQ, make_net=bert_bf16_net,
                     device="cuda"):
    """One bf16 Adam step of the main path's weights (``arrays``) on
    the card (the kernels) and on the CPU (the plain versions), on the
    same batch, held by the AMP LARS oracle's floor method
    (``held_against_floors``):
    two more CPU steps give the floors, the bf16 step with the batch
    permuted and the step in fp32.  Here the permuted floor is ~0 (no
    layer couples the rows of a batch, so every bf16 rounding falls where
    it fell), and the card and the CPU round to bf16 in different places
    (the accumulation order of every product; the flash kernel rounds
    the probabilities to bf16 before the PV product, which its plain
    version takes in fp32): each lies about its fp32 distance from the
    fp32 step, so the two may lie up to twice that apart
    (BF16_PLACEMENT_FACTOR).

    - The loss is held to the larger of AMP_ORACLE_FACTOR times its
      permuted floor and its fp32 distance.
    - Each gradient whose floors are below AMP_FLOOR_CAP is held to the
      larger of AMP_ORACLE_FACTOR times its permuted floor and
      BF16_PLACEMENT_FACTOR times its fp32 distance.
    - The Adam update: the card's against the plain ops on the CPU fed
      the card's own weights, gradients, states and scalars, 1e-5
      norm-wise ("adam_replay"); and the card's against the CPU's over
      the tensors the floors hold, norm-wise, to BF16_PLACEMENT_FACTOR
      times their fp32 distance.  Adam's first update is ``-lr * g /
      |g|`` an element: a gradient entry whose sign the rounding flips
      moves a full step, so a small tensor's error counts a few flips
      and is printed per tensor, not held alone; the tensors whose
      floors reach the cap are printed, unheld.
    - The same step in fp32 on the card (TF32 off) against the CPU's:
      loss and gradients within BERT_ORACLE_LIMITS (the fp32 oracle's).

    The key third of each qkv bias is left out (its exact gradient is
    0)."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy

    def copy_on(dev):
        n = make_net(seq)
        n.initialize(device=dev)
        params_from_numpy(n, arrays, prefix=prefix)
        return n

    units = copy_on("cpu")._units
    rng = np.random.default_rng(3)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.float32)
    perm = rng.permutation(batch)
    if (perm == np.arange(batch)).all():
        perm = perm[::-1].copy()
    t0 = time.perf_counter()
    runs = {"cpu": bert_bf16_grads_and_step(copy_on("cpu"), vocab, ids,
                                            labels)}
    cpu_step_s = time.perf_counter() - t0
    runs["cpu_permuted"] = bert_bf16_grads_and_step(
        copy_on("cpu"), vocab, ids[perm], labels[perm])
    runs["cpu_fp32"] = bert_bf16_grads_and_step(copy_on("cpu"), vocab, ids,
                                                labels, bf16=False)
    runs["card"] = bert_bf16_grads_and_step(copy_on(device), vocab, ids,
                                            labels, replay=True)
    runs["card_fp32"] = bert_bf16_grads_and_step(copy_on(device), vocab,
                                                 ids, labels, bf16=False)
    loss = {run: r[0] for run, r in runs.items()}
    check(sorted(runs["card"][1]) == sorted(runs["cpu"][1]),
          "BERT bf16 oracle: parameters with a gradient differ card vs CPU")
    out = {"batch": batch, "seq": seq, "cpu_step_s": cpu_step_s,
           "loss_card": loss["card"], "loss_cpu": loss["cpu"],
           "loss_rel_err": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
           "floor_loss_rel_err": abs(loss["cpu_permuted"] - loss["cpu"])
           / abs(loss["cpu"]),
           "fp32_loss_rel_err": abs(loss["cpu_fp32"] - loss["cpu"])
           / abs(loss["cpu"])}
    out["loss_limit"] = max(AMP_ORACLE_FACTOR * out["floor_loss_rel_err"],
                            out["fp32_loss_rel_err"])
    vals = {}
    for what, j in (("grad", 1), ("update", 2)):
        vals[what] = {run: split_key_bias(r[j], units)[0]
                      for run, r in runs.items()}
        v = vals[what]
        got = per_tensor_errors(v["card"], v["cpu"])
        floors = per_tensor_errors(v["cpu_permuted"], v["cpu"])
        fp32 = per_tensor_errors(v["cpu_fp32"], v["cpu"])
        held, worst, worst_name = held_against_floors(
            got, floors, fp32, BF16_PLACEMENT_FACTOR)
        glob, _, _ = rel_errors({k: v["card"][k] for k in held},
                                {k: v["cpu"][k] for k in held})
        fp32_glob, _, _ = rel_errors({k: v["cpu_fp32"][k] for k in held},
                                     {k: v["cpu"][k] for k in held})
        ratios = sorted(got[k] / max(BF16_PLACEMENT_FACTOR * fp32[k],
                                     AMP_ORACLE_FACTOR * floors[k], 1e-30)
                        for k in held)
        out.update({
            "%s_tensors" % what: len(got), "%s_held" % what: len(held),
            "%s_rel_err_held" % what: glob,
            "fp32_%s_rel_err_held" % what: fp32_glob,
            "%s_worst_ratio_to_limit" % what: worst,
            "%s_median_ratio_to_limit" % what:
                ratios[len(ratios) // 2] if ratios else None,
            "%s_worst_param" % what: worst_name,
            "%s_unheld" % what: sorted(
                [k, floors[k], fp32[k]] for k in floors if k not in held),
            "%s_rel_err_all" % what: rel_errors(v["card"], v["cpu"])[0],
            "floor_%s_rel_err_all" % what: rel_errors(v["cpu_permuted"],
                                                      v["cpu"])[0]})
    replay, _ = split_key_bias(runs["card"][3], units)
    r_glob, r_worst, r_name = rel_errors(vals["update"]["card"], replay)
    f_glob, f_worst, f_name = rel_errors(vals["grad"]["card_fp32"],
                                         vals["grad"]["cpu_fp32"])
    out.update({
        "adam_replay_rel_err": r_glob, "adam_replay_rel_err_worst": r_worst,
        "adam_replay_worst_param": r_name,
        "fp32_card_loss_rel_err": abs(loss["card_fp32"] - loss["cpu_fp32"])
        / abs(loss["cpu_fp32"]),
        "fp32_card_grad_rel_err": f_glob,
        "fp32_card_grad_rel_err_worst": f_worst,
        "fp32_card_grad_worst_param": f_name,
        "factor": AMP_ORACLE_FACTOR, "placement_factor":
        BF16_PLACEMENT_FACTOR, "floor_cap": AMP_FLOOR_CAP,
        "card": gpu_line()})
    print("BERT bf16 Adam oracle (card vs CPU): %s" % json.dumps(out))
    check(np.isfinite(loss["card"]), "BERT bf16 oracle: the card's loss is "
          "not finite")
    check(out["loss_rel_err"] <= out["loss_limit"], "BERT bf16 oracle: "
          "loss %.3g > limit %.3g" % (out["loss_rel_err"],
                                      out["loss_limit"]))
    check(out["grad_held"] > 0 and out["update_held"] > 0,
          "BERT bf16 oracle: the floors hold no gradient or no update")
    check(out["grad_worst_ratio_to_limit"] <= 1.0,
          "BERT bf16 oracle: grad of %s %.3g times its limit" % (
              out["grad_worst_param"], out["grad_worst_ratio_to_limit"]))
    check(out["update_rel_err_held"]
          <= BF16_PLACEMENT_FACTOR * out["fp32_update_rel_err_held"],
          "BERT bf16 oracle: held updates %.3g > %g x their fp32 distance "
          "%.3g" % (out["update_rel_err_held"], BF16_PLACEMENT_FACTOR,
                    out["fp32_update_rel_err_held"]))
    check(max(r_glob, r_worst) <= ADAM_REPLAY_LIMIT, "BERT bf16 oracle: "
          "Adam replay %.3g (worst %.3g, %s) > %g"
          % (r_glob, r_worst, r_name, ADAM_REPLAY_LIMIT))
    check(out["fp32_card_loss_rel_err"] <= BERT_ORACLE_LIMITS["loss_rel_err"]
          and f_glob <= BERT_ORACLE_LIMITS["grad_rel_err"],
          "BERT bf16 oracle: the fp32 step, card vs CPU: loss %.3g, grads "
          "%.3g" % (out["fp32_card_loss_rel_err"], f_glob))
    return out


def bert_bf16_hold(vocab=BERT_VOCAB, batch=BERT_BF16_HOLD_BATCH,
                   seq=BERT_BF16_HOLD_SEQ, make_net=bert_bf16_net,
                   device="cuda"):
    """BERT-base bf16 with Adam and a ``PolyScheduler`` in warm-up (lr
    and the bias correction's ``t`` change at every step): four calls of
    one ``TrainStep`` against four eager steps, beside the floor of two
    eager runs (``_bucketed_hold``'s rule: the larger of 1e-5 and 4x the
    floor)."""
    import torch
    from mxnet_tpu_torch import lr_scheduler

    def hyper():
        return {"learning_rate": 1e-4, "lr_scheduler":
                lr_scheduler.PolyScheduler(max_update=100, base_lr=1e-4,
                                           pwr=1, warmup_steps=4)}

    gen = torch.Generator(device=device).manual_seed(7)
    ids = torch.randint(0, vocab, (batch, seq), generator=gen,
                        device=device).float()
    labels = torch.randint(0, vocab, ids.shape, generator=gen,
                           device=device).float()
    out = _bucketed_hold(lambda: make_net(seq), "adam", hyper, ids, labels,
                         make_mlm_loss(vocab), bf16=True, device=device)
    out["card"] = gpu_line()
    print("captured against eager (BERT-base bf16 Adam + PolyScheduler "
          "TrainStep, %dx%d): %s" % (batch, seq, json.dumps(out)))
    for key, limit in out["limits"].items():
        check(out[key] <= limit, "capture hold BERT bf16 Adam: %s %.3g > "
              "limit %g" % (key, out[key], limit))
    return out


def release_cuda():
    """Free what earlier owners left in PyTorch's caches: each capture
    stream of the earlier paths (a hold makes a fresh ``TrainStep`` a
    call) left a cuBLAS workspace there."""
    import torch
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def bert_bf16_phase(shapes=BERT_BF16_SHAPES):
    """The main path at each of bench_bert_base's shapes, each with its
    breakdown and capture report, each net released before the next;
    then the oracle on the first shape's weights and the
    captured-against-eager hold."""
    out = {"main": {}, "breakdown": {}}
    arrays = prefix = None
    for batch, seq in shapes:
        release_cuda()
        net, step, (ids, labels), stats = bert_bf16_main_path(batch=batch,
                                                              seq=seq)
        key = "%dx%d" % (batch, seq)
        bd = bert_bf16_breakdown(step, ids, labels, stats["ms_per_step"],
                                 "BERT bf16 Adam step breakdown %s" % key)
        capture_report("BERT bf16 Adam TrainStep %s" % key,
                       step.capture_stats(),
                       {"ms_per_step": stats["ms_per_step"],
                        "tokens_per_s": stats["tokens_per_s"],
                        "peak_mem_bytes": stats["peak_mem_bytes"]},
                       bd["device_idle_share"], 1)
        out["main"][key], out["breakdown"][key] = stats, bd
        if arrays is None:
            arrays = {p.name: p.data()._data.detach().cpu().numpy()
                      for p in net.collect_params().values()}
            prefix = net.prefix
        del net, step, ids, labels
    release_cuda()
    out["oracle"] = bert_bf16_oracle(arrays, prefix)
    del arrays
    release_cuda()
    out["hold"] = bert_bf16_hold()
    release_cuda()
    return out


# ---------------------------------------------------------------------
# phase 10: BERT pretraining as users run it -- padded batches with a
# valid_mask, NSP beside masked LM, the imperative loop, the default
# Trainer(kvstore="device")
# ---------------------------------------------------------------------

# google-research/bert create_pretraining_data.py's defaults for
# pretraining at 512 tokens: short_seq_prob 0.1, masked_lm_prob 0.15,
# max_predictions_per_seq 77 (= 512 x 0.15)
PRETRAIN_BATCH, PRETRAIN_SEQ = 64, 512
PRETRAIN_SHORT_SEQ_PROB = 0.1
PRETRAIN_MASKED_LM_PROB = 0.15
PRETRAIN_MAX_PREDICTIONS = 77
PRETRAIN_ADAM = {"learning_rate": 1e-4, "wd": 0.01}
PRETRAIN_ORACLE_SEQ, PRETRAIN_ORACLE_LENGTHS = 128, (128, 71)
# the oracle's control: the CPU step with every bf16 cast of the AMP
# policy rounded to fp8 e4m3's 3 mantissa bits (bf16 keeps 7) must fail
# its loss check
PRETRAIN_CONTROL_MANTISSA_BITS = 3
# BERT's uncased WordPiece vocabulary: [PAD] 0, [CLS] 101, [SEP] 102,
# [MASK] 103, word pieces from 999 on
BERT_SPECIAL_IDS = {"pad": 0, "cls": 101, "sep": 102, "mask": 103,
                    "first_word": 999}
# per step: masked flash attention on bf16 q/k/v at every layer (forward
# and backward); LayerNorm at the bf16 policy's dtypes, as unmasked
# (tests/test_torch_bert_pretrain.py holds both against the JAX package)
BERT_PRETRAIN_SITE_DTYPES = {
    "flash_attention_fwd": {"bfloat16 masked": BERT_LAYERS},
    "flash_attention_bwd": {"bfloat16 masked": BERT_LAYERS},
    "layernorm_fwd": {"float32": 2 * BERT_LAYERS + 1, "bfloat16": 1}}


def bert_pretrain_net(dropout=0.0, vocab_size=BERT_VOCAB):
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    return bert_base(vocab_size=vocab_size, max_length=BERT_SEQ,
                     dropout=dropout)


def pretraining_batch(batch, seq, vocab, seed=0, lengths=None,
                      short_seq_prob=PRETRAIN_SHORT_SEQ_PROB,
                      masked_lm_prob=PRETRAIN_MASKED_LM_PROB,
                      max_predictions=PRETRAIN_MAX_PREDICTIONS):
    """A padded pretraining batch by the rules of google-research/bert
    ``create_pretraining_data.py``: one row in ten (``short_seq_prob``)
    of a length uniform in [8, seq], the others in [seq - seq / 8, seq]
    (unless ``lengths`` gives them); ``[CLS] A [SEP] B [SEP]`` split at a
    random point with token types 0/1; next-sentence labels 50/50;
    ``masked_lm_prob`` of the row's tokens, at most ``max_predictions``,
    picked among its non-special positions for the MLM loss (80%
    [MASK], 10% a random word, 10% kept).  Returns numpy arrays: ids,
    types, lens, labels, weights (batch, seq, 1), nsp."""
    rng = np.random.default_rng(seed)
    sp = BERT_SPECIAL_IDS if vocab > BERT_SPECIAL_IDS["first_word"] \
        else {"pad": 0, "cls": 1, "sep": 2, "mask": 3, "first_word": 4}
    if lengths is None:
        short = rng.random(batch) < short_seq_prob
        lens = np.where(short, rng.integers(8, seq + 1, batch),
                        rng.integers(seq - seq // 8, seq + 1, batch))
    else:
        lens = np.asarray(lengths)
    ids = np.full((batch, seq), sp["pad"], np.float32)
    types = np.zeros((batch, seq), np.float32)
    labels = np.zeros((batch, seq), np.float32)
    weights = np.zeros((batch, seq, 1), np.float32)
    for b, n in enumerate(lens):
        len_a = int(rng.integers(1, n - 3))
        ids[b, :n] = rng.integers(sp["first_word"], vocab, n)
        ids[b, 0] = sp["cls"]
        ids[b, len_a + 1] = ids[b, n - 1] = sp["sep"]
        types[b, len_a + 2:n] = 1
        cand = [i for i in range(1, n - 1) if i != len_a + 1]
        num = min(max_predictions, max(1, int(round(n * masked_lm_prob))))
        picks = rng.permutation(cand)[:num]
        labels[b, picks] = ids[b, picks]
        weights[b, picks, 0] = 1.0
        for i in picks:
            r = rng.random()
            if r < 0.8:
                ids[b, i] = sp["mask"]
            elif r < 0.9:
                ids[b, i] = rng.integers(sp["first_word"], vocab)
    nsp = rng.integers(0, 2, batch).astype(np.float32)
    return {"ids": ids, "types": types, "lens": lens, "labels": labels,
            "weights": weights, "nsp": nsp}


def valid_mask(lens, seq, device):
    """``valid_mask[b, i, j] = j < lens[b]``: every query row keeps its
    batch row's valid keys (a padded query row too, whose loss weight
    is 0), so no row is left without a key."""
    import torch
    lens = torch.as_tensor(np.asarray(lens), device=device)
    return (torch.arange(seq, device=device)[None, None, :]
            < lens[:, None, None]).float().expand(len(lens), seq, seq) \
        .contiguous()


def pretrain_inputs(data, ctx):
    """The batch as NDArrays on ``ctx``, the mask made on the device."""
    from mxnet_tpu_torch import NDArray
    from mxnet_tpu_torch import nd
    arrays = {k: nd.array(data[k], ctx=ctx)
              for k in ("ids", "types", "labels", "weights", "nsp")}
    arrays["mask"] = NDArray(valid_mask(data["lens"], data["ids"].shape[1],
                                        ctx.torch_device()))
    return arrays


def pretrain_loop_step(net, trainer, inputs, mlm_ce, nsp_ce, batch):
    """The user's loop, one step: ``(loss, MLM loss)`` per sample (device
    NDArrays) and the host seconds of ``trainer.step``."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        mlm, nsp = net(inputs["ids"], inputs["types"], inputs["mask"])
        mlm_loss = mlm_ce(mlm, inputs["labels"], inputs["weights"])
        loss = mlm_loss + nsp_ce(nsp, inputs["nsp"])
    loss.backward()
    t0 = time.perf_counter()
    trainer.step(batch)
    return loss, mlm_loss, time.perf_counter() - t0


def counting_pushpull(kv):
    """Wrap the store's ``pushpull`` to count its calls and their host
    seconds: ``{"calls": n, "s": seconds}``."""
    tally = {"calls": 0, "s": 0.0}
    pushpull = kv.pushpull

    def counted(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return pushpull(*args, **kwargs)
        finally:
            tally["calls"] += 1
            tally["s"] += time.perf_counter() - t0

    kv.pushpull = counted
    return tally


def bert_pretrain_main_path(make_net=bert_pretrain_net, vocab=BERT_VOCAB,
                            batch=PRETRAIN_BATCH, seq=PRETRAIN_SEQ,
                            steps=TRAIN_STEPS,
                            site_dtypes=BERT_PRETRAIN_SITE_DTYPES,
                            ctx=None):
    """BERT-base pretraining the way its users run it: the hybridized
    net under ``amp.scope("bfloat16")``, NSP + MLM over a padded batch
    with its ``valid_mask``, ``autograd.record`` -> ``backward`` ->
    ``Trainer.step`` with Adam and the default kvstore.  The launch
    counters are zeroed before the WARM_STEPS warm-up steps (eager, then
    captured) and read after the ``steps`` timed ones."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, random
    from mxnet_tpu_torch.kernels import registry
    ctx = mx.gpu() if ctx is None else ctx
    cuda = ctx.device_type == "gpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    random.seed(0)
    net = make_net()
    net.initialize(mx.init.Normal(0.02), ctx=ctx,
                   generator=torch.Generator().manual_seed(0))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            dict(PRETRAIN_ADAM))
    data = pretraining_batch(batch, seq, vocab, seed=0)
    inputs = pretrain_inputs(data, ctx)
    mlm_ce = gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_ce = gluon.loss.SoftmaxCrossEntropyLoss()
    registry.reset_launches()
    with amp.scope("bfloat16"):
        t0 = time.perf_counter()
        for _ in range(WARM_STEPS):         # eager, then captured
            pretrain_loop_step(net, trainer, inputs, mlm_ce, nsp_ce, batch)
        if cuda:
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        kv = counting_pushpull(trainer._kvstore)
        losses, mlm_losses, step_s = [], [], []
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, mlm_loss, s = pretrain_loop_step(net, trainer, inputs,
                                                   mlm_ce, nsp_ce, batch)
            losses.append(loss._data.detach().mean())
            mlm_losses.append(mlm_loss._data.detach().mean())
            step_s.append(s)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = ("flash_attention_fwd", "flash_attention_bwd", "layernorm_fwd")
    counts = {name: registry.launches(name) for name in names}
    dtypes = {name: registry.launch_dtypes(name) for name in names}
    losses = torch.stack(losses).tolist()
    mlm_losses = torch.stack(mlm_losses).tolist()
    live = [p for p in net.collect_params().values()
            if p.grad_req != "null"]
    what = "BERT pretraining %dx%d" % (batch, seq)
    check(all(np.isfinite(losses + mlm_losses)), "%s: non-finite loss %s"
          % (what, losses))
    check(mlm_losses[-1] < mlm_losses[0], "%s: MLM loss did not fall: %s"
          % (what, mlm_losses))
    check(trainer._kvstore.type == "device", "%s: kvstore %r" % (
        what, trainer._kvstore.type))
    check(kv["calls"] == steps * len(live), "%s: %d pushpulls in %d steps "
          "of %d live gradients" % (what, kv["calls"], steps, len(live)))
    runs = steps + WARM_STEPS
    for name, per_step in site_dtypes.items():
        n = sum(per_step.values()) * runs
        check(counts[name] == n, "%s: %s launches %d != %d"
              % (what, name, counts[name], n))
        if cuda:
            want = {k: v * runs for k, v in per_step.items()}
            check(dtypes[name] == want, "%s: %s ran on %s, not %s"
                  % (what, name, dtypes[name], want))
    step_host = 1e3 * float(np.mean(step_s))
    push_host = 1e3 * kv["s"] / steps
    stats = {"batch": batch, "seq": seq, "steps": steps,
             "valid_tokens": int(data["lens"].sum()),
             "short_rows": int((data["lens"] < seq - seq // 8).sum()),
             "masked_positions": int(data["weights"].sum()),
             "losses": losses, "mlm_losses": mlm_losses,
             "ms_per_step": 1e3 * wall / steps,
             "tokens_per_s_valid": int(data["lens"].sum()) * steps / wall,
             "tokens_per_s_padded": batch * seq * steps / wall,
             "warmup_s": warm_s, "trainer_step_host_ms": step_host,
             "pushpull_host_ms": push_host,
             "update_host_ms": step_host - push_host,
             "pushpull_per_step": kv["calls"] / steps,
             "live_gradients": len(live), "kvstore": trainer._kvstore.type,
             "launches": counts, "launch_dtypes": dtypes,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()
             if cuda else None, "card": gpu_line() if cuda else None}
    if cuda:
        cache = net.cache_stats()
        stats["graphs"] = cache["graphs"][str(ctx.torch_device())]
        stats["keys"] = len(cache["keys"])
    print("BERT pretraining main path (bert_base, dropout 0, padded %dx%d "
          "with valid_mask, NSP + MLM, amp.scope('bfloat16'), Adam lr 1e-4 "
          "wd 0.01, Trainer(kvstore='device'), imperative loop, "
          "hybridized): %s" % (batch, seq, json.dumps(stats)))
    return net, trainer, inputs, stats


def bert_pretrain_breakdown(net, trainer, inputs, step_ms, batch):
    """Device time of one step of the loop by category (the bf16
    categories), from ``torch.profiler``, and the device's idle share
    against the loop's ms a step."""
    import torch
    from mxnet_tpu_torch import amp, gluon
    from torch.profiler import ProfilerActivity, profile
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with amp.scope("bfloat16"):
        pretrain_loop_step(net, trainer, inputs, ce, ce, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pretrain_loop_step(net, trainer, inputs, ce, ce, batch)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time")
    by_cat = {}
    for e in kernels:
        cat = bf16_step_category(e.key)
        ms_, n_ = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms_ + e.self_device_time_total / 1e3, n_ + e.count)
    busy = sum(v[0] for v in by_cat.values())
    for cat in ("flash_fwd", "flash_bwd", "layernorm_fwd", "bf16_gemm"):
        check(cat in by_cat, "BERT pretraining: the profiler saw no %s "
              "kernel" % cat)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    out = {"step_ms": step_ms, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / step_ms,
           "by_category": {k: [v[0], v[1], v[0] / busy] for k, v in sorted(
               by_cat.items(), key=lambda kv: -kv[1][0])},
           "top_kernels": [[e.key[:72], e.self_device_time_total / 1e3,
                            e.count, bf16_step_category(e.key)]
                           for e in ranked[:14]],
           "card": gpu_line()}
    print("BERT pretraining step breakdown %dx%d: %s"
          % (batch, inputs["ids"].shape[1], json.dumps(out)))
    check(busy <= step_ms * 1.05, "BERT pretraining: device busy %.2f ms "
          "> the loop's %.2f ms a step" % (busy, step_ms))
    return out


def pretrain_loss_terms(mlm, nsp, inputs):
    """The loss term by term: each position's MLM cross-entropy times
    its weight (0 off the masked positions) and each row's NSP
    cross-entropy, ``(batch, seq + 1)`` float64 on the CPU."""
    import torch
    lp = torch.log_softmax(mlm._data.detach().double(), -1)
    tok = -lp.gather(-1, inputs["labels"]._data.long()[..., None])[..., 0] \
        * inputs["weights"]._data[..., 0].double()
    lpn = torch.log_softmax(nsp._data.detach().double(), -1)
    sent = -lpn.gather(-1, inputs["nsp"]._data.long()[:, None])
    return torch.cat([tok, sent], 1).cpu()


def pretrain_grads_and_step(net, data, bf16=True):
    """One step of the loop on ``data`` from a fresh Adam trainer,
    unhybridized: ``(loss, {name: grad}, {name: w' - w}, loss terms)``,
    float64 on the CPU, names relative to the net's prefix, the terms as
    :func:`pretrain_loss_terms`."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon
    params = {p.name[len(net.prefix):]: p
              for p in net.collect_params().values()}
    dev = next(iter(params.values())).data()._data.device
    ctx = mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)
    inputs = pretrain_inputs(data, ctx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            dict(PRETRAIN_ADAM))
    scope = amp.scope("bfloat16") if bf16 else contextlib.nullcontext()
    with scope:
        with autograd.record():
            mlm, nsp = net(inputs["ids"], inputs["types"], inputs["mask"])
            loss = ce(mlm, inputs["labels"], inputs["weights"]) \
                + ce(nsp, inputs["nsp"])
        loss.backward()
        terms = pretrain_loss_terms(mlm, nsp, inputs)
        grads = {k: p.data()._data.grad.detach().cpu().double()
                 for k, p in params.items()
                 if p.data()._data.grad is not None}
        before = {k: p.data()._data.detach().cpu().double()
                  for k, p in params.items()}
        trainer.step(data["ids"].shape[0])
    updates = {k: p.data()._data.detach().cpu().double() - before[k]
               for k, p in params.items()}
    return float(loss._data.detach().double().sum()), grads, updates, terms


def bert_pretrain_oracle(arrays, prefix, vocab=BERT_VOCAB,
                         seq=PRETRAIN_ORACLE_SEQ,
                         lengths=PRETRAIN_ORACLE_LENGTHS,
                         make_net=bert_pretrain_net, device="cuda"):
    """One step of the pretraining loop (NSP + MLM, ragged lengths
    ``lengths`` at ``seq``, dropout 0) with the main path's weights on
    the card and on the CPU.  bf16, the bf16 BERT oracle's rule
    (``held_against_floors`` over the permuted and fp32 floors): each
    gradient and the held updates (norm-wise) within the larger of
    AMP_ORACLE_FACTOR x its permuted floor and BF16_PLACEMENT_FACTOR x
    its fp32 distance; the card and the CPU each lie about their fp32
    distance from the fp32 step.  A tensor is held on its own only with
    at least ``units`` entries: the NSP classifier's bias has two, whose
    gradient is one number, the two rows' probabilities summed, so its
    fp32 distance is one draw that lands near 0 by chance.  The loss is
    held term by term (:func:`pretrain_loss_terms`, norm-wise, each NSP
    row's term among them) to the larger of AMP_ORACLE_FACTOR x its
    permuted floor and BF16_PLACEMENT_FACTOR x the larger of its fp32
    distance and its placement shift, the CPU's loss with the flash
    forward rounding P as the kernel does (:func:`kernel_rounding`).
    The summed loss is printed, not held: one number over a few masked
    tokens and two NSP rows whose errors cancel by chance, as the NSP
    bias's do.  A control shows the checks have teeth: the CPU step with
    every bf16 cast of the AMP policy rounded to
    PRETRAIN_CONTROL_MANTISSA_BITS (:func:`coarse_casts`) must fail the
    terms check and the gradient check.  fp32 (TF32 off): loss and
    gradients within BERT_ORACLE_LIMITS.  The key third of each qkv bias
    is left out (its exact gradient is 0)."""
    import torch
    from mxnet_tpu_torch.gluon.convert import params_from_numpy

    def copy_on(dev):
        n = make_net()
        n.initialize(device=dev)
        params_from_numpy(n, arrays, prefix=prefix)
        return n

    units = copy_on("cpu")._units
    batch = len(lengths)
    data = pretraining_batch(batch, seq, vocab, seed=5, lengths=lengths)
    perm = np.arange(batch)[::-1].copy()
    t0 = time.perf_counter()
    runs = {"cpu": pretrain_grads_and_step(copy_on("cpu"), data)}
    cpu_step_s = time.perf_counter() - t0
    runs["cpu_permuted"] = pretrain_grads_and_step(
        copy_on("cpu"), {k: v[perm] for k, v in data.items()})
    with kernel_rounding():
        runs["cpu_twin"] = pretrain_grads_and_step(copy_on("cpu"), data)
    with coarse_casts(PRETRAIN_CONTROL_MANTISSA_BITS):
        runs["cpu_control"] = pretrain_grads_and_step(copy_on("cpu"), data)
    runs["cpu_fp32"] = pretrain_grads_and_step(copy_on("cpu"), data,
                                               bf16=False)
    runs["card"] = pretrain_grads_and_step(copy_on(device), data)
    runs["card_fp32"] = pretrain_grads_and_step(copy_on(device), data,
                                                bf16=False)
    loss = {run: r[0] for run, r in runs.items()}
    terms = {run: r[3] for run, r in runs.items()}
    terms["cpu_permuted"] = terms["cpu_permuted"][np.argsort(perm)]
    check(sorted(runs["card"][1]) == sorted(runs["cpu"][1]),
          "BERT pretraining oracle: parameters with a gradient differ")

    def rel(a, b):
        return abs(loss[a] - loss[b]) / abs(loss[b])

    def rel_terms(a, b):
        return float((terms[a] - terms[b]).norm() / terms[b].norm())

    out = {"batch": batch, "seq": seq, "lengths": list(lengths),
           "cpu_step_s": cpu_step_s, "loss_card": loss["card"],
           "loss_cpu": loss["cpu"],
           "fp32_card_loss_rel_err": rel("card_fp32", "cpu_fp32"),
           "loss_terms": int((terms["cpu"] != 0).sum())}
    for what, err in (("loss", rel), ("terms", rel_terms)):
        for pre, run in (("", "card"), ("floor_", "cpu_permuted"),
                         ("placement_", "cpu_twin"), ("fp32_", "cpu_fp32"),
                         ("control_", "cpu_control")):
            out["%s%s_rel_err" % (pre, what)] = err(run, "cpu")
        out["%s_limit" % what] = max(
            AMP_ORACLE_FACTOR * out["floor_%s_rel_err" % what],
            BF16_PLACEMENT_FACTOR * max(out["fp32_%s_rel_err" % what],
                                        out["placement_%s_rel_err" % what]))
    vals = {}
    for what, j in (("grad", 1), ("update", 2)):
        vals[what] = {run: split_key_bias(r[j], units)[0]
                      for run, r in runs.items()}
        v = vals[what]
        got = per_tensor_errors(v["card"], v["cpu"])
        floors = per_tensor_errors(v["cpu_permuted"], v["cpu"])
        fp32 = per_tensor_errors(v["cpu_fp32"], v["cpu"])
        small = sorted(k for k in floors if v["cpu"][k].numel() < units)
        floors = {k: f for k, f in floors.items() if k not in small}
        ratios = limit_ratios(got, floors, fp32, BF16_PLACEMENT_FACTOR)
        held, worst, worst_name = held_against_floors(
            got, floors, fp32, BF16_PLACEMENT_FACTOR)
        closest = sorted([r, k, got[k], floors[k], fp32[k]]
                         for k, r in ratios.items())[::-1][:3]

        def norm(a, names=held):
            return rel_errors({k: v[a][k] for k in names},
                              {k: v["cpu"][k] for k in names})[0]

        out.update({
            "%s_tensors" % what: len(got), "%s_held" % what: len(held),
            "%s_rel_err_held" % what: norm("card"),
            "fp32_%s_rel_err_held" % what: norm("cpu_fp32"),
            "control_%s_rel_err_held" % what: norm("cpu_control"),
            "control_%s_worst_ratio_to_limit" % what: held_against_floors(
                per_tensor_errors(v["cpu_control"], v["cpu"]), floors,
                fp32, BF16_PLACEMENT_FACTOR)[1],
            "%s_worst_ratio_to_limit" % what: worst,
            "%s_worst_param" % what: worst_name,
            "%s_closest" % what: closest,
            "%s_small" % what: [[k, got.get(k), fp32.get(k)]
                                for k in small],
            "%s_unheld" % what: sorted(
                [k, floors[k], fp32[k]] for k in floors if k not in held)})
    f_glob, f_worst, f_name = rel_errors(vals["grad"]["card_fp32"],
                                         vals["grad"]["cpu_fp32"])
    out.update({"fp32_card_grad_rel_err": f_glob,
                "fp32_card_grad_rel_err_worst": f_worst,
                "fp32_card_grad_worst_param": f_name,
                "factor": AMP_ORACLE_FACTOR,
                "placement_factor": BF16_PLACEMENT_FACTOR,
                "control_mantissa_bits": PRETRAIN_CONTROL_MANTISSA_BITS,
                "card": gpu_line() if device != "cpu" else None})
    print("BERT pretraining oracle (card vs CPU, NSP + MLM, lengths %s at "
          "%d): %s" % (list(lengths), seq, json.dumps(out)))
    check(np.isfinite(loss["card"]), "BERT pretraining oracle: the card's "
          "loss is not finite")
    check(out["terms_rel_err"] <= out["terms_limit"], "BERT pretraining "
          "oracle: loss terms %.3g > limit %.3g" % (out["terms_rel_err"],
                                                    out["terms_limit"]))
    check(out["control_terms_rel_err"] > out["terms_limit"]
          and out["control_grad_worst_ratio_to_limit"] > 1.0, "BERT "
          "pretraining oracle: the control (%d-bit casts) passes: loss "
          "terms %.3g against limit %.3g, worst gradient %.3g of its "
          "limit" % (PRETRAIN_CONTROL_MANTISSA_BITS,
                     out["control_terms_rel_err"], out["terms_limit"],
                     out["control_grad_worst_ratio_to_limit"]))
    check(out["grad_held"] > 0 and out["update_held"] > 0,
          "BERT pretraining oracle: the floors hold no gradient or update")
    check(out["grad_worst_ratio_to_limit"] <= 1.0, "BERT pretraining "
          "oracle: grad of %s %.3g times its limit" % (
              out["grad_worst_param"], out["grad_worst_ratio_to_limit"]))
    check(out["update_rel_err_held"]
          <= BF16_PLACEMENT_FACTOR * out["fp32_update_rel_err_held"],
          "BERT pretraining oracle: held updates %.3g > %g x their fp32 "
          "distance %.3g" % (out["update_rel_err_held"],
                             BF16_PLACEMENT_FACTOR,
                             out["fp32_update_rel_err_held"]))
    check(out["fp32_card_loss_rel_err"] <= BERT_ORACLE_LIMITS["loss_rel_err"]
          and f_glob <= BERT_ORACLE_LIMITS["grad_rel_err"],
          "BERT pretraining oracle: the fp32 step, card vs CPU: loss %.3g, "
          "grads %.3g" % (out["fp32_card_loss_rel_err"], f_glob))
    return out


def bert_pretrain_phase():
    """The main path, its breakdown and capture report, then the oracle
    on its weights; every earlier owner released first."""
    import torch
    release_cuda()
    net, trainer, inputs, stats = bert_pretrain_main_path()
    bd = bert_pretrain_breakdown(net, trainer, inputs,
                                 stats["ms_per_step"], PRETRAIN_BATCH)
    stats["device_idle_share"] = bd["device_idle_share"]
    cache = net.cache_stats()
    owner = dict(cache["graphs"][str(torch.device("cuda", 0))],
                 keys=cache["keys"])
    capture_report("BERT pretraining (hybridized forward and backward)",
                   owner, {"ms_per_step": stats["ms_per_step"],
                           "tokens_per_s_valid":
                           stats["tokens_per_s_valid"],
                           "peak_mem_bytes": stats["peak_mem_bytes"]},
                   bd["device_idle_share"], 2)
    arrays = {p.name: p.data()._data.detach().cpu().numpy()
              for p in net.collect_params().values()}
    prefix = net.prefix
    del net, trainer, inputs
    release_cuda()
    oracle = bert_pretrain_oracle(arrays, prefix)
    release_cuda()
    return {"main": stats, "breakdown": bd, "oracle": oracle}


def masked_flash_bounds(lens, heads, seq, d, itemsize):
    """Least times of the masked flash forward and backward at the
    pretraining batch's valid ``lens``: bytes as :func:`flash_bounds`
    plus the fp32 ``(b, seq, seq)`` mask read once per batch element
    (the 12 heads of an element run side by side and share it in L2),
    and only the products of valid keys (``4 (fwd) / 10 (bwd) x heads x
    seq x sum(lens) x d`` flops) at bf16's 989 TFLOP/s.  Also the mask's
    bytes as the kernels would read them with no L2 sharing, once per
    head.  Returns {kind: dict}."""
    b = len(lens)
    bh = b * heads
    n = bh * seq * d * itemsize
    mask_once = b * seq * seq * 4
    valid = heads * seq * int(np.sum(lens)) * d
    out = {}
    for kind, nbytes, flops in (
            ("fwd", 4 * n + 4 * bh * seq + mask_once, 4 * valid),
            ("bwd", 7 * n + 8 * bh * seq + mask_once, 10 * valid)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        out[kind] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": nbytes, "flops": flops,
                     "mask_bytes_once_per_element": mask_once,
                     "mask_bytes_once_per_head": mask_once * heads,
                     "mask_per_head_ms_at_hbm_rate":
                         1e3 * mask_once * heads / HBM_BYTES_PER_S}
    return out


def bert_pretrain_kernel_phase(batch=PRETRAIN_BATCH, seq=PRETRAIN_SEQ,
                               d=64, vocab=BERT_VOCAB):
    """The masked flash kernels in bf16 at the pretraining path's
    ``(batch * 12, seq, 64)`` with its ragged ``valid_mask``: held
    against the plain versions and timed beside them, SDPA with the
    boolean mask broadcast over the heads (``attn_mask`` ``(b, 1, seq,
    seq)``; a yardstick, never on the path) and the bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_attention as fa
    lens = pretraining_batch(batch, seq, vocab, seed=0)["lens"]
    bh = batch * BERT_HEADS
    q, k, v, do, _ = flash_inputs(bh, seq, d, torch.bfloat16, seed=11)
    mask = valid_mask(lens, seq, "cuda")
    kw = dict(mask=mask, scale=d ** -0.5, heads=BERT_HEADS)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * want_out.float()).sum(-1)
    grads = fa.flash_attention_bwd_cuda(q, k, v, want_lse, do, delta, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, want_lse, do, delta,
                                            **kw)
    fwd_err = max(rel_err(out, want_out), rel_err(lse, want_lse))
    bwd_err = max(rel_err(a, b) for a, b in zip(grads, want))
    tol_f, tol_b = FLASH_TOL["bfloat16"]
    what = "masked flash (bh %d, seq %d, d %d, bfloat16, pretraining " \
        "valid_mask)" % (bh, seq, d)
    print("%s: fwd rel err %.3g (limit %g), bwd rel err %.3g (limit %g)"
          % (what, fwd_err, tol_f, bwd_err, tol_b))
    check(fwd_err <= tol_f, "%s forward: %.3g > %g" % (what, fwd_err, tol_f))
    check(bwd_err <= tol_b, "%s backward: %.3g > %g" % (what, bwd_err,
                                                        tol_b))
    b4 = (batch, BERT_HEADS, seq, d)
    q4, k4, v4, do4 = (t.view(*b4) for t in (q, k, v, do))
    keep = mask.bool()[:, None]
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep,
                                              scale=kw["scale"])

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep,
                                           scale=kw["scale"])
        return torch.autograd.grad(o, (ql, kl, vl), do4)

    fwd = {"ms": time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw)),
           "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
               q, k, v, **kw)),
           "library_ms": time_ms(lib_fwd)}
    lib_both = time_ms(lib_fwd_bwd)
    bwd = {"ms": time_ms(lambda: fa.flash_attention_bwd_cuda(
               q, k, v, lse, do, delta, **kw)),
           "plain_ms": time_ms(lambda: fa.flash_attention_bwd_reference(
               q, k, v, lse, do, delta, **kw)),
           "library_ms": lib_both - fwd["library_ms"]}
    bounds = masked_flash_bounds(lens, BERT_HEADS, seq, d, 2)
    res = {}
    for kind, t, err in (("fwd", fwd, fwd_err), ("bwd", bwd, bwd_err)):
        t.update(bounds[kind], max_abs_err=err, shape=[bh, seq, d],
                 dtype="bfloat16", masked=True,
                 valid_tokens=int(np.sum(lens)))
        print("masked flash %s times (bh %d, seq %d, d %d, bfloat16, "
              "valid_mask of the pretraining batch): %s; library = SDPA "
              "with the boolean mask over the heads%s" % (
                  kind, bh, seq, d, json.dumps(t),
                  " (forward+backward %.4f ms less its forward)" % lib_both
                  if kind == "bwd" else ""))
        res[kind] = t
    return res


# ---------------------------------------------------------------------
# phase 12: flash attention, LayerNorm and LAMB phase 1 against their
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
        mask[0, min(3, seq - 1), :] = 0.0          # a row with no key
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
    backward does, chooses to; the function does not need it.  Each at
    the rate of the route its kernel takes: the forward on the tensor
    cores, fp32 as three TF32 products (3xTF32) at 495 TFLOP/s and bf16
    at 989; the backward's fp32 FMAs on the CUDA cores at 67, and a bf16
    backward at bf16's peak, 989.  Returns
    {kind: (ms, bound_by, bytes, flops, route)}."""
    n = bh * seq * d * itemsize
    fwd_route = ((3, TF32_FLOPS, "3xTF32 at 495 TFLOP/s") if itemsize == 4
                 else (1, BF16_FLOPS, "bf16 at 989 TFLOP/s"))
    bwd_route = ((1, FP32_FLOPS, "fp32 FMAs at 67 TFLOP/s") if itemsize == 4
                 else (1, BF16_FLOPS, "bf16 at 989 TFLOP/s, the peak for "
                       "bf16 inputs; the kernel computes in fp32 FMAs"))
    out = {}
    for kind, nbytes, flops, (products, rate, route) in (
            ("fwd", 4 * n + 4 * bh * seq, 4 * bh * seq * seq * d,
             fwd_route),
            ("bwd", 7 * n + 8 * bh * seq, 10 * bh * seq * seq * d,
             bwd_route)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * flops / rate
        out[kind] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     flops, route)
    return out


def flash_fwd_attributes(q, k, v):
    """(registers a thread, local bytes a thread, static and dynamic
    shared bytes a block) of the forward kernel these inputs launch."""
    import ctypes
    from mxnet_tpu_torch.kernels import flash_attention as fa
    out = (ctypes.c_int * 4)()
    rc = fa._lib().flash_fwd_attributes(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.shape[-1],
        fa._DTYPE_CODES[q.dtype], out)
    check(rc == 0, "flash_fwd_attributes: error %d" % rc)
    return tuple(out)


def flash_fp64_errors(q, k, v, scale):
    """The fp32 forward kernel and the plain fp32 version against an
    fp64 reference: {name: (out mean relative error, out max relative
    error, lse max absolute error)}."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    ref = torch.matmul(torch.softmax(s, -1), v.double())
    ref_lse = torch.logsumexp(s, -1)
    out = {}
    for name, fn in (("kernel", fa.flash_attention_fwd_cuda),
                     ("plain", fa.flash_attention_fwd_reference)):
        o, lse = fn(q, k, v, scale=scale)
        err = (o.double() - ref).abs()
        out[name] = (float(err.mean() / ref.abs().mean()),
                     float(err.max() / ref.abs().max()),
                     float((lse.double() - ref_lse).abs().max()))
    return out


def flash_times(bh, seq, d, dtype):
    """Times of the flash forward and backward kernels at ``(bh, seq,
    d)`` in ``dtype``, of their plain versions and of SDPA (the
    backward's: SDPA forward+backward through autograd, less its
    forward), with each one's bound; printed and returned as ``(fwd,
    bwd)`` dicts."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, _ = flash_inputs(bh, seq, d, dtype)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, scale=scale)
    delta = (do.float() * out.float()).sum(-1)
    b = bh // BERT_HEADS
    q4, k4, v4, do4 = (t.view(b, BERT_HEADS, seq, d) for t in (q, k, v, do))
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
           "library_ms": lib_both - fwd["library_ms"]}
    key = str(dtype).split(".")[-1]
    for kind, t in (("fwd", fwd), ("bwd", bwd)):
        t["bound_ms"], t["bound_by"], nbytes, flops, route = \
            flash_bounds(bh, seq, d, q.element_size())[kind]
        extra = ""
        if kind == "fwd" and dtype == torch.float32:
            extra = "; CUDA-core bound %.4f ms (fp32 FMAs at 67 TFLOP/s)" \
                % (1e3 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S))
        print("flash %s times (bh %d, seq %d, d %d, %s): %s (%d bytes, %d "
              "flops as %s)%s%s"
              % (kind, bh, seq, d, key, json.dumps(t), nbytes, flops, route,
                 extra,
                 "; library = SDPA forward+backward %.4f ms less its "
                 "forward" % lib_both if kind == "bwd"
                 else "; library = SDPA forward"))
    return fwd, bwd


def flash_kernel_phase(bh, seq, d):
    import torch
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype).split(".")[-1]] = flash_check(bh, seq, d, dtype)
    flash_check(2 * BERT_HEADS, seq, d, torch.float32, causal=True)
    flash_check(2 * BERT_HEADS, seq, d, torch.float32, masked=True)
    # causal with a row that has no key, left of the skipped tiles
    for dtype in (torch.float32, torch.bfloat16):
        flash_check(2 * BERT_HEADS, seq, d, dtype, causal=True, masked=True)
    flash_check(2 * BERT_HEADS, 500, d, torch.float32)
    flash_check(2 * BERT_HEADS, 500, d, torch.bfloat16, masked=True)

    q, k, v, do, _ = flash_inputs(bh, seq, d, torch.float32)
    # fp32's accuracy: 3xTF32 with rounded adds holds the plain fp32
    # version's mean error against fp64 within 4x, also where v's mean
    # is far from 0 and an accumulation that rounds toward zero shows
    n = 8 * BERT_HEADS
    for what, vv in (("v", v[:n]), ("v * 0.05 + 1", v[:n] * 0.05 + 1)):
        errs64 = flash_fp64_errors(q[:n], k[:n], vv, d ** -0.5)
        print("flash fwd vs fp64 (bh %d, seq %d, d %d, fp32, %s): %s"
              % (n, seq, d, what, json.dumps(errs64)))
        check(errs64["kernel"][0] <= 4 * errs64["plain"][0],
              "flash fwd (%s): mean error against fp64 %.3g > 4x the "
              "plain version's %.3g" % (what, errs64["kernel"][0],
                                        errs64["plain"][0]))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    for x in ((q, k, v), (qb, kb, vb)):
        regs, local, static, dynamic = flash_fwd_attributes(*x)
        print("flash_fwd_kernel (d %d, %s): %d registers a thread, %d "
              "local bytes a thread, %d static + %d dynamic shared bytes "
              "a block" % (d, x[0].dtype, regs, local, static, dynamic))
        check(local == 0, "flash_fwd_kernel (d %d, %s) spills: %d local "
              "bytes" % (d, x[0].dtype, local))
    fwd, bwd = flash_times(bh, seq, d, torch.float32)
    flash_times(bh, seq, d, torch.bfloat16)
    return {"fwd": dict(fwd, max_abs_err=errs["float32"][0],
                        max_abs_err_bf16=errs["bfloat16"][0]),
            "bwd": dict(bwd, max_abs_err=errs["float32"][1],
                        max_abs_err_bf16=errs["bfloat16"][1])}


def layernorm_check(rows, dim, dtype, gen):
    """The LayerNorm kernel against its plain version: the largest
    error relative to the largest output."""
    import torch
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference)
    x = (torch.randn(rows, dim, generator=gen, device="cuda") * 3 + 1) \
        .to(dtype)
    g = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    err = rel_err(layernorm_fwd_cuda(x, g, b), layernorm_reference(x, g, b))
    key = str(dtype).split(".")[-1]
    print("layernorm (%d, %d) %s: rel err %.3g (limit %g)"
          % (rows, dim, key, err, ROW_TOL[key]))
    check(err <= ROW_TOL[key], "layernorm (%d, %d) %s: %.3g > %g"
          % (rows, dim, key, err, ROW_TOL[key]))
    return err


def layernorm_times(rows, dim, dtype, gen):
    """Times of the LayerNorm kernel, its plain version and
    ``F.layer_norm`` on ``(rows, dim)`` rows of ``dtype`` (fp32 gamma and
    beta, as the layers hold them), with the bound: the rows read and
    written once at 3.35 TB/s, 8 fp32 operations an element."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference)
    x = torch.randn(rows, dim, generator=gen, device="cuda").to(dtype)
    g = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    t = {"ms": time_ms(lambda: layernorm_fwd_cuda(x, g, b)),
         "plain_ms": time_ms(lambda: layernorm_reference(x, g, b)),
         "library_ms": time_ms(lambda: F.layer_norm(
             x, (dim,), g.to(dtype), b.to(dtype)))}
    nbytes = 2 * rows * dim * x.element_size() + 2 * dim * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * rows * dim / FP32_FLOPS
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print("layernorm times (%d, %d) %s: %s (%d bytes at 3.35 TB/s); "
          "library = F.layer_norm" % (rows, dim, str(dtype).split(".")[-1],
                                      json.dumps(t), nbytes))
    return t


def layernorm_kernel_phase(rows, dim):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    for r, c in ((rows, dim), (1000, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            errs[key] = max(errs.get(key, 0.0),
                            layernorm_check(r, c, dtype, gen))
    t = layernorm_times(rows, dim, torch.float32, gen)
    return dict(t, max_abs_err=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"])


def bert_bf16_kernel_phase(shapes=BERT_BF16_SHAPES, d=64, dim=768):
    """The kernels of the bf16 BERT path at its shapes: flash forward
    and backward in bf16 at ``(batch * 12, seq, 64)``, LayerNorm on the
    path's ``batch * seq`` rows in fp32 (the residual sites) and bf16
    (the MLM head), each held against its plain version and timed beside
    its plain version, its library call and its bound."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {"flash_attention_fwd": {}, "flash_attention_bwd": {},
           "layernorm_fwd": {}}
    for batch, seq in shapes:
        bh = batch * BERT_HEADS
        fwd_err, bwd_err = flash_check(bh, seq, d, torch.bfloat16)
        fwd, bwd = flash_times(bh, seq, d, torch.bfloat16)
        key = "%dx%d" % (batch, seq)
        out["flash_attention_fwd"][key] = dict(
            fwd, max_abs_err=fwd_err, shape=[bh, seq, d], dtype="bfloat16")
        out["flash_attention_bwd"][key] = dict(
            bwd, max_abs_err=bwd_err, shape=[bh, seq, d], dtype="bfloat16")
    rows = {b * s for b, s in shapes}
    check(len(rows) == 1, "the bf16 shapes differ in tokens: %s" % rows)
    rows = rows.pop()
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        err = layernorm_check(rows, dim, dtype, gen)
        out["layernorm_fwd"][key] = dict(
            layernorm_times(rows, dim, dtype, gen), max_abs_err=err,
            shape=[rows, dim])
    return out


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
    # the kernel reads them on the device, as a captured step feeds them
    sc = torch.tensor(scalars, dtype=torch.float32, device="cuda")

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
        got = lamb_phase1_cuda(w, g, m, v, wd, sc, beta1=b1, beta2=b2,
                               eps=eps)
        want = lamb1_reference(w, g, m, v, wd, sc, beta1=b1, beta2=b2,
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

    t = {"ms": time_ms(lambda: lamb_phase1_cuda(w, g, m, v, wd, sc,
                                                beta1=b1, beta2=b2,
                                                eps=eps)),
         "plain_ms": time_ms(lambda: lamb1_reference(
             w, g, m, v, wd, sc, beta1=b1, beta2=b2, eps=eps)),
         "library_ms": time_ms(foreach_phase1)}
    nbytes = 8 * n * 4 + 12         # and the three per-step scalars
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
    # the kernel reads it on the device, as a captured step feeds it
    rescale_t = torch.tensor([rescale], dtype=torch.float32, device="cuda")
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
        got = lars_flat_cuda(w, g, m, lr, wd, sign, rescale_t,
                             momentum=mom)
        want = lars_flat_reference(w, g, m, lr, wd, sign, rescale_t,
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
                 w, g, m, lr, wd, sign, rescale_t, momentum=mom)),
             "plain_ms": time_ms(lambda: lars_flat_reference(
                 w, g, m, lr, wd, sign, rescale_t, momentum=mom)),
             "library_ms": time_ms(foreach_lars)}
        # reads w, g, m and the fp32 lr, wd, sign; writes w', m'
        nbytes = n * (5 * itemsize + 12) + 4     # and the rescale
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


# ---------------------------------------------------------------------
# phase 13: checkpoint, resume and serve
# ---------------------------------------------------------------------

CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "ckpt-smoke")
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_REQUESTS = 512
SERVE_CLIENTS = 8
SERVE_PROFILED_REQUESTS = 128
# a response against the restored net's own batch-1 forward, TF32 off:
# cuDNN may take another algorithm at each batch size, so the last bits
# differ (fp32 sums in another order), never more
SERVE_REL_TOL = 1e-4
# the step after a resume against the same step of the original, where
# cuDNN's deterministic algorithms do not make them bitwise equal
RESUME_NORM_TOL = 1e-6


def _manifest_files(root, step):
    from mxnet_tpu_torch.checkpoint import CheckpointManager, load_manifest
    return load_manifest(CheckpointManager(root).step_dir(step))["files"]


def checkpoint_phase(net, step, x, y, make_net=resnet50_nhwc,
                     root=CKPT_ROOT, device="cuda"):
    """Save the trained net and its trainer with ``save_training``
    (synchronously, then again with ``async_save=True``), resume both
    into a fresh net and ``Trainer`` with ``restore_training``, hold
    every parameter and momentum state bitwise, then take one more step
    on the resumed pair and on the original on the same batch with
    cuDNN's deterministic algorithms.  Returns the sync root."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import TrainStep
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shutil.rmtree(root, ignore_errors=True)
    sync_root = os.path.join(root, "sync")
    async_root = os.path.join(root, "async")
    trainer = step._trainer
    sync()
    t0 = time.perf_counter()
    CheckpointManager(sync_root).save_training(TRAIN_STEPS, net, trainer)
    sync_s = time.perf_counter() - t0
    mgr = CheckpointManager(async_root, async_save=True)
    t0 = time.perf_counter()
    mgr.save_training(TRAIN_STEPS, net, trainer)
    async_return_s = time.perf_counter() - t0
    mgr.wait_until_finished()
    async_s = time.perf_counter() - t0
    files = _manifest_files(sync_root, TRAIN_STEPS)
    check(files == _manifest_files(async_root, TRAIN_STEPS),
          "the async save's files differ from the sync save's")
    nbytes = sum(e["bytes"] for e in files.values())

    fresh = make_net()
    fresh.initialize(device=device)
    fresh_tr = gluon.Trainer(fresh.collect_params(), "sgd", TRAIN_SGD)
    t0 = time.perf_counter()
    ckpt = CheckpointManager(async_root).restore_training(fresh, fresh_tr)
    sync()
    restore_s = time.perf_counter() - t0
    check(ckpt is not None and ckpt.step == TRAIN_STEPS,
          "restore_training found no step %d" % TRAIN_STEPS)
    old = net._collect_params_with_prefix()
    new = fresh._collect_params_with_prefix()
    check(sorted(old) == sorted(new), "resumed net has other parameters")
    unequal = [k for k in old if not torch.equal(old[k]._data, new[k]._data)]
    check(not unequal, "resumed parameters differ: %s" % unequal[:5])
    states, got = trainer._updater.states, fresh_tr._updater.states
    live = sum(p.grad_req != "null" for p in old.values())
    check(sorted(states) == sorted(got) and len(states) == live,
          "resumed trainer has %d states, the original %d, for %d "
          "parameters" % (len(got), len(states), live))
    unequal = [i for i in states if not torch.equal(states[i], got[i])]
    check(not unequal, "resumed momentum states differ: %s" % unequal[:5])

    fresh_step = TrainStep(fresh, gluon.loss.SoftmaxCrossEntropyLoss(),
                           fresh_tr)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        loss_a = float(step(x, y))
        loss_b = float(fresh_step(x, y))
        sync()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    num = den = 0.0
    bitwise = True
    for k in old:
        a, b = old[k]._data.detach().double(), new[k]._data.detach().double()
        bitwise = bitwise and torch.equal(a, b)
        num += float(((a - b) ** 2).sum())
        den += float((a ** 2).sum())
    rel = (num / den) ** 0.5
    stats = {"step": TRAIN_STEPS, "bytes": nbytes,
             "files": {k: v["bytes"] for k, v in files.items()},
             "save_s": sync_s, "save_MB_per_s": nbytes / sync_s / 1e6,
             "async_save_return_s": async_return_s,
             "async_save_committed_s": async_s,
             "async_MB_per_s": nbytes / async_s / 1e6,
             "restore_s": restore_s, "params_equal": True,
             "momentum_equal": True, "next_step_losses": [loss_a, loss_b],
             "next_step_bitwise": bitwise,
             "next_step_param_rel_diff": rel,
             "card": gpu_line() if cuda else None}
    print("checkpoint and resume (ResNet-50 v1 NHWC fp32, SGD momentum): "
          "%s" % json.dumps(stats))
    check(loss_a == loss_b, "resumed step loss %r != original %r"
          % (loss_b, loss_a))
    check(bitwise or rel <= RESUME_NORM_TOL,
          "resumed step parameters differ by %.3g > %g (norm-wise)"
          % (rel, RESUME_NORM_TOL))
    del fresh_step, fresh, fresh_tr
    return sync_root


def _client_bursts(rng, n, clients):
    """Each client's bursts: its share of ``n`` request indices cut into
    runs of 1-32."""
    shares = [list(range(c, n, clients)) for c in range(clients)]
    bursts = []
    for share in shares:
        mine = []
        while share:
            k = int(rng.randint(1, 33))
            mine.append(share[:k])
            share = share[k:]
        bursts.append(mine)
    return bursts


def _serve(sv, images, bursts):
    """Run the clients: each submits a burst, waits for all of it, then
    submits its next.  Returns ``(responses, latencies, wall seconds)``."""
    n = len(images)
    responses = [None] * n
    done = [None] * n
    sent = [None] * n
    errors = []

    def client(mine):
        try:
            for burst in mine:
                futs = []
                for i in burst:
                    sent[i] = time.perf_counter()
                    f = sv.submit(images[i], timeout=120)
                    f.add_done_callback(
                        lambda _f, i=i: done.__setitem__(
                            i, time.perf_counter()))
                    futs.append((i, f))
                for i, f in futs:
                    responses[i] = f.result(timeout=120)
        except BaseException as e:     # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(mine,), daemon=True)
               for mine in bursts]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a serving client hung")
    check(not errors, "serving client errors: %r" % (errors[:3],))
    check(all(r is not None for r in responses),
          "%d requests got no response"
          % sum(r is None for r in responses))
    return responses, np.array(done) - np.array(sent), wall


def serve_phase(root, make_net=resnet50_nhwc, image=224,
                buckets=SERVE_BUCKETS, requests=SERVE_REQUESTS,
                clients=SERVE_CLIENTS, sites=BN_RELU_SITES, device="cuda"):
    """Serve the checkpoint through ``ModelRegistry.register(block=,
    checkpoint=)``: ``clients`` threads send ``requests`` single images
    in bursts of 1-32; the launch counters are zeroed after registration
    and read after the drain.  Each response is held against the
    restored net's own batch-1 forward."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import ModelRegistry, ServableClosed
    cuda = device == "cuda"
    net = make_net()
    net.initialize(device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    sv = reg.register("resnet50", block=net, checkpoint=root,
                      input_shape=(image, image, 3), buckets=buckets)
    register_s = time.perf_counter() - t0
    check(sv.source == "checkpoint", "servable source %r" % sv.source)
    check(sv._pool.warm_buckets() == list(buckets),
          "warm buckets %s" % sv._pool.warm_buckets())
    # the served weights are the newest step's, bit for bit
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.ndarray.ndarray import load_tensors
    mgr = CheckpointManager(root)
    saved = load_tensors(os.path.join(mgr.step_dir(mgr.latest_step()),
                                      "params.params"))
    served = net._collect_params_with_prefix()
    check(sorted(saved) == sorted(served), "served parameter names differ "
          "from the checkpoint's")
    differ = [k for k, p in served.items()
              if not torch.equal(p._data.cpu(), saved[k])]
    check(not differ, "served parameters differ from the checkpoint: %s"
          % differ[:5])
    del saved
    rng = np.random.RandomState(0)
    images = rng.standard_normal(
        (requests, image, image, 3)).astype(np.float32)
    bursts = _client_bursts(rng, requests, clients)

    # the worker's time a batch: assembling it, the pool's call (the
    # copy to the card and the forward's launches), then waiting for the
    # logits and answering; and the wait for requests between batches
    marks = []
    batcher, pool = sv._batcher, sv._pool
    dispatch, call = batcher._dispatch, pool.call

    def timed_dispatch(reqs):
        marks.append([time.perf_counter(), None, None, None])
        dispatch(reqs)
        marks[-1][3] = time.perf_counter()

    def timed_call(bucket, x):
        marks[-1][1] = time.perf_counter()
        out = call(bucket, x)
        marks[-1][2] = time.perf_counter()
        return out

    batcher._dispatch, pool.call = timed_dispatch, timed_call
    registry.reset_launches()
    responses, lat, wall = _serve(sv, images, bursts)
    del batcher._dispatch, pool.call
    t = np.array(marks)
    split = {"assemble_ms": 1e3 * float(np.mean(t[:, 1] - t[:, 0])),
             "call_ms": 1e3 * float(np.mean(t[:, 2] - t[:, 1])),
             "wait_and_answer_ms": 1e3 * float(np.mean(t[:, 3] - t[:, 2])),
             "between_batches_ms": 1e3 * float(np.mean(t[1:, 0]
                                                       - t[:-1, 3]))}
    stats = sv.stats()
    n_calls = stats["batches"]
    launches = registry.launches("bn_relu_apply")
    peak = torch.cuda.max_memory_allocated() if cuda else None

    idle = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        sub = images[:SERVE_PROFILED_REQUESTS]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            _serve(sv, sub, _client_bursts(rng, len(sub), clients))
            torch.cuda.synchronize()
            window = time.perf_counter() - t1
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        check(busy > 0, "the profiler saw no device time while serving")
        idle = 1 - busy / 1e6 / window
        check(idle >= 0, "profiler device time %.6f s exceeds the serving "
              "window %.6f s" % (busy / 1e6, window))
    after = sv.stats()
    reg.shutdown(drain=True)
    check(sv.closed, "servable still open after shutdown")
    check(sv.stats() == after, "responses after shutdown(drain=True)")
    try:
        sv.submit(images[0])
    except ServableClosed:
        pass
    else:
        raise SmokeFailure("a closed servable took a request")

    check(stats.get("responses") == requests and
          stats.get("timeouts", 0) == stats.get("shed", 0) ==
          stats.get("errors", 0) == 0,
          "serving counts %s for %d requests" % (stats, requests))
    check(sum(v for k, v in stats.items() if k.startswith("bucket_"))
          == n_calls, "bucket histogram does not sum to the %d batches"
          % n_calls)
    check(launches == sites * n_calls, "bn_relu_apply launches %d != %d "
          "sites x %d executor calls" % (launches, sites, n_calls))

    worst = 0.0
    with torch.inference_mode(), autograd.pause():
        for img, got in zip(images, responses):
            want = net(torch.from_numpy(img[None]).to(device))[0]
            want = want.cpu().numpy()
            check(got.shape == want.shape and np.isfinite(got).all(),
                  "response of shape %s, want %s" % (got.shape, want.shape))
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
    check(worst <= SERVE_REL_TOL, "served logits differ from the batch-1 "
          "forward by %.3g > %g (relative to the largest)"
          % (worst, SERVE_REL_TOL))

    # closed loop: the largest bucket's call back to back, host batch in
    # and host logits out, as the batcher dispatches it
    batch = np.ascontiguousarray(images[:buckets[-1]])
    loops = 20
    for _ in range(2):
        sv._pool.call(buckets[-1], batch)[0].cpu()
    t0 = time.perf_counter()
    for _ in range(loops):
        sv._pool.call(buckets[-1], batch)[0].cpu()
    closed = buckets[-1] * loops / (time.perf_counter() - t0)

    hist = {k.split("_")[1]: v for k, v in sorted(stats.items())
            if k.startswith("bucket_")}
    out = {"requests": requests, "clients": clients, "register_s": register_s,
           "requests_per_s": requests / wall,
           "latency_p50_ms": 1e3 * float(np.percentile(lat, 50)),
           "latency_p99_ms": 1e3 * float(np.percentile(lat, 99)),
           "batches": stats["batches"], "bucket_histogram": hist,
           "mean_batch": requests / stats["batches"],
           "worker_split": split,
           "bn_relu_apply_launches": launches,
           "max_rel_err": worst, "rel_tol": SERVE_REL_TOL,
           "device_idle_share": idle,
           "profiled_requests": SERVE_PROFILED_REQUESTS if cuda else 0,
           "closed_loop_img_per_s_bucket%d" % buckets[-1]: closed,
           "peak_mem_bytes": peak, "card": gpu_line() if cuda else None}
    print("serving from the checkpoint (ResNet-50 v1 NHWC fp32, %d "
          "clients): %s" % (clients, json.dumps(out)))
    if cuda:
        capture_report(
            "serving buckets (ResNet-50 from the checkpoint)",
            dict(sv._pool.capture_stats(), keys=list(buckets)),
            {"requests_per_s": out["requests_per_s"],
             "call_ms": split["call_ms"],
             "closed_loop_img_per_s": closed}, idle, 1)
    return out


def decode_checkpoint_phase(root=CKPT_ROOT, widths=GPT2_SMALL,
                            max_new=DECODE_MAX_NEW, device="cuda"):
    """The decode path's weights saved as a ``params`` item and served by
    ``register_generative(checkpoint=)``: each prompt's greedy stream,
    generated one request at a time, must equal the ``params=`` route's.
    The counters are zeroed before the checkpoint route's registration
    and read after its last stream."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import ModelRegistry
    from mxnet_tpu_torch.serving.decode import tiny_gpt
    model = tiny_gpt(**widths)
    params = model.init_params(seed=0, device=device)
    root = os.path.join(root, "gpt2")
    t0 = time.perf_counter()
    CheckpointManager(root).save(0, {"params": params})
    save_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.vocab_size, n).tolist()
               for n in DECODE_PROMPT_LENGTHS]
    reg = ModelRegistry()
    reg.register_generative("gpt2-params", model, params=params,
                            device=device)
    want = [reg.generate("gpt2-params", p, max_new).tokens()
            for p in prompts]
    reg.unregister("gpt2-params")
    del params

    registry.reset_launches()
    sv = reg.register_generative("gpt2", model, checkpoint=root,
                                 device=device)
    t0 = time.perf_counter()
    got = [reg.generate("gpt2", p, max_new).tokens() for p in prompts]
    wall = time.perf_counter() - t0
    steps = sv.engine.decode_steps
    reg.shutdown(drain=True)
    if device == "cuda":
        eng = sv.engine
        capture_report(
            "decode from a checkpoint (one request at a time)",
            eng.capture_stats(),
            {"tokens_per_s": sum(len(t) for t in got) / wall}, None, 1)
    launches = registry.launches("paged_attention")
    stats = {"prompts": len(prompts), "max_new": max_new,
             "save_s": save_s, "decode_steps": steps,
             "paged_attention_launches": launches,
             "streams_equal": got == want}
    print("decode from a checkpoint (GPT-2 small widths): %s"
          % json.dumps(stats))
    check(all(len(t) == max_new for t in got), "a stream ended early")
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(not differ, "checkpoint route streams differ from params= at "
          "prompts %s" % differ)
    check(launches == model.num_layers * steps,
          "paged_attention launches %d != %d layers x %d decode steps"
          % (launches, model.num_layers, steps))
    return stats


# ---------------------------------------------------------------------
# phase 14: DenseNet-121 NHWC, the model zoo and the mx.nd kernel routes
# ---------------------------------------------------------------------

DENSENET_BATCH = 64
# DenseNet-121's oracle holds each parameter's update to max(5e-2, this
# times its own permuted-batch floor): the stem BatchNorm's gamma moves
# 0.15-0.44 between two CPU steps that sum in another order, past the
# 5e-2 no step can meet; the norm-wise 2e-2 stays
DENSENET_FLOOR_FACTOR = 4.0
DENSENET_LOOP_STEPS = 5
# (init features, growth, block config) of DenseNet-121
DENSENET121_SPEC = (64, 32, (6, 12, 24, 16))
ZOO_BATCH = 8
# forwards a zoo net: the call sizing deferred shapes, eager, captured, replayed
ZOO_CALLS = 4


def densenet121_nhwc():
    from mxnet_tpu_torch.gluon.model_zoo.vision import densenet121
    return densenet121(layout="NHWC")


def densenet_site_shapes(batch, image=224, spec=DENSENET121_SPEC):
    """NHWC shape of each fused BatchNorm+ReLU site of a DenseNet forward,
    in order: the stem; in each dense block, each layer's input (its
    channels growing by ``growth``) then its bottleneck (4 x growth); each
    transition; the head."""
    init, growth, blocks = spec
    side = image // 4                   # the stride-2 stem and max pool
    shapes = [(batch, image // 2, image // 2, init)]
    c = init
    for i, layers in enumerate(blocks):
        for j in range(layers):
            shapes += [(batch, side, side, c + j * growth),
                       (batch, side, side, 4 * growth)]
        c += layers * growth
        if i != len(blocks) - 1:
            shapes.append((batch, side, side, c))     # the transition's
            c //= 2
            side //= 2
    shapes.append((batch, side, side, c))             # the head's
    return shapes


def densenet_kernel_checks(batch=DENSENET_BATCH):
    """Both fused kernels against their plain versions at every distinct
    ``(rows, C)`` DenseNet-121 gives them at ``batch``, fp32, and the
    times of three: the stem, the largest site of dense block 3's
    resolution (its transition) and the head."""
    import torch
    sites = densenet_site_shapes(batch)
    distinct = sorted(set(sites), key=lambda s: (-s[1], s[3]))
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape in distinct:
        for kind, (err, limit) in bn_relu_errors(shape,
                                                 torch.float32).items():
            worst[kind] = max(worst[kind], err / limit)
    print("bn_relu at DenseNet-121's %d distinct site shapes (batch %d, "
          "rows %d..%d, C %d..%d; every C a multiple of 32, the kernels' "
          "16-byte vector path): largest error over its limit fwd %.3g, "
          "bwd %.3g (limit %g of the largest output)"
          % (len(distinct), batch, min(int(np.prod(s[:3])) for s in sites),
             max(int(np.prod(s[:3])) for s in sites),
             min(s[3] for s in sites), max(s[3] for s in sites),
             worst["fwd"], worst["bwd"], BN_RELU_RTOL["float32"]))
    stage3 = [t for t in sites if t[1] == sites[0][1] // 8]
    timed = {"stem": sites[0], "stage3_largest": max(stage3,
                                                     key=lambda t: t[3]),
             "head": sites[-1]}
    times = {}
    for what, shape in timed.items():
        times[what] = dict(shape=list(shape), rows=int(np.prod(shape[:3])),
                           **bn_relu_shape_times(shape, torch.float32))
        print("bn_relu times DenseNet-121 %s %s fp32: %s"
              % (what, shape, json.dumps(times[what])))
    return {"distinct_shapes": len(distinct),
            "max_err_over_limit": worst, "times": times}


def densenet_loop(net, trainer, loss_fn, x, y, steps, batch):
    """``steps`` steps of the loop users write: the hybridized net under
    ``autograd.record()``, ``loss.backward()``, then
    ``trainer.allreduce_grads()`` and ``trainer.update(batch)``.  Returns
    the losses (device means)."""
    from mxnet_tpu_torch import autograd
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.allreduce_grads()
        trainer.update(batch)
        losses.append(loss._data.detach().mean())
    return losses


def densenet_loop_split(net, trainer, loss_fn, x, y, batch, cuda):
    """Host ms of each part of one more loop step, the device drained
    after each: forward and loss, ``backward``, ``allreduce_grads``,
    ``update``."""
    import torch
    from mxnet_tpu_torch import autograd
    marks = [time.perf_counter()]

    def mark():
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    with autograd.record():
        loss = loss_fn(net(x), y)
    mark()
    loss.backward()
    mark()
    trainer.allreduce_grads()
    mark()
    trainer.update(batch)
    mark()
    return dict(zip(("forward", "backward", "allreduce_grads", "update"),
                    (1e3 * (b - a) for a, b in zip(marks, marks[1:]))))


def densenet_loop_profile(net, trainer, loss_fn, x, y, batch, step_ms,
                          steps=3):
    """Device busy ms a step of the loop from ``torch.profiler`` over
    ``steps`` steps run back to back, its launches a step and the
    device's idle share against the unprofiled ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        densenet_loop(net, trainer, loss_fn, x, y, steps, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time in the DenseNet loop")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return {"steps": steps, "device_busy_ms_per_step": busy,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "device_idle_share": max(0.0, 1 - busy / step_ms)}


def densenet_imperative_path(batch=DENSENET_BATCH, image=224,
                             steps=DENSENET_LOOP_STEPS,
                             sites=DENSENET_SITES, ctx=None):
    """DenseNet-121 NHWC trained by the imperative loop (SGD 0.05/0.9,
    ``Trainer(kvstore="device")``): WARM_STEPS warm-up steps (eager,
    then captured), the counters zeroed, ``steps`` timed steps."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.kernels import registry
    ctx = mx.gpu() if ctx is None else ctx
    cuda = ctx.device_type == "gpu"
    net = densenet121_nhwc()
    net.initialize(ctx=ctx, generator=torch.Generator().manual_seed(0))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(TRAIN_SGD),
                            kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    gen = torch.Generator(device=ctx.torch_device()).manual_seed(0)
    x = mx.nd.NDArray(torch.randn((batch, image, image, 3), generator=gen,
                                  device=ctx.torch_device()))
    y = mx.nd.NDArray(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=ctx.torch_device()).float())
    densenet_loop(net, trainer, loss_fn, x, y, WARM_STEPS, batch)
    if cuda:
        torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    losses = densenet_loop(net, trainer, loss_fn, x, y, steps, batch)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    fwd, bwd = (registry.launches("bn_relu_apply"),
                registry.launches("bn_relu_bwd"))
    split = densenet_loop_split(net, trainer, loss_fn, x, y, batch, cuda)
    stats = {"batch": batch, "steps": steps, "losses": losses,
             "ms_per_step": 1e3 * wall / steps,
             "img_per_s": batch * steps / wall,
             "one_step_host_ms_synchronized": split,
             "profiled": densenet_loop_profile(
                 net, trainer, loss_fn, x, y, batch,
                 1e3 * wall / steps) if cuda else None,
             "bn_relu_apply_launches": fwd, "bn_relu_bwd_launches": bwd,
             "cache": {k: v for k, v in net.cache_stats()["graphs"].items()}
             if cuda else None,
             "card": gpu_line() if cuda else None}
    print("DenseNet-121 imperative loop (hybridized, record/backward, "
          "Trainer(kvstore=\"device\") allreduce_grads/update): %s"
          % json.dumps(stats))
    check(all(np.isfinite(losses)), "DenseNet loop: non-finite loss %s"
          % losses)
    check(losses[-1] < losses[0], "DenseNet loop: loss did not fall: %s"
          % losses)
    if sites:
        check(fwd == sites * steps and bwd == sites * steps,
              "DenseNet loop: bn_relu launches %d/%d != %d sites x %d steps"
              % (fwd, bwd, sites, steps))
    return stats


def zoo_sweep(names=None, batch=ZOO_BATCH, device="cuda"):
    """Every ``get_model`` net with ``layout="NHWC"``, 1000 classes, eval
    and hybridized, ZOO_CALLS forwards of one batch of 224 x 224 (299
    for Inception V3): logits of shape (batch, 1000), finite, and
    ``bn_relu_apply`` launched ZOO_FUSED_SITES[name] times a forward."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import registry
    out = {}
    for name in names or sorted(ZOO_FUSED_SITES):
        side = 299 if name == "inceptionv3" else 224
        net = vision.get_model(name, layout="NHWC")
        net.initialize(device=device,
                       generator=torch.Generator().manual_seed(0))
        net.hybridize()
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((batch, side, side, 3), generator=gen, device=device)
        registry.reset_launches()
        with torch.no_grad():
            logits = [net(x) for _ in range(ZOO_CALLS)]
        launches = registry.launches("bn_relu_apply")
        graphs = sum(g["graphs"] for g in net.cache_stats()["graphs"]
                     .values()) if device == "cuda" else 0
        ok = all(tuple(v.shape) == (batch, 1000)
                 and bool(torch.isfinite(v).all()) for v in logits)
        same = float((logits[-1] - logits[1]).abs().max())
        out[name] = {"launches": launches, "sites": ZOO_FUSED_SITES[name],
                     "graphs": graphs, "replay_vs_eager_max_abs": same}
        check(ok, "zoo %s: logits not (%d, 1000) and finite" % (name, batch))
        if device == "cuda":
            check(launches == ZOO_CALLS * ZOO_FUSED_SITES[name],
                  "zoo %s: bn_relu_apply launches %d != %d forwards x %d "
                  "sites" % (name, launches, ZOO_CALLS,
                             ZOO_FUSED_SITES[name]))
            check(graphs >= 1, "zoo %s: no graph captured" % name)
        del net, x, logits
        if device == "cuda":
            torch.cuda.empty_cache()
    print("zoo sweep (get_model, NHWC, eval, hybridized, batch %d, %d "
          "forwards each): %s" % (batch, ZOO_CALLS, json.dumps(out)))
    return out


def nd_kernel_routes(device="cuda"):
    """``mx.nd.flash_attention``, ``flash_attention_masked`` and
    ``fused_batch_norm_relu`` on CUDA NDArrays, forward and backward
    under ``autograd.record``: each launches its kernels, counted, and
    matches its plain version; ``fused_batch_norm_relu`` on NCHW
    launches none (``relu(BatchNorm)``, as the JAX op)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, ops
    from mxnet_tpu_torch.kernels import registry
    gen = torch.Generator(device=device).manual_seed(3)

    def nd(*shape, scale=1.0, shift=0.0):
        a = mx.nd.NDArray(torch.randn(shape, generator=gen, device=device)
                          * scale + shift)
        a.attach_grad()
        return a

    def run(fn, ins, head):
        registry.reset_launches()
        with autograd.record():
            out = fn(*ins)
        out = out[0] if isinstance(out, (list, tuple)) else out
        out.backward(head)
        if device == "cuda":
            torch.cuda.synchronize()
        names = ("flash_attention_fwd", "flash_attention_bwd",
                 "bn_relu_apply", "bn_relu_bwd")
        launches = {n: registry.launches(n) for n in names
                    if registry.launches(n)}
        return out._data.detach(), [a.grad._data for a in ins
                                    if a.grad is not None], launches

    def plain(fn, ins, head):
        xs = [a._data.detach().clone().requires_grad_(True) for a in ins]
        out = fn(*xs)
        out = out[0] if isinstance(out, (list, tuple)) else out
        out.backward(head._data)
        return out.detach(), [t.grad for t in xs if t.grad is not None]

    def rel(got, want):
        return float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))

    bh, seq, d, heads = 24, 128, 64, 12
    q, k, v = (nd(bh, seq, d) for _ in range(3))
    mask = mx.nd.NDArray((torch.rand((bh // heads, seq, seq), generator=gen,
                                     device=device) > 0.2).float())
    mask._data[:, :, 0] = 1.0
    head_attn = nd(bh, seq, d)
    x_nhwc = nd(16, 14, 14, 256, scale=2.0, shift=1.0)
    x_nchw = nd(16, 256, 14, 14, scale=2.0, shift=1.0)
    vecs = [nd(256, scale=0.2, shift=1.0), nd(256), nd(256, scale=0.1),
            nd(256, scale=0.1, shift=2.0)]
    cases = {
        "flash_attention": (
            lambda a, b, c: mx.nd.flash_attention(a, b, c, causal=True),
            lambda a, b, c: ops.attention_reference(a, b, c, causal=True),
            [q, k, v], head_attn, FLASH_TOL["float32"],
            {"flash_attention_fwd": 1, "flash_attention_bwd": 1}),
        "flash_attention_masked": (
            lambda a, b, c: mx.nd.flash_attention_masked(a, b, c, mask,
                                                         heads=heads),
            lambda a, b, c: ops.attention_reference(a, b, c,
                                                    mask=mask._data,
                                                    heads=heads),
            [q, k, v], head_attn, FLASH_TOL["float32"],
            {"flash_attention_fwd": 1, "flash_attention_bwd": 1}),
        "fused_batch_norm_relu NHWC": (
            lambda a, g, b: mx.nd.fused_batch_norm_relu(
                a, g, b, vecs[2], vecs[3], axis=3, fix_gamma=False),
            lambda a, g, b: ops.BatchNorm(
                a, g, b, vecs[2]._data, vecs[3]._data, axis=3,
                fix_gamma=False, training=True)[0].relu(),
            [x_nhwc, vecs[0], vecs[1]], nd(16, 14, 14, 256),
            (1e-5, 1e-4), {"bn_relu_apply": 1, "bn_relu_bwd": 1}),
        "fused_batch_norm_relu NCHW": (
            lambda a, g, b: mx.nd.fused_batch_norm_relu(
                a, g, b, vecs[2], vecs[3], fix_gamma=False),
            lambda a, g, b: ops.BatchNorm(
                a, g, b, vecs[2]._data, vecs[3]._data, axis=1,
                fix_gamma=False, training=True)[0].relu(),
            [x_nchw, vecs[0], vecs[1]], nd(16, 256, 14, 14),
            (1e-5, 1e-4), {}),
    }
    out = {}
    for name, (fn, ref, ins, head, (ftol, btol), want) in cases.items():
        for a in ins:
            a.grad._data.zero_()
        got, grads, launches = run(fn, ins, head)
        pout, pgrads = plain(ref, ins, head)
        err = {"fwd": rel(got, pout),
               "bwd": max(rel(g, p) for g, p in zip(grads, pgrads))}
        out[name] = {"launches": launches, "rel_err": err}
        check(launches == (want if device == "cuda" else {}),
              "mx.nd route %s: launches %s, want %s"
              % (name, launches, want))
        check(err["fwd"] <= ftol and err["bwd"] <= btol,
              "mx.nd route %s: kernel vs plain %s > (%g, %g)"
              % (name, err, ftol, btol))
    print("mx.nd kernel routes (CUDA NDArrays, forward and backward under "
          "record; error relative to the largest plain value): %s"
          % json.dumps(out))
    return out


def densenet_phase():
    """DenseNet-121 NHWC fp32 at batch 64: the captured ``TrainStep``
    (2 warm-up, 8 timed) with its breakdown and capture report, the
    oracle, the imperative loop, the kernels at every site shape, the
    zoo sweep and the ``mx.nd`` kernel routes."""
    release_cuda()
    net, step, (x, y), train = train_main_path(
        make_net=densenet121_nhwc, batch=DENSENET_BATCH, sites=DENSENET_SITES,
        label="DenseNet-121 main path (NHWC fp32, SGD 0.05/0.9, captured "
              "TrainStep)", peak_with_warmup=True)
    bd = train_step_breakdown(step, x, y, train["ms_per_step"],
                              label="DenseNet-121 step breakdown")
    capture = capture_report(
        "DenseNet-121 fp32 SGD TrainStep", step.capture_stats(),
        {"ms_per_step": train["ms_per_step"],
         "img_per_s": train["img_per_s"],
         "peak_mem_bytes": train["peak_mem_bytes"]},
        bd["device_idle_share"], 1)
    del step, x, y
    release_cuda()
    oracle = train_oracle(net, make_net=densenet121_nhwc,
                          label="DenseNet-121 oracle (card vs CPU)",
                          floor_factor=DENSENET_FLOOR_FACTOR)
    del net
    release_cuda()
    loop = densenet_imperative_path()
    release_cuda()
    kernels = densenet_kernel_checks()
    release_cuda()
    zoo = zoo_sweep()
    routes = nd_kernel_routes()
    release_cuda()
    return {"main": train, "breakdown": bd, "capture": capture,
            "oracle": oracle, "loop": loop, "kernels": kernels, "zoo": zoo,
            "routes": routes}


# ---------------------------------------------------------------------
# phase 15: the ImageNet input path
# ---------------------------------------------------------------------

# bench.py :: _build_rec's synthetic records: raw 224x224x3 crops of
# 256x256 natural-like images (seed 0), label i % 1000
INPUT_RECORDS = 8192
INPUT_IMAGE = 224
INPUT_SOURCE = 256
INPUT_BATCH = 512                  # BASELINE config 5's batch
INPUT_EPOCHS = 2
INPUT_THREADS = 4
INPUT_THREAD_SWEEP = (0, 1, 2, 4, 8)
INPUT_SWEEP_BATCHES = 3
INPUT_MEAN = (123.68, 116.779, 103.939)     # ImageNet's per-channel mean
INPUT_STD = (58.393, 57.12, 57.375)         # and std, RGB
# steps the loop lets run ahead of the card before it waits on the
# oldest: the back-pressure the JAX TrainStep gets from donated buffers
INPUT_IN_FLIGHT = 2
INPUT_SYNTH_STEPS = 8
INPUT_PROFILED_STEPS = 6
JPEG_RECORDS = 2048
JPEG_QUALITY = 90
JPEG_THREAD_SWEEP = (1, 2, 4, 8)
JPEG_STEPS = 4
INPUT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")


def codec_versions():
    """``{"cv2": version or None, "PIL": version or None}``."""
    out = {}
    for name in ("cv2", "PIL"):
        try:
            mod = __import__(name)
            out[name] = getattr(mod, "__version__", "unknown")
        except ImportError:
            out[name] = None
    return out


def _upsample_linear(a, size):
    """Bilinear upsampling of an HWC uint8 image to ``size`` squared with
    half-pixel centres (OpenCV's INTER_LINEAR in float), for a host
    with neither OpenCV nor PIL."""
    def axis(n_in):
        src = np.clip((np.arange(size) + 0.5) * n_in / size - 0.5, 0,
                      n_in - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (src - lo)[:, None]
    lo, hi, f = axis(a.shape[0])
    a = a.astype(np.float32)
    rows = a[lo] * (1 - f[:, :, None]) + a[hi] * f[:, :, None]
    lo, hi, f = axis(a.shape[1])
    out = rows[:, lo] * (1 - f[None]) + rows[:, hi] * f[None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def make_records(prefix, n, fmt="raw", hw=INPUT_SOURCE, crop=INPUT_IMAGE,
                 seed=0):
    """``bench.py :: _build_rec`` on the port's ``recordio``: ``n``
    natural-like ``hw``-square images from ``seed`` (a 16x16 random
    image upsampled, plus noise in [-8, 8]), label ``i % 1000``; raw
    records hold the top-left ``crop``-square HWC bytes, JPEG records
    the whole image at quality 90 (PIL's encoder, as ``pack_img``; with
    only OpenCV there, OpenCV's).  Returns the ``.rec`` path."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image.image import _resize_np
    codecs = codec_versions()
    rng = np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        base = rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)
        img = (_resize_np(base, hw, hw) if codecs["cv2"] or codecs["PIL"]
               else _upsample_linear(base, hw)).astype(np.int16)
        img += rng.randint(-8, 9, img.shape, dtype=np.int16)
        img = np.clip(img, 0, 255).astype(np.uint8)
        header = recordio.IRHeader(0, float(i % 1000), i, 0)
        if fmt == "raw":
            rec.write_idx(i, recordio.pack(header,
                                           img[:crop, :crop].tobytes()))
        elif codecs["PIL"]:
            rec.write_idx(i, recordio.pack_img(header, img,
                                               quality=JPEG_QUALITY))
        else:
            import cv2
            ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
            check(ok, "cv2.imencode failed")
            rec.write_idx(i, recordio.pack(header, buf.tobytes()))
    rec.close()
    return prefix + ".rec"


def input_iter_kw(batch, image, threads, **extra):
    """``mx.io.ImageRecordIter``'s arguments on this path."""
    kw = dict(data_shape=(3, image, image), batch_size=batch, shuffle=True,
              rand_mirror=True, preprocess_threads=threads,
              mean_r=INPUT_MEAN[0], mean_g=INPUT_MEAN[1],
              mean_b=INPUT_MEAN[2], std_r=INPUT_STD[0], std_g=INPUT_STD[1],
              std_b=INPUT_STD[2])
    kw.update(extra)
    return kw


def host_image_iter(rec, batch, image, threads, rand_crop=False):
    """The ``ImageIter`` that ``ImageRecordIter(ctx=...)`` wraps: uint8,
    crop (centre or random) and mirror on the host."""
    from mxnet_tpu_torch import image as mximage
    aug = [a for a in mximage.CreateAugmenter((3, image, image),
                                              rand_crop=rand_crop,
                                              rand_mirror=True)
           if not isinstance(a, mximage.CastAug)]
    return mximage.ImageIter(batch, (3, image, image), path_imgrec=rec,
                             aug_list=aug, shuffle=True,
                             preprocess_threads=threads, dtype="uint8")


def nhwc_batch(b):
    """The landed CHW batch made NHWC on its device, with its label."""
    from mxnet_tpu_torch.dataio import DeviceBatch
    return DeviceBatch([b.data._data.permute(0, 2, 3, 1).contiguous(),
                        b.label], pad=b.pad)


def streamed_epochs(feed, step, epochs, in_flight, cuda, t0):
    """Train ``step`` on ``epochs`` passes of ``feed`` under bf16 AMP,
    at most ``in_flight`` steps ahead of the card; each epoch's seconds
    run from its first read (``t0``, taken before the feed was made, or
    ``reset``) to the sync after its last step.  Returns the losses (on
    the device) and the epochs' seconds and steps."""
    import torch
    from mxnet_tpu_torch import amp
    losses, epochs_s, steps = [], [], []
    for epoch in range(epochs):
        if epoch:
            t0 = time.perf_counter()
            feed.reset()
        pending, n = [], 0
        with amp.scope("bfloat16"):
            for b in feed:
                losses.append(step(nhwc_batch(b)))
                n += 1
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    pending.append(ev)
                    if len(pending) > in_flight:
                        pending.pop(0).synchronize()
        if cuda:
            torch.cuda.synchronize()
        epochs_s.append(time.perf_counter() - t0)
        steps.append(n)
    return losses, epochs_s, steps


def input_idle_share(feed, step, steps, skip=2):
    """The card's idle share over ``steps`` streamed steps under
    ``torch.profiler``, after ``skip`` unprofiled ones (the feed's fill):
    device busy time over the stretch's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import amp
    feed.reset()
    it = iter(feed)
    with amp.scope("bfloat16"):
        for _ in range(skip):
            step(nhwc_batch(next(it)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pending = []
            for _ in range(steps):
                step(nhwc_batch(next(it)))
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > INPUT_IN_FLIGHT:
                    pending.pop(0).synchronize()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    feed.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    check(kernels, "the profiler saw no device time in the streamed steps")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    copies = sum(e.self_device_time_total for e in kernels
                 if "Memcpy" in e.key or "memcpy" in e.key) / 1e3
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "memcpy_ms": copies}


def input_parts(rec, batch, image, threads, sweep, sweep_batches, cuda):
    """The loader's cost by part, each timed alone: the record read
    (``read_batch``, native thread pool and Python), the host rate of
    ``next_np`` at each thread count of ``sweep``, the pinned copy of a
    batch to the card and ``DeviceTransform`` plus the NHWC transpose on
    it (CUDA events)."""
    import torch
    from mxnet_tpu_torch import _native, recordio
    from mxnet_tpu_torch.dataio import DeviceTransform
    out = {}
    # whether the file reads at the page cache's pace: two sequential
    # passes over the whole .rec in 16 MiB chunks
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        with open(rec, "rb", buffering=0) as f:
            while f.read(16 << 20):
                pass
        passes.append(os.path.getsize(rec) / (time.perf_counter() - t0)
                      / 1e6)
    out["file_sequential_MB_per_s"] = passes
    r = recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    keys = list(np.random.RandomState(1).permutation(len(r.keys)))
    routes = [("python", 1)]
    if _native.load() is not None and (os.cpu_count() or 1) > 1:
        routes.insert(0, ("native", threads))
    reads = {}
    for route, n in routes:
        times = []
        for k in range(sweep_batches):
            chunk = [int(x) for x in keys[k * batch:(k + 1) * batch]]
            t0 = time.perf_counter()
            recs = r.read_batch(chunk, nthreads=n)
            times.append(time.perf_counter() - t0)
            check(len(recs) == batch and all(recs), "read_batch failed")
        nbytes = sum(len(x) for x in recs)
        med = float(np.median(times))
        reads[route] = {"threads": n, "ms_per_batch": 1e3 * med,
                        "MB_per_s": nbytes / med / 1e6,
                        "records_per_s": batch / med}
    r.close()
    out["record_read"] = reads
    shape = (batch, 3, image, image)
    pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
    rates = {}
    for n in sweep:
        it = host_image_iter(rec, batch, image, n)
        it.next_np(out=pinned.numpy())         # warm: pools, page cache
        t0 = time.perf_counter()
        for _ in range(sweep_batches):
            it.next_np(out=pinned.numpy())
        dt = time.perf_counter() - t0
        it.close()
        rates[str(n)] = {"img_per_s": batch * sweep_batches / dt,
                         "ms_per_batch": 1e3 * dt / sweep_batches}
    out["next_np_by_threads"] = rates
    if not cuda:
        return out
    dev = torch.empty(shape, dtype=torch.uint8, device="cuda")
    nbytes = dev.numel()
    for _ in range(3):
        dev.copy_(pinned, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    copies = 20
    start.record()
    for _ in range(copies):
        dev.copy_(pinned, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    copy_ms = start.elapsed_time(end) / copies
    out["pinned_copy"] = {"bytes": nbytes, "ms": copy_ms,
                          "GB_per_s": nbytes / copy_ms / 1e6}
    tf = DeviceTransform(dtype="bfloat16", mean=INPUT_MEAN, std=INPUT_STD)
    tf_ms = time_ms(lambda: tf(dev).permute(0, 2, 3, 1).contiguous(),
                    iters=20)
    # uint8 read once, the bf16 NHWC batch written once
    tf_bytes = nbytes + 2 * nbytes
    out["transform_and_nhwc"] = {"ms": tf_ms, "bytes": tf_bytes,
                                 "bound_ms": 1e3 * tf_bytes / HBM_BYTES_PER_S,
                                 "bound_by": "bytes"}
    del dev, pinned
    return out


def landed_batch_check(rec, batch, image, threads, ctx, seed=3):
    """One batch of ``ImageRecordIter(ctx=...)`` against the host batch
    the same seed gives a plain ``ImageIter``: the landed uint8 bytes
    equal, and the landed bf16 batch within 1 bf16 ulp of
    ``DeviceTransform``'s plain CPU result on the host batch."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.dataio import DeviceTransform
    np.random.seed(seed)
    it = host_image_iter(rec, batch, image, 0)
    host, labels, _pad = it.next_np()
    it.close()
    np.random.seed(seed)
    feed = mx.io.ImageRecordIter(path_imgrec=rec, ctx=ctx, dtype="bfloat16",
                                 **input_iter_kw(batch, image, threads))
    b = next(feed)
    feed.close()
    want = DeviceTransform(dtype="bfloat16", mean=INPUT_MEAN,
                           std=INPUT_STD)(torch.from_numpy(host))
    got = b.data._data.cpu()
    check(b.data._data.device == feed.device
          and b.data._data.dtype == torch.bfloat16,
          "landed batch on %s as %s" % (b.data._data.device,
                                        b.data._data.dtype))

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    ulps = int((ordered(got) - ordered(want)).abs().max())
    raw_equal = torch.equal(b.raw[0].cpu(), torch.from_numpy(host))
    labels_equal = torch.equal(b.label._data.cpu(), torch.from_numpy(labels))
    out = {"raw_equal": raw_equal, "labels_equal": labels_equal,
           "max_bf16_ulps": ulps}
    check(raw_equal and labels_equal and ulps <= 1,
          "landed batch differs from its host batch: %s" % out)
    return out


def jpeg_path(root, step, batch, image, records, sweep, ctx,
              source=INPUT_SOURCE):
    """JPEG records (``source``-square, quality 90) read through the same
    iterator with ``rand_crop=True``: host img/s at each thread count of
    ``sweep``, then one streamed pass of ``steps`` steps into ``step``."""
    import torch
    import mxnet_tpu_torch as mx
    cuda = ctx.device_type == "gpu"
    t0 = time.perf_counter()
    rec = make_records(os.path.join(root, "jpg"), records, fmt="jpg",
                       hw=source)
    out = {"records": records, "write_s": time.perf_counter() - t0,
           "file_bytes": os.path.getsize(rec)}
    rates = {}
    timed = min(INPUT_SWEEP_BATCHES, records // batch) - 1
    for n in sweep:
        it = host_image_iter(rec, batch, image, n, rand_crop=True)
        it.next_np()                           # warm: pools, page cache
        t0 = time.perf_counter()
        for _ in range(timed):
            it.next_np()
        dt = time.perf_counter() - t0
        it.close()
        rates[str(n)] = batch * timed / dt
    out["host_img_per_s_by_threads"] = rates
    t0 = time.perf_counter()
    feed = mx.io.ImageRecordIter(path_imgrec=rec, ctx=ctx, dtype="bfloat16",
                                 **input_iter_kw(batch, image, INPUT_THREADS,
                                                 rand_crop=True))
    losses, secs, n = streamed_epochs(feed, step, 1, INPUT_IN_FLIGHT, cuda,
                                      t0)
    feed.close()
    losses = torch.stack(losses).float().cpu().tolist()
    check(n == [records // batch] and all(np.isfinite(losses)),
          "JPEG pass: %s steps, losses %s" % (n, losses))
    out.update({"steps": n[0], "img_per_s": batch * n[0] / secs[0],
                "overlap_share": feed.overlap_frac(), "feed": feed.stats(),
                "losses": losses})
    return out


def imagenet_input_phase(make_net=resnet50_nhwc, records=INPUT_RECORDS,
                         batch=INPUT_BATCH, image=INPUT_IMAGE,
                         epochs=INPUT_EPOCHS, threads=INPUT_THREADS,
                         sweep=INPUT_THREAD_SWEEP,
                         sweep_batches=INPUT_SWEEP_BATCHES,
                         jpeg_records=JPEG_RECORDS,
                         jpeg_sweep=JPEG_THREAD_SWEEP, source=INPUT_SOURCE,
                         sites=BN_RELU_SITES, ctx=None, root=INPUT_ROOT):
    """ResNet-50 v1 NHWC under bf16 AMP with bucketed LARS trained from
    a ``.rec``: ``records`` raw records written by the port's
    ``recordio`` into a temporary directory (removed at the end), read
    by ``mx.io.ImageRecordIter(ctx=...)`` (a ``DeviceFeed`` over an
    ``ImageIter``) and fed to a captured ``TrainStep`` as ``step(batch)``
    after an NHWC transpose on the card.  The step is warmed and
    captured on a zero batch first; the launch counters are zeroed just
    before the timed window of ``epochs`` streamed epochs and read just
    after.  Its peak memory is what the window allocated beyond what the
    step held before it (the graph's pool not among it), beside the
    allocator's peak reservation, the pool's included.  Then the card's
    idle share over a profiled stretch, the loader's parts, a landed
    batch against its host batch, and the JPEG path where a codec
    imports.  With ``sites=0`` the launch checks are
    skipped (the CPU rehearsal)."""
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native, amp
    from mxnet_tpu_torch.kernels import registry
    ctx = mx.gpu(0) if ctx is None else ctx
    cuda = ctx.device_type == "gpu"
    device = ctx.torch_device()
    codecs = codec_versions()
    native = _native.load() is not None
    route = "native" if native and threads > 1 \
        and (os.cpu_count() or 1) > 1 else "python"
    print("ImageNet input codecs and recordio route: %s" % json.dumps(
        {"codecs": codecs, "recordio_route": route,
         "native_library": str(_native.so_path()) if native else None,
         "cpu_count": os.cpu_count()}))
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="imagenet-input-", dir=root)
    try:
        t0 = time.perf_counter()
        rec = make_records(os.path.join(tmp, "raw"), records, crop=image,
                           hw=source)
        write_s = time.perf_counter() - t0
        net = make_net()
        net.initialize(device=device,
                       generator=torch.Generator().manual_seed(0))
        step = make_lars_step(net)
        n_class = net.output._units
        zero_x = torch.zeros((batch, image, image, 3), dtype=torch.bfloat16,
                             device=device)
        zero_y = torch.zeros((batch,), device=device)
        t0 = time.perf_counter()
        with amp.scope("bfloat16"):
            for _ in range(WARM_STEPS):         # eager, then captured
                step(zero_x, zero_y)
            if cuda:
                torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            gen = torch.Generator(device=device).manual_seed(0)
            sx = torch.randn((batch, image, image, 3), generator=gen,
                             device=device).to(torch.bfloat16)
            sy = torch.randint(0, n_class, (batch,), generator=gen,
                               device=device).float()
            step(sx, sy)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INPUT_SYNTH_STEPS):
                step(sx, sy)
            if cuda:
                torch.cuda.synchronize()
            synth_s = time.perf_counter() - t0
        del zero_x, zero_y, sx, sy
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        np.random.seed(0)
        registry.reset_launches()
        t_start = time.perf_counter()
        feed = mx.io.ImageRecordIter(path_imgrec=rec, ctx=ctx,
                                     dtype="bfloat16",
                                     **input_iter_kw(batch, image, threads))
        losses, epochs_s, steps = streamed_epochs(feed, step, epochs,
                                                  INPUT_IN_FLIGHT, cuda,
                                                  t_start)
        wall = time.perf_counter() - t_start
        counts = {name: registry.launches(name)
                  for name in ("bn_relu_apply", "bn_relu_bwd", "lars_flat")}
        dtypes = {name: registry.launch_dtypes(name) for name in counts}
        feed_stats = feed.stats()
        overlap = feed.overlap_frac()
        peak = torch.cuda.max_memory_allocated() if cuda else None
        reserved = torch.cuda.max_memory_reserved() if cuda else None
        losses = torch.stack(losses).float().cpu().tolist()
        n_steps = sum(steps)
        per_epoch = records // batch
        check(steps == [per_epoch] * epochs,
              "streamed %s steps a epoch, want %d" % (steps, per_epoch))
        check(all(np.isfinite(losses)), "non-finite loss: %s" % losses)
        check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
        if sites:
            want = {"bn_relu_apply": sites * n_steps,
                    "bn_relu_bwd": sites * n_steps, "lars_flat": n_steps}
            for name, n in want.items():
                check(counts[name] == n, "%s launches %d != %d"
                      % (name, counts[name], n))
            for name in ("bn_relu_apply", "bn_relu_bwd"):
                check(dtypes[name] == {"bfloat16": sites * n_steps},
                      "%s ran on %s, not bf16 rows" % (name, dtypes[name]))
            check(dtypes["lars_flat"] == {"float32": n_steps},
                  "lars_flat ran on %s" % dtypes["lars_flat"])
        synth_rate = batch * INPUT_SYNTH_STEPS / synth_s
        rates = [batch * n / s for n, s in zip(steps, epochs_s)]
        stats = {"records": records, "record_bytes": os.path.getsize(rec),
                 "write_s": write_s, "batch": batch, "epochs": epochs,
                 "steps": n_steps, "preprocess_threads": threads,
                 "recordio_route": route, "warmup_s": warm_s,
                 "epoch_s": epochs_s, "epoch_img_per_s": rates,
                 "window_s": wall, "window_img_per_s": batch * n_steps / wall,
                 "synthetic_img_per_s": synth_rate,
                 "synthetic_ms_per_step": 1e3 * synth_s / INPUT_SYNTH_STEPS,
                 "epoch_rate_vs_synthetic": [r / synth_rate for r in rates],
                 "overlap_share": overlap, "feed": feed_stats,
                 "in_flight": INPUT_IN_FLIGHT, "losses": losses,
                 "launches": counts, "launch_dtypes": dtypes,
                 "peak_mem_bytes": peak, "peak_reserved_bytes": reserved,
                 "card": gpu_line() if cuda else None}
        print("ImageNet input main path (.rec -> ImageRecordIter(ctx=gpu, "
              "bf16) -> DeviceFeed -> NHWC -> captured TrainStep, ResNet-50 "
              "v1 bf16 AMP LARS; records just written): %s"
              % json.dumps(stats))
        out = {"main": stats}
        if cuda:
            out["idle"] = input_idle_share(feed, step, INPUT_PROFILED_STEPS)
            print("ImageNet input device idle share: %s"
                  % json.dumps(dict(out["idle"], card=gpu_line())))
            capture_report("ImageNet input TrainStep", step.capture_stats(),
                           {"img_per_s": stats["window_img_per_s"]},
                           out["idle"]["device_idle_share"], 1)
        feed.close()
        out["parts"] = input_parts(rec, batch, image, threads, sweep,
                                   sweep_batches, cuda)
        print("ImageNet input parts (each alone; records just "
              "written): %s" % json.dumps(dict(out["parts"], card=gpu_line()
                                             if cuda else None)))
        out["landed"] = landed_batch_check(rec, batch, image, threads, ctx)
        print("ImageNet input landed batch vs host batch: %s"
              % json.dumps(out["landed"]))
        if codecs["cv2"] or codecs["PIL"]:
            out["jpeg"] = jpeg_path(tmp, step, batch, image, jpeg_records,
                                    jpeg_sweep, ctx, source)
            print("ImageNet input JPEG (256-square, quality 90, "
                  "rand_crop): %s" % json.dumps(dict(
                      out["jpeg"], card=gpu_line() if cuda else None)))
        else:
            out["jpeg"] = None
            print("ImageNet input JPEG: neither cv2 nor PIL imports; the "
                  "JPEG path did not run (the raw path above did)")
        del step, net
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mnist_feed_path(host_stats=None, ctx=None):
    """The MNIST loop of ``mnist_main_path`` through the DataLoader's
    device-feed route: ``DataLoader(..., ctx=mx.gpu(0))`` lands each
    batch on the card (no ``as_in_context`` copy left in the loop), one
    epoch of a fresh net, unhybridized.  Prints samples/s and the feed's
    overlap share beside the host route's epoch from ``host_stats``, and
    the loader's own pace over one more epoch with no training."""
    import mxnet_tpu_torch as mx
    ctx = mx.gpu(0) if ctx is None else ctx
    np.random.seed(0)
    ds = mx.gluon.data.vision.MNIST(root=MNIST_ROOT, train=True)
    loader = mx.gluon.data.DataLoader(
        ds.transform_first(lambda d: mx.nd.array(
            d.asnumpy().reshape(1, 28, 28) / 255.0, ctx=mx.cpu())),
        batch_size=MNIST_BATCH, shuffle=True, last_batch="discard", ctx=ctx)
    net, trainer, loss_fn = mnist_setup(ctx)
    losses, step_s, wait_s, split, metric, wall = mnist_loop(
        net, trainer, loss_fn, loader, ctx)
    n = len(losses)
    check(n == 60000 // MNIST_BATCH and all(np.isfinite(losses)),
          "MNIST feed route: %d batches, losses %s" % (n, losses[-3:]))
    feed = loader._feed
    # the loader alone, no training: the producer's own pace
    t0 = time.perf_counter()
    alone = 0
    for data, _label in loader:
        alone += 1
    alone_s = time.perf_counter() - t0
    check(data._data.device == ctx.torch_device(),
          "MNIST feed route landed on %s" % data._data.device)
    stats = {"batches": n, "samples_per_s": n * MNIST_BATCH / wall,
             "ms_per_batch": 1e3 * wall / n,
             "loader_wait_share": wait_s / wall,
             "overlap_share": feed.overlap_frac(), "feed": feed.stats(),
             "producer_busy_ms_per_batch": 1e3 * feed.stats()[
                 "producer_busy"] / n,
             "loader_alone": {
                 "samples_per_s": alone * MNIST_BATCH / alone_s,
                 "producer_busy_ms_per_batch": 1e3 * loader._feed.stats()[
                     "producer_busy"] / alone},
             "accuracy": metric.get()[1],
             "host_route_samples_per_s": None if host_stats is None
             else host_stats["samples_per_s"],
             "host_route_loader_wait_share": None if host_stats is None
             else host_stats["loader_wait_share"],
             "card": gpu_line() if ctx.device_type == "gpu" else None}
    print("MNIST through DataLoader(ctx=gpu) (the device-feed route, batch "
          "128, SGD 0.05/0.9): %s" % json.dumps(stats))
    return stats


# ---------------------------------------------------------------------
# phase 16: the always-on train -> serve loop
# ---------------------------------------------------------------------

HOTSWAP_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "hotswap-smoke")
HOTSWAP_BATCH = 32
HOTSWAP_PUBLISH_EVERY = 8
HOTSWAP_STEPS = 40                 # the trainer thread's steps while serving
HOTSWAP_MIN_SWAPS = 3
HOTSWAP_POLL_S = 0.2
HOTSWAP_IMAGES = 32                # distinct request images, from seed 0
HOTSWAP_INTERVAL_S = 0.02          # each open-loop client's send interval
HOTSWAP_WAIT_S = 120.0             # a swap, a drain or a client past this hung


def _open_loop_client(reg, name, images, records, rejects, lock, stop,
                      seed, interval=HOTSWAP_INTERVAL_S):
    """One open-loop client: a single image every ``interval`` seconds,
    whatever the answers do; each accepted request is kept as
    ``[image index, submit time, done time, future]``."""
    from mxnet_tpu_torch.serving import ServingQueueFull
    rng = np.random.RandomState(seed)
    mine = []
    next_t = time.perf_counter()
    while not stop.is_set():
        i = int(rng.randint(len(images)))
        t0 = time.perf_counter()
        try:
            fut = reg.submit(name, images[i], timeout=HOTSWAP_WAIT_S)
        except ServingQueueFull:
            with lock:
                rejects["shed"] += 1
        except Exception as e:     # noqa: BLE001 -- counted as an error
            with lock:
                rejects["errors"].append(repr(e))
        else:
            rec = [i, t0, None, fut]
            fut.add_done_callback(
                lambda _f, rec=rec: rec.__setitem__(2, time.perf_counter()))
            mine.append(rec)
        next_t += interval
        stop.wait(max(0.0, next_t - time.perf_counter()))
    with lock:
        records.append(mine)


def _pct(values, q):
    values = sorted(values)
    return 1e3 * values[min(len(values) - 1, int(q * len(values)))] \
        if values else None


def hotswap_phase(make_net=resnet50_nhwc, image=224, batch=HOTSWAP_BATCH,
                  buckets=SERVE_BUCKETS, clients=SERVE_CLIENTS,
                  publish_every=HOTSWAP_PUBLISH_EVERY, steps=HOTSWAP_STEPS,
                  sites=BN_RELU_SITES, device="cuda", root=HOTSWAP_ROOT):
    """ROADMAP item 7 on the card: ``ContinuousTrainer`` trains
    ``make_net()`` (fp32, SGD momentum, a fixed synthetic batch) on its
    own thread and publishes every ``publish_every`` steps, while a
    ``RegistryWatcher`` (``poll_s`` 0.2) hot-swaps a second instance,
    served at ``buckets``, to each new verified step and ``clients``
    open-loop threads send single images.  The first swap of the window
    dies at the ``serving.swap`` fail point and retries; after the
    trainer's steps the next publish is torn after its commit
    (``chaos.truncate``) and must be quarantined while the previous step
    keeps serving.  Checks: nothing dropped, shed, timed out or failed;
    at least ``HOTSWAP_MIN_SWAPS`` swaps, the served step strictly
    increasing; each answer the batch-1 forward of one published step
    within SERVE_REL_TOL, and never an older step than the client's
    previous answer; the fused kernels' launches the sum of their
    sources' counts; telemetry equal to the phase's own counts."""
    import torch
    from mxnet_tpu_torch import chaos, gluon, obs, telemetry
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.chaos.scenarios import corrupt_dirs
    from mxnet_tpu_torch.obs import goodput
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import (ContinuousTrainer, ModelRegistry,
                                         RegistryWatcher)
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    telemetry.enable()
    chaos.reset()
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, image, image, 3), generator=gen, device=device)
    y = torch.randint(0, net.output._units, (batch,), generator=gen,
                      device=device).float()
    ct = ContinuousTrainer(net, trainer,
                           gluon.loss.SoftmaxCrossEntropyLoss(),
                           (NDArray(x), NDArray(y)), root,
                           publish_every=publish_every)
    publishes = []              # (step, seconds, done time)
    publish = ct.publish

    def timed_publish():
        t0 = time.perf_counter()
        step = publish()
        publishes.append((step, time.perf_counter() - t0,
                          time.perf_counter()))
        return step

    ct.publish = timed_publish
    served_net = make_net()
    served_net.initialize(device=device)
    reg = ModelRegistry(compile_cache=False)
    installed = []              # every servable the window installs
    install = reg._install

    def recording_install(name, servable):
        installed.append(servable)
        return install(name, servable)

    reg._install = recording_install
    w = RegistryWatcher(reg, "resnet50", ct.manager, served_net,
                        input_shape=(image, image, 3), buckets=buckets,
                        max_queue=1 << 16, poll_s=HOTSWAP_POLL_S)
    swaps = []                  # (start, end, step, served or None)
    swap = w._swap

    def timed_swap(step):
        t0 = time.perf_counter()
        got = swap(step)
        swaps.append((t0, time.perf_counter(), step, got))
        return got

    w._swap = timed_swap

    # alone: two publish cycles (the first warms cuDNN), then the first
    # servable, registered before anything else runs (its warm-up peaks
    # are hbm_plan's line)
    ct.run_steps(publish_every)
    t1 = time.perf_counter()
    ct.run_steps(publish_every)
    alone_ms = 1e3 * (time.perf_counter() - t1 - publishes[-1][1]) \
        / publish_every
    first = w.poll_once()
    check(first == 2 * publish_every, "the first poll served %r" % first)
    pool = reg.servable("resnet50")._pool
    plan = pool.hbm_plan(torch.cuda.mem_get_info()[1]) if cuda else None
    peaks = pool.warmup_peaks()

    rng = np.random.RandomState(0)
    images = rng.standard_normal(
        (HOTSWAP_IMAGES, image, image, 3)).astype(np.float32)
    records, rejects = [], {"shed": 0, "errors": []}
    lock, stop = threading.Lock(), threading.Event()
    threads = [threading.Thread(
        target=_open_loop_client,
        args=(reg, "resnet50", images, records, rejects, lock, stop,
              100 + c))
        for c in range(clients)]
    first_step = ct.step
    n_publish0, n_swap0 = len(publishes), len(swaps)
    installed[:] = [reg.servable("resnet50")]
    registry.reset_launches()
    telemetry.reset()
    # the trainer's goodput ledger (a window per publish cycle) and the
    # trace spans, on for the window: where a step goes beside serving
    obs.enable_tracing()
    obs.enable_goodput()
    goodput.reset()
    ledger = goodput.ledger(window_steps=publish_every)
    with chaos.scenario(seed=0):
        chaos.on("serving.swap", nth=1)      # the window's first swap
        t_window = time.perf_counter()
        w.start()
        for t in threads:
            t.start()
        try:
            ct.start(max_steps=steps)
            ct._thread.join(HOTSWAP_WAIT_S * 2)
            check(not ct._thread.is_alive(), "the trainer thread hung")
            t_trained = time.perf_counter()
            last = ct.published_step
            deadline = time.perf_counter() + HOTSWAP_WAIT_S
            while w.served_step != last and time.perf_counter() < deadline:
                stop.wait(0.05)
            check(w.served_step == last, "the watcher serves step %r, "
                  "not the last published %r" % (w.served_step, last))
            # tear the next publish after its commit: the watcher must
            # quarantine it and keep serving `last`
            chaos.on("checkpoint.commit.post_commit", times=1,
                     action=chaos.truncate("params.params"))
            ct.run_steps(publish_every)
            torn = ct.published_step
            deadline = time.perf_counter() + HOTSWAP_WAIT_S
            want = "step_%08d.corrupt" % torn
            while want not in corrupt_dirs(root) \
                    and time.perf_counter() < deadline:
                stop.wait(0.05)
            stop.wait(3 * HOTSWAP_POLL_S)
            quarantined = corrupt_dirs(root)
            served_after_tear = w.served_step
        finally:
            stop.set()
            for t in threads:
                t.join(HOTSWAP_WAIT_S)
            w.close()
            ct.close()
            obs.disable_goodput()
            obs.disable_tracing()
        check(not any(t.is_alive() for t in threads), "a client hung")
        t_end = time.perf_counter()
        chaos_stats = chaos.stats()
    trainer_goodput = hotswap_goodput(ledger.windows(), obs.spans())
    goodput.reset()
    # every accepted request answered (a future still pending is dropped)
    from mxnet_tpu_torch.serving import RequestTimeout
    flat = [r for mine in records for r in mine]
    dropped = timeouts = 0
    errors = list(rejects["errors"])
    for _i, _t0, _done, fut in flat:
        try:
            fut.result(timeout=HOTSWAP_WAIT_S)
        except TimeoutError:
            dropped += 1
        except RequestTimeout:
            timeouts += 1
        except Exception as e:      # noqa: BLE001 -- checked below
            errors.append(repr(e))
    window_wall = t_end - t_window
    reg.shutdown(drain=True)
    train_steps = ct.step - first_step
    calls = sum(s.stats().get("batches", 0) for s in installed)
    fwd = registry.launches("bn_relu_apply")
    bwd = registry.launches("bn_relu_bwd")
    snap = {r["name"]: r for r in telemetry.snapshot()}
    telemetry.disable()

    def tval(name, key="value"):
        rec = snap.get(name)
        return rec[key] if rec is not None else 0

    warm_registrations = tval("serving.warmup_time", "count")
    warm_runs = warm_registrations * len(buckets) * (2 if cuda else 1)
    ok_swaps = [s for s in swaps[n_swap0:] if s[3] is not None]
    served_steps = [first] + [s[3] for s in ok_swaps]
    window_publishes = publishes[n_publish0:]

    # the published steps' own batch-1 forwards, restored after the run
    ref = make_net()
    ref.initialize(device=device)
    mgr = CheckpointManager(root)
    refs = {}
    with torch.inference_mode(), autograd.pause():
        for step in served_steps:
            mgr.restore_training(ref, step=step)
            refs[step] = np.stack([
                ref(torch.from_numpy(img[None]).to(device))[0].cpu().numpy()
                for img in images])
    worst, runner_up, backwards = 0.0, np.inf, 0
    matched = {}
    for mine in records:
        prev = None
        for i, t0, _done, fut in mine:
            got = fut.result(timeout=0) if fut.done() and \
                fut.exception() is None else None
            if got is None:
                continue
            errs = {s: float(np.abs(got - r[i]).max() / np.abs(r[i]).max())
                    for s, r in refs.items()}
            best = min(errs, key=errs.get)
            worst = max(worst, errs[best])
            others = [e for s, e in errs.items() if s != best]
            if others:
                runner_up = min(runner_up, min(others))
            matched[best] = matched.get(best, 0) + 1
            if prev is not None and best < prev:
                backwards += 1
            prev = best
    shutil.rmtree(root, ignore_errors=True)

    lat = [(t0, done - t0) for _i, t0, done, fut in flat
           if done is not None and fut.exception() is None]
    # a swap's wall: from its step's publish committing to the step
    # serving
    visible = {p[0]: p[2] for p in publishes}
    swap_walls = [s[1] - visible[s[3]] for s in ok_swaps]
    # the bench's split: a request whose round trip overlaps a swap
    # attempt ran during the swap
    window_swaps = swaps[n_swap0:]
    during = [l for t0, l in lat
              if any(t0 <= s[1] and t0 + l >= s[0] for s in window_swaps)]
    steady = [l for t0, l in lat
              if not any(t0 <= s[1] and t0 + l >= s[0]
                         for s in window_swaps)]
    cycles = [b[2] - a[2] - b[1] for a, b in zip(window_publishes,
                                                 window_publishes[1:])]
    out = {
        "train_batch": batch, "publish_every": publish_every,
        "trainer_steps": train_steps,
        "publishes": len(window_publishes),
        "swaps": len(ok_swaps), "swaps_tried": len(swaps) - n_swap0,
        "swap_failures": tval("serving.swap_failures"),
        "served_steps": served_steps,
        "swap_wall_p50_ms": _pct(swap_walls, 0.5),
        "swap_wall_max_ms": 1e3 * max(swap_walls) if swap_walls else None,
        "requests": len(flat), "responses": len(lat),
        "requests_per_s": len(lat) / window_wall,
        "latency_p50_steady_ms": _pct(steady, 0.5),
        "latency_p99_steady_ms": _pct(steady, 0.99),
        "latency_p50_during_swap_ms": _pct(during, 0.5),
        "latency_p99_during_swap_ms": _pct(during, 0.99),
        "requests_during_swap": len(during),
        "trainer_ms_per_step_alone": alone_ms,
        "trainer_ms_per_step_serving":
            1e3 * float(np.median(cycles)) / publish_every
            if cycles else None,
        "dropped": dropped, "shed": rejects["shed"], "timeouts": timeouts,
        "errors": len(errors),
        "answers_per_step": {str(k): v for k, v in sorted(matched.items())},
        "max_rel_err": worst, "nearest_other_step_rel_err": runner_up,
        "rel_tol": SERVE_REL_TOL, "backwards_answers": backwards,
        "torn_step": torn, "quarantined": quarantined,
        "served_after_tear": served_after_tear,
        "chaos": chaos_stats,
        "executor_calls": calls, "warmup_registrations": warm_registrations,
        "bn_relu_apply_launches": fwd, "bn_relu_bwd_launches": bwd,
        "hbm_plan_bucket_%d_bytes" % buckets[-1]:
            plan["buckets"][-1]["predicted_peak_hbm_bytes"] if plan else None,
        "measured_warmup_peak_bucket_%d_bytes" % buckets[-1]:
            peaks.get(buckets[-1]),
        "warmup_peaks_bytes": {str(b): v for b, v in peaks.items()},
        "peak_mem_bytes_since_last_warmup":
            torch.cuda.max_memory_allocated() if cuda else None,
        "window_s": window_wall, "trained_s": t_trained - t_window,
        "phase_s": time.perf_counter() - t_phase,
        "card": gpu_line() if cuda else None}
    print("hot-swap loop (ResNet-50 v1 NHWC fp32 trained and served): %s"
          % json.dumps(out))
    print("hot-swap trainer goodput beside serving (ledger window = one "
          "publish cycle of %d steps; spans): %s"
          % (publish_every, json.dumps(trainer_goodput)))
    out["trainer_goodput"] = trainer_goodput
    check(not errors, "request errors: %s" % errors[:3])
    check(dropped == rejects["shed"] == timeouts == 0,
          "dropped %d, shed %d, timed out %d"
          % (dropped, rejects["shed"], timeouts))
    check(len(ok_swaps) >= HOTSWAP_MIN_SWAPS, "%d swaps in the window, "
          "want >= %d" % (len(ok_swaps), HOTSWAP_MIN_SWAPS))
    check(served_steps == sorted(set(served_steps)),
          "served steps not strictly increasing: %s" % served_steps)
    check(worst <= SERVE_REL_TOL, "an answer is %.3g from every published "
          "step's batch-1 forward (tolerance %g)" % (worst, SERVE_REL_TOL))
    check(backwards == 0, "%d answers went back to an older step than the "
          "client's previous one" % backwards)
    check(chaos_stats["injected"].get("serving.swap") == 1
          and chaos_stats["survived"].get("serving.swap") == 1,
          "the injected swap fault was not retried: %s" % chaos_stats)
    check(quarantined == ["step_%08d.corrupt" % torn],
          "quarantined %s, want step %d" % (quarantined, torn))
    check(served_after_tear == last, "serving step %r after the tear, "
          "want %r" % (served_after_tear, last))
    check(tval("trainer.steps") == train_steps, "trainer.steps %r != %d"
          % (tval("trainer.steps"), train_steps))
    check(tval("serving.batches") == calls, "serving.batches %r != %d "
          "executor calls" % (tval("serving.batches"), calls))
    attempts = len(ok_swaps) + tval("serving.swap_failures")
    check(warm_registrations == attempts, "%d warm-ups for %d swap "
          "attempts" % (warm_registrations, attempts))
    if sites:
        check(fwd == sites * (train_steps + calls + warm_runs),
              "bn_relu_apply launches %d != %d sites x (%d trainer steps + "
              "%d executor calls + %d warm-up runs)"
              % (fwd, sites, train_steps, calls, warm_runs))
        check(bwd == sites * train_steps, "bn_relu_bwd launches %d != %d "
              "sites x %d trainer steps" % (bwd, sites, train_steps))
    check(tval("serving.requests") == len(flat), "serving.requests %r != "
          "%d accepted" % (tval("serving.requests"), len(flat)))
    check(tval("serving.latency", "count") == len(lat),
          "serving.latency count %r != %d responses"
          % (tval("serving.latency", "count"), len(lat)))
    check(tval("serving.swaps") == len(ok_swaps), "serving.swaps %r != %d"
          % (tval("serving.swaps"), len(ok_swaps)))
    check(tval("train_loop.publishes") == len(window_publishes),
          "train_loop.publishes %r != %d"
          % (tval("train_loop.publishes"), len(window_publishes)))
    out["launches"] = {
        "bn_relu_apply": {"trainer": sites * train_steps,
                          "servables": sites * calls,
                          "warmups": sites * warm_runs, "total": fwd},
        "bn_relu_bwd": {"trainer": sites * train_steps, "total": bwd}}
    return out


def hotswap_goodput(windows, spans):
    """The trainer's time beside serving, from its goodput windows
    (steps > 0): seconds a step by category, their shares of the
    windows' wall, the verdicts and reconciliation errors; and the mean
    ``train.step`` / ``train.publish`` span walls."""
    from mxnet_tpu_torch.obs import goodput
    active = [w for w in windows if w["steps"]]
    steps = sum(w["steps"] for w in active)
    wall = sum(w["wall_s"] for w in active)
    secs = {c: sum(w["categories"][c]["seconds"] for w in active)
            for c in goodput.CATEGORIES}

    def mean_ms(name):
        durs = [sp["dur"] for sp in spans if sp.get("name") == name]
        return 1e3 * float(np.mean(durs)) if durs else None

    return {"windows": len(active), "steps": steps, "wall_s": wall,
            "ms_per_step": {c: 1e3 * v / steps if steps else None
                            for c, v in secs.items()},
            "shares": {c: v / wall if wall else None
                       for c, v in secs.items()},
            "verdicts": [w["verdict"]["detail"] for w in active],
            "reconciliation_errors": [w["reconciliation"]["error"]
                                      for w in active],
            "train_step_span_ms": mean_ms("train.step"),
            "train_publish_span_ms": mean_ms("train.publish")}


def generative_swap_phase(widths=GPT2_SMALL, max_new=DECODE_MAX_NEW,
                          device="cuda", root=HOTSWAP_ROOT):
    """A ``GenerativeWatcher`` serves ``tiny_gpt(**widths)`` from a
    checkpoint's ``params`` item; eight streams are admitted on step 1,
    each old decode step is held at the ``serving.decode.step`` fail
    point until the replacement installs, step 2 (other weights) is
    published and swapped in, and eight more streams are admitted on
    it.  Every stream must finish its ``max_new`` tokens and equal the
    greedy oracle of the weights it was admitted under; the old engine
    ends with no live sequence; ``paged_attention`` launches once per
    layer per decode step of both engines (the new one's warm-up
    included)."""
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import GenerativeWatcher, ModelRegistry
    from mxnet_tpu_torch.serving.decode import tiny_gpt
    t_phase = time.perf_counter()
    root = os.path.join(root, "gpt2")
    shutil.rmtree(root, ignore_errors=True)
    model = tiny_gpt(**widths)
    params = {1: model.init_params(seed=0, device=device),
              2: model.init_params(seed=1, device=device)}
    mgr = CheckpointManager(root)
    mgr.save(1, {"params": params[1]})
    reg = ModelRegistry()
    w = GenerativeWatcher(reg, "gpt2", mgr, model, device=device)
    check(w.poll_once() == 1, "the generative watcher served no step 1")
    old = reg.servable("gpt2")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.vocab_size, n).tolist()
               for n in DECODE_PROMPT_LENGTHS]
    registry.reset_launches()
    steps_old0 = old.engine.decode_steps
    chaos.reset()
    submitted = threading.Event()
    with chaos.scenario(seed=0):
        deadline = time.perf_counter() + HOTSWAP_WAIT_S

        def hold_until_swapped(ctx):
            # once every stream is admitted, each old decode step waits
            # for the replacement to install: the swap lands mid-decode
            if not submitted.is_set() or old.engine.queue_depth():
                return
            while reg._servables.get("gpt2") is old \
                    and time.perf_counter() < deadline:
                time.sleep(0.002)

        chaos.on("serving.decode.step", action=hold_until_swapped)
        first = [reg.generate("gpt2", p, max_new) for p in prompts]
        submitted.set()
        heads = [next(s) for s in first]      # from prefill
        live_before = old.engine.live_sequences()
        mgr.save(2, {"params": params[2]})
        t0 = time.perf_counter()
        check(w.poll_once() == 2, "the generative watcher did not swap")
        swap_s = time.perf_counter() - t0
        new = reg.servable("gpt2")
        second = [reg.generate("gpt2", p, max_new) for p in prompts]
        toks_first = [[h] + s.tokens() for h, s in zip(heads, first)]
        toks_second = [s.tokens() for s in second]
        check(all(s.finish_reason == "length" for s in first + second),
              "a stream ended early: %s" % [s.finish_reason
                                            for s in first + second])
        stats = chaos.stats()
    live_after = old.engine.live_sequences()
    active_after = old.engine.active_sequences()
    steps_old = old.engine.decode_steps - steps_old0
    steps_new = new.engine.decode_steps
    reg.shutdown(drain=True)
    w.close()
    launches = registry.launches("paged_attention")
    ties = 0
    for streams, p in ((toks_first, params[1]), (toks_second, params[2])):
        for prompt, toks in zip(prompts, streams):
            check(len(toks) == max_new, "a stream ended after %d tokens"
                  % len(toks))
            ties += oracle_check(model, p, prompt, toks,
                                 model.reference_decode(p, prompt, max_new))
    shutil.rmtree(root, ignore_errors=True)
    out = {"streams_old": len(first), "streams_new": len(second),
           "max_new": max_new, "live_at_swap": live_before,
           "swap_s": swap_s, "old_engine_decode_steps": steps_old,
           "new_engine_decode_steps_with_warmup": steps_new,
           "paged_attention_launches": launches, "near_ties": ties,
           "old_live_after_drain": live_after,
           "old_active_after_drain": active_after,
           "decode_swap_survived": stats["survived"].get(
               "serving.decode_swap"),
           "streams_differ_between_steps": toks_first != toks_second,
           "phase_s": time.perf_counter() - t_phase,
           "card": gpu_line() if device == "cuda" else None}
    print("generative swap (GPT-2 small widths, mid-decode): %s"
          % json.dumps(out))
    check(live_before == len(prompts), "%d live sequences at the swap, "
          "want %d" % (live_before, len(prompts)))
    check(toks_first != toks_second, "the two steps' weights decode the "
          "same streams")
    check(live_after == active_after == 0, "the old engine kept %d live "
          "(%d active) after its drain" % (live_after, active_after))
    check(stats["survived"].get("serving.decode_swap") == 1,
          "no drained mid-decode swap recorded: %s" % stats)
    check(launches == model.num_layers * (steps_old + steps_new),
          "paged_attention launches %d != %d layers x (%d old + %d new "
          "decode steps)" % (launches, model.num_layers, steps_old,
                             steps_new))
    out["launches"] = {"paged_attention": {
        "old_engine": model.num_layers * steps_old,
        "new_engine": model.num_layers * steps_new, "total": launches}}
    return out


# ---------------------------------------------------------------------
# phase 17: the single-process ops plane over ResNet-50 training
# ---------------------------------------------------------------------

OPS_BATCH = LARS_BATCH             # phase (a): config 5's batch
OPS_STEPS = 5                      # replays timed after the warm-ups
OPS_PROFILER_REPLAYS = 3           # counted, after one lead-in replay
OPS_CONV_TOL = 0.02                # conv_dot flops vs the layer count
OPS_TRAIN_STEPS = 60               # phase (c): the observed trainer
OPS_PUBLISH_EVERY = 20
OPS_WINDOW = 10                    # goodput / leak-sentinel window
OPS_LEAK_FROM = 30                 # memory.leak pins from this step
OPS_LEAK_BYTES = 64 << 20
OPS_LEAK_WITHIN = 3                # windows from the onset to the flag
OPS_WORKER_STEPS = 24              # phase (d): the supervised worker
OPS_WORKER_PUBLISH = 8
OPS_KILL_STEP = 13                 # chaos.KILL in generation 0
OPS_HTTP_TIMEOUT_S = 10
OPS_SUPERVISOR_TIMEOUT_S = 300
# the kernels of the AMP LARS step, by their __global__ names
OPS_KERNELS = {"bn_relu_apply": "bn_relu_fwd_kernel",
               "bn_relu_bwd": "bn_relu_bwd_kernel",
               "lars_flat": "lars_flat_kernel"}


def _axis_taps(size, kernel, stride, pad, dilate):
    """(output position, kernel tap) pairs along one axis whose input
    index falls inside the unpadded input, by enumeration."""
    out = (size + 2 * pad - dilate * (kernel - 1) - 1) // stride + 1
    return sum(1 for o in range(out) for t in range(kernel)
               if 0 <= o * stride - pad + t * dilate < size)


def conv_dense_flops(net, image, batch, device="cuda"):
    """An independent count of a training step's convolution and dense
    flops from the net's layer shapes, charging only the kernel taps
    that land inside the unpadded input (XLA's count, and the
    CostReport's): for each ``Conv2D``, 2 x output channels x input
    channels a group x the in-bounds (output, tap) pairs of each
    spatial axis, enumerated; for each ``Dense``, 2 x its output
    elements x in_units; times 3 (forward, data gradient, weight
    gradient), less the stem's data gradient (the batch takes none).
    The input shapes come from one batch-1 forward."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    per = []

    def hook(block, inputs, out):
        w = block._reg_params["weight"].data()._data
        if not isinstance(block, nn.Conv2D):
            per.append(2 * out.numel() * (w.numel() // w.shape[0]))
            return
        kw = block._kwargs
        x = inputs[0]
        spatial = x.shape[1:3] if block._channels_last else x.shape[2:4]
        taps = 1
        for i, size in enumerate(spatial):
            taps *= _axis_taps(size, kw["kernel"][i], kw["stride"][i],
                               kw["pad"][i], kw["dilate"][i])
        per.append(2 * x.shape[0] * w.shape[0]
                   * (w.numel() // w.shape[0] // (kw["kernel"][0]
                                                  * kw["kernel"][1]))
                   * taps)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (nn.Conv2D, nn.Dense))]
    try:
        with autograd.pause():
            net(torch.zeros((1, image, image, 3), device=device))
    finally:
        for h in hooks:
            h.remove()
    return batch * (3 * sum(per) - per[0])


def _cli_output(main, argv):
    """``(exit code, stdout)`` of a CLI's ``main(argv)`` in this
    process."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def trace_replays_of(events):
    """The device kernel events of a Chrome trace grouped by the graph
    launch that ran them (CUPTI gives a replayed graph's kernels the
    correlation id of its launch), in launch order: for each
    ``cudaGraphLaunch``, a ``Counter`` of its kernels' names and the
    microseconds from the launch call to its first recorded kernel."""
    import collections
    launches = sorted((e["ts"], e.get("args", {}).get("correlation"))
                      for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "GraphLaunch" in e.get("name", ""))
    kernels = collections.defaultdict(collections.Counter)
    first = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_kernel"):
            corr = e.get("args", {}).get("correlation")
            kernels[corr][e.get("name", "")] += 1
            first[corr] = min(first.get(corr, e["ts"]), e["ts"])
    return [{"kernels": kernels[corr],
             "launch_to_first_kernel_us":
                 first[corr] - ts if corr in first else None}
            for ts, corr in launches]


def ops_profiled_run(report_dir, make_net=resnet50_nhwc, batch=OPS_BATCH,
                     image=224, steps=OPS_STEPS, trace_replays=0,
                     sites=BN_RELU_SITES, device="cuda"):
    """Phase 17 (a) (and (b) with ``trace_replays``): ResNet-50 v1 NHWC
    under bf16 AMP with bucketed LARS (``make_lars_step``) and
    ``mx.profiling`` on: the first call's eager warm-up is walked into
    the step's CostReport, the second captures, then ``steps`` replays
    are timed with the counters zeroed.  Checks the report's
    ``conv_dot`` flops against :func:`conv_dense_flops`, the categories
    summing to the totals, and each hand kernel in ``provenance`` with
    the warm-up's launches, equal to the registry's launches a replayed
    step.  With ``trace_replays``, ``mx.profiler`` records that many
    more replays, after one lead-in replay, and dumps its Chrome trace;
    its device events, grouped by graph launch, are searched for the
    three kernels inside the replayed graph.  The counted replays must
    agree kernel for kernel; the lead-in may only lack kernels (the
    tracer drops records it timestamps before the trace's start), and
    what each replay holds is in ``trace_replays``.  Saves the reports
    under ``report_dir``."""
    import torch
    from mxnet_tpu_torch import amp, profiler, profiling
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.profiling import roofline
    cuda = device == "cuda"
    profiling.reset()
    profiling.enable()
    try:
        net = make_net()
        net.initialize(device=device,
                       generator=torch.Generator().manual_seed(0))
        want_conv = conv_dense_flops(net, image, batch, device)
        step = make_lars_step(net)
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((batch, image, image, 3), generator=gen,
                        device=device)
        y = torch.randint(0, net.output._units, (batch,), generator=gen,
                          device=device).float()
        with amp.scope("bfloat16"):
            registry.reset_launches()
            t0 = time.perf_counter()
            step(x, y)                   # eager, walked
            warm = {n: registry.launches(n) for n in OPS_KERNELS}
            step(x, y)                   # captured
            if cuda:
                torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            registry.reset_launches()
            t0 = time.perf_counter()
            losses = [step(x, y) for _ in range(steps)]
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: registry.launches(n) for n in OPS_KERNELS}
            trace = None
            if trace_replays:
                profiler.set_config(filename=os.path.join(report_dir,
                                                          "trace.json"))
                profiler.set_state("run")
                for _ in range(1 + trace_replays):
                    step(x, y)
                if cuda:
                    torch.cuda.synchronize()
                trace = profiler.dump()
        losses = torch.stack(losses).tolist()
        label = "train_step:%s" % type(net).__name__
        reps = {r["label"]: r for r in profiling.reports()}
        check(label in reps, "no CostReport for %s: %s" % (label,
                                                          sorted(reps)))
        rep = reps[label]
        step_s = wall / steps
        rl = roofline.build(rep, step_s, items_per_step=batch)
        path = profiling.save_reports(report_dir)
        dumps = profiler.dumps() if trace_replays else None
        capture = step.capture_stats()
    finally:
        profiling.disable()
    conv = rep["categories"]["conv_dot"]["flops"]
    prov = {p["op_name"]: p for p in rep["provenance"] if p.get("kernel")}
    out = {"batch": batch, "steps": steps, "losses": losses,
           "ms_per_step": 1e3 * step_s, "img_per_s": batch / step_s,
           "warmup_s": warm_s, "report": path,
           "fingerprint": rep["fingerprint"], "device": rep["device"],
           "totals": rep["totals"],
           "categories": {c: {k: v[k] for k in ("flops", "bytes",
                                                "flops_share",
                                                "bytes_share")}
                          for c, v in rep["categories"].items()},
           "memory": rep["memory"],
           "conv_dot_flops": conv, "layer_count_flops": want_conv,
           "conv_dot_rel_err": abs(conv - want_conv) / want_conv,
           "hand_kernels": {n: {k: prov.get(n, {}).get(k)
                                for k in ("calls", "launches", "flops",
                                          "bytes")}
                            for n in OPS_KERNELS},
           "warm_launches": warm, "launches": counts,
           "roofline": {k: rl[k] for k in ("step_time_s", "peak_flops",
                                           "peak_bytes_per_s",
                                           "peaks_assumed", "mfu",
                                           "bandwidth_util",
                                           "floor_step_s",
                                           "items_per_sec")},
           "roofline_categories": rl["categories"],
           "mfu_vs_989_tflops": rep["totals"]["flops"] / step_s / 989e12,
           "graphs": capture["graphs"], "pool_bytes": capture["pool_bytes"],
           "card": gpu_line() if cuda else None}
    check(all(np.isfinite(losses)), "non-finite loss: %s" % losses)
    check(out["conv_dot_rel_err"] <= OPS_CONV_TOL,
          "conv_dot flops %d are %.4f from the layer count %d (limit %g)"
          % (conv, out["conv_dot_rel_err"], want_conv, OPS_CONV_TOL))
    check(sum(c["flops"] for c in rep["categories"].values())
          == rep["totals"]["flops"]
          and sum(c["bytes"] for c in rep["categories"].values())
          == rep["totals"]["bytes_accessed"],
          "the categories do not sum to the totals: %s" % out["categories"])
    if sites:
        for name in OPS_KERNELS:
            got = prov.get(name, {}).get("launches")
            check(got == warm[name] and counts[name] == steps * got,
                  "%s: %r launches in provenance, %d in the walked "
                  "warm-up, %d over %d replays" % (name, got, warm[name],
                                                   counts[name], steps))
    if trace is not None:
        events = json.load(open(trace))["traceEvents"]
        replays = trace_replays_of(events)
        counted = [r["kernels"] for r in replays[1:]]

        def hand(kernels):
            return {n: sum(c for k, c in kernels.items() if g in k)
                    for n, g in OPS_KERNELS.items()}
        found = {n: sum(hand(k)[n] for k in counted) for n in OPS_KERNELS}
        out["trace"] = trace
        out["trace_device_kernel_events"] = sum(
            1 for e in events if e.get("cat") in ("kernel", "gpu_kernel"))
        out["trace_per_replay"] = [
            {"lead_in": i == 0, "kernel_events": sum(r["kernels"].values()),
             "hand_kernel_events": hand(r["kernels"]),
             "launch_to_first_kernel_us": r["launch_to_first_kernel_us"]}
            for i, r in enumerate(replays)]
        out["trace_hand_kernel_events"] = found
        out["graph_kernels_in_trace"] = all(found.values())
        out["cachedop_ranges"] = sum(
            1 for e in events if e.get("name", "").startswith("mx.cachedop"))
        print("mx.profiler dumps() over %d replays:\n%s"
              % (1 + trace_replays, dumps))
        if cuda:
            check(len(replays) == 1 + trace_replays,
                  "the profiler trace holds %d graph launches, want a "
                  "lead-in and %d counted replays"
                  % (len(replays), trace_replays))
            check(out["graph_kernels_in_trace"],
                  "the profiler trace of %d replays names the hand "
                  "kernels %s: CUPTI reported no kernel of the replayed "
                  "graph" % (trace_replays, found))
            check(all(k == counted[0] for k in counted),
                  "the %d counted replays of one graph differ in their "
                  "kernel events: %s" % (trace_replays,
                                         out["trace_per_replay"][1:]))
            lead = replays[0]["kernels"]
            check(all(c <= counted[0][k] for k, c in lead.items()),
                  "the lead-in replay holds kernel events the counted "
                  "replays lack: %s" % out["trace_per_replay"])
            for name, n in found.items():
                check(n == trace_replays * prov[name]["launches"],
                      "%s: %d kernel events in the trace of %d replays, "
                      "want %d a step" % (name, n, trace_replays,
                                          prov[name]["launches"]))
    return out


def _http_get(port, path):
    import urllib.error
    import urllib.request
    url = "http://127.0.0.1:%d%s" % (port, path)
    try:
        with urllib.request.urlopen(url, timeout=OPS_HTTP_TIMEOUT_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def ops_observed_trainer(root, make_net=resnet50_nhwc, image=224,
                         batch=HOTSWAP_BATCH, steps=OPS_TRAIN_STEPS,
                         publish_every=OPS_PUBLISH_EVERY, window=OPS_WINDOW,
                         leak_from=OPS_LEAK_FROM, leak_bytes=OPS_LEAK_BYTES,
                         device="cuda"):
    """Phase 17 (c): phase 16's trainer (ResNet-50 v1 NHWC fp32, SGD
    0.05/0.9, batch 32) as a ``ContinuousTrainer`` without serving,
    ``steps`` steps publishing every ``publish_every``, observed:
    telemetry into a JSONL sink, the goodput ledger (window ``window``,
    its flops a step walked from one forward/backward by
    ``mx.profiling``), the leak sentinel, the flight recorder and the
    obs server; ``memory.leak`` armed with ``pin_action`` at
    ``leak_bytes`` a step from step ``leak_from``.  After each window
    the server is scraped.  Checks: every window reconciles; the
    sentinel flags within ``OPS_LEAK_WITHIN`` windows of the onset and
    never before it; each scrape's /healthz 200, /metrics with the
    goodput shares and live bytes, /statusz with goodput and memory
    rows; ``mxtelemetry summarize`` over the sink counts the phase's
    windows, steps and regressions."""
    import torch
    from mxnet_tpu_torch import autograd, chaos, gluon, obs, profiling
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.analysis import memory
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.obs import flight, goodput
    from mxnet_tpu_torch.serving import ContinuousTrainer
    from mxnet_tpu_torch.telemetry import cli as tcli
    cuda = device == "cuda"
    os.makedirs(root, exist_ok=True)
    jsonl = os.path.join(root, "run.jsonl")
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    sink = telemetry.attach_jsonl(jsonl)
    obs.status.reset()
    goodput.reset()
    obs.enable_goodput()
    memory.reset_watch()
    prev_watch = memory._set_watch(True)
    chaos.reset()
    port = None
    try:
        sent = memory.sentinel(window_steps=window, min_baseline=2)
        flight.install(os.path.join(root, "trainer.bbox"))
        port = obs.serve(0)
        net = make_net()
        net.initialize(device=device,
                       generator=torch.Generator().manual_seed(0))
        trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((batch, image, image, 3), generator=gen,
                        device=device)
        y = torch.randint(0, net.output._units, (batch,), generator=gen,
                          device=device).float()
        label = "continuous_trainer:%s" % type(net).__name__
        with autograd.pause():          # deferred shapes, if any
            net(x[:1])

        def fwd_bwd():
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.sum().backward()
            return loss

        profiling.capture_jit(label, fwd_bwd, kind="train_step",
                              arguments=[p.data()._data for p in
                                         net.collect_params().values()])
        flops = profiling.flops_per_step(label)
        check(flops and flops > 0, "no walked flops for %s" % label)
        led = goodput.ledger(window_steps=window, flops_per_step=flops)
        ct = ContinuousTrainer(net, trainer, loss_fn,
                               (NDArray(x), NDArray(y)),
                               os.path.join(root, "ckpt"),
                               publish_every=publish_every)
        scrapes, sentinel_reports = [], []
        t0 = time.perf_counter()
        with chaos.scenario(seed=0):
            chaos.on("memory.leak", nth=range(leak_from, steps + 1),
                     action=lambda ctx: memory.pin_action(
                         dict(ctx, nbytes=leak_bytes)))
            for _ in range(steps // window):
                ct.run_steps(window)
                sentinel_reports.append(sent.last())
                got = {p: _http_get(port, p)
                       for p in ("/healthz", "/metrics", "/statusz")}
                status = json.loads(got["/statusz"][1])
                scrapes.append({
                    "healthz": got["/healthz"][0],
                    "metrics_goodput_shares": sum(
                        1 for line in got["/metrics"][1].splitlines()
                        if line.startswith("mxnet_tpu_goodput_")
                        and "_share " in line),
                    "metrics_live_bytes": any(
                        line.startswith("mxnet_tpu_memory_live_bytes ")
                        for line in got["/metrics"][1].splitlines()),
                    "statusz_goodput": status["goodput"] is not None,
                    "statusz_memory_censuses":
                        (status["memory"] or {}).get("censuses"),
                    "statusz_ready": status["ready"]})
            ct.close()
        wall = time.perf_counter() - t0
        wins = led.windows()
        pinned = memory.pinned_count()
    finally:
        memory.unpin_all()
        memory._set_watch(prev_watch)
        chaos.reset()
        if port is not None:
            obs.server.stop()
        flight.uninstall()
        obs.disable_goodput()
        telemetry.flush()
        telemetry.registry().detach(sink)
        sink.close()
        telemetry._jsonl_sink = None
        telemetry.disable()
    onset = (leak_from - 1) // window
    flagged = [r["index"] for r in sentinel_reports if r and r["leak"]]
    rc, text = _cli_output(tcli.main, ["summarize", jsonl, "--json"])
    agg = json.loads(text)
    _rc, human = _cli_output(tcli.main, ["summarize", jsonl])
    gp_lines = [line for line in human.splitlines()
                if line.startswith(("  goodput:", "  bottleneck:"))]
    active = [w for w in wins if w["steps"]]
    per_step = {c: float(np.mean([w["categories"][c]["per_step_s"]
                                  for w in active]))
                for c in goodput.CATEGORIES}
    out = {"batch": batch, "steps": steps, "publish_every": publish_every,
           "window": window, "wall_s": wall, "flops_per_step": flops,
           "windows": [goodput.line_summary(w) for w in wins],
           "reconciliation_errors": [w["reconciliation"]["error"]
                                     for w in wins],
           "per_step_s": per_step, "mfu": [w["mfu"] for w in active],
           "regressions": [(w["index"], r["category"])
                           for w in wins for r in w["regressions"]],
           "sentinel": [{k: r[k] for k in ("index", "live_bytes",
                                           "live_arrays", "publishes")}
                        if r else None for r in sentinel_reports],
           "leak_onset_window": onset, "leak_windows": flagged,
           "leak": [r["leak"] for r in sentinel_reports if r and r["leak"]],
           "pinned": pinned, "scrapes": scrapes,
           "summarize_goodput": agg.get("goodput"),
           "card": gpu_line() if cuda else None}
    print("observed always-on trainer (ResNet-50 v1 NHWC fp32, batch %d, "
          "goodput + leak sentinel + flight recorder + obs server): %s"
          % (batch, json.dumps(out)))
    print("mxtelemetry summarize (goodput section):\n%s"
          % "\n".join(gp_lines))
    check(all(w["reconciliation"]["ok"] for w in wins),
          "a goodput window does not reconcile: %s"
          % out["reconciliation_errors"])
    check(len(active) == steps // window,
          "%d active windows for %d steps" % (len(active), steps))
    check(flagged and min(flagged) >= onset
          and min(flagged) <= onset + OPS_LEAK_WITHIN,
          "the sentinel flagged windows %s for a leak from window %d"
          % (flagged, onset))
    for i, sc in enumerate(scrapes):
        check(sc["healthz"] == 200 and sc["metrics_goodput_shares"]
              == len(goodput.CATEGORIES) and sc["metrics_live_bytes"]
              and sc["statusz_goodput"]
              and sc["statusz_memory_censuses"] == i + 1,
              "scrape %d: %s" % (i, sc))
    gp = agg.get("goodput") or {}
    check(rc == 0 and gp.get("windows") == len(wins)
          and gp.get("steps") == steps
          and gp.get("regressions") == len(out["regressions"]),
          "mxtelemetry summarize: %s against %d windows, %d steps, %d "
          "regressions" % (gp, len(wins), steps, len(out["regressions"])))
    check(gp_lines, "mxtelemetry summarize printed no goodput section")
    return out


def ops_worker(root, out_dir, steps=OPS_WORKER_STEPS,
               publish_every=OPS_WORKER_PUBLISH, image=224,
               batch=HOTSWAP_BATCH, device="cuda", make_net=None):
    """The supervised worker of phase 17 (d), one process a generation:
    phase (c)'s trainer resumed from the newest intact step of ``root``
    and trained to step ``steps``, publishing every ``publish_every``,
    with this generation's flight recorder in ``out_dir`` and the chaos
    spec of ``MXNET_TPU_CHAOS_SPEC`` armed (its KILL scoped to
    generation 0).  Writes ``gen<N>.json`` with the resumed and final
    steps; returns 0."""
    import torch
    from mxnet_tpu_torch import chaos, gluon, obs, telemetry
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import ContinuousTrainer
    generation = int(os.environ.get("MXNET_TPU_GENERATION", "0") or 0)
    telemetry.enable()
    obs.install_blackbox(os.path.join(out_dir, "gen%d.bbox" % generation))
    chaos.arm_from_spec()
    net = (make_net or resnet50_nhwc)()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, image, image, 3), generator=gen, device=device)
    y = torch.randint(0, net.output._units, (batch,), generator=gen,
                      device=device).float()
    ct = ContinuousTrainer(net, trainer,
                           gluon.loss.SoftmaxCrossEntropyLoss(),
                           (NDArray(x), NDArray(y)), root,
                           publish_every=publish_every)
    ckpt = ct.resume()
    resumed = ckpt.step if ckpt is not None else 0
    print("generation %d resumed from step %d" % (generation, resumed),
          flush=True)
    loss = ct.run_steps(steps - resumed)
    ct.close()
    with open(os.path.join(out_dir, "gen%d.json" % generation), "w") as f:
        json.dump({"generation": generation, "resumed_from": resumed,
                   "final_step": ct.step,
                   "published_step": ct.published_step,
                   "loss": float(loss.asnumpy().mean())}, f)
    return 0


def ops_supervised(root, steps=OPS_WORKER_STEPS,
                   publish_every=OPS_WORKER_PUBLISH,
                   kill_step=OPS_KILL_STEP, worker_args=""):
    """Phase 17 (d): ``Supervisor([python, worker], 1,
    max_restarts=2)`` over :func:`ops_worker`, with ``chaos.KILL`` at
    the step's first fail point (``numerics.nonfinite``) at step
    ``kill_step`` of generation 0 only.  Checks: ``run()`` returns 0
    with one restart; generation 1 resumed from the last publish before
    the kill and finished; ``mxtelemetry blackbox`` on generation 0's
    flight file names ``chaos.kill`` and its point."""
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.supervisor import Supervisor
    from mxnet_tpu_torch.telemetry import cli as tcli
    os.makedirs(root, exist_ok=True)
    ckpt = os.path.join(root, "ckpt")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "sys.exit(chip_smoke.ops_worker(%r, %r, %d, %d%s))"
            % (here, ckpt, root, steps, publish_every,
               (", " + worker_args) if worker_args else ""))
    spec = chaos.make_spec(seed=0, rules=[{
        "point": "numerics.nonfinite", "action": "kill",
        "nth": [kill_step], "generation": 0}])
    env = dict(os.environ, MXNET_TPU_CHAOS_SPEC=spec,
               MXNET_TPU_GENERATION="0")
    sup = Supervisor([sys.executable, "-c", code], 1, max_restarts=2,
                     grace_s=5.0, env=env)
    result = {}
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: result.setdefault("rc", sup.run()),
                          daemon=True)
    th.start()
    th.join(OPS_SUPERVISOR_TIMEOUT_S)
    if th.is_alive():
        sup.close()
        th.join(30)
        check(False, "the supervised run passed %d s"
              % OPS_SUPERVISOR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    gens = {}
    for g in (0, 1):
        path = os.path.join(root, "gen%d.json" % g)
        if os.path.exists(path):
            gens[g] = json.load(open(path))
    bb_rc, bb = _cli_output(tcli.main, ["blackbox",
                                        os.path.join(root, "gen0.bbox")])
    kill_lines = [line for line in bb.splitlines() if "chaos.kill" in line]
    last_publish = (kill_step - 1) // publish_every * publish_every
    out = {"rc": result.get("rc"), "restarts": sup.restarts,
           "generation": sup.generation, "exhausted": sup.exhausted,
           "generations": gens, "wall_s": wall, "kill_step": kill_step,
           "blackbox_kill_lines": kill_lines}
    print("supervised crash-restart (ResNet-50 v1 NHWC ContinuousTrainer "
          "worker, chaos.KILL at step %d of generation 0): %s"
          % (kill_step, json.dumps(out)))
    print("mxtelemetry blackbox gen0.bbox (last lines):\n%s"
          % "\n".join(bb.splitlines()[-6:]))
    check(out["rc"] == 0 and sup.restarts == 1 and sup.generation == 1,
          "supervisor: rc %r, %d restarts, generation %d"
          % (out["rc"], sup.restarts, sup.generation))
    check(0 not in gens, "generation 0 finished past its kill")
    g1 = gens.get(1) or {}
    check(g1.get("resumed_from") == last_publish
          and g1.get("final_step") == steps
          and g1.get("published_step") == steps,
          "generation 1: %s (want resumed from %d, final step %d)"
          % (g1, last_publish, steps))
    check(bb_rc == 0 and kill_lines
          and any("numerics.nonfinite" in line for line in kill_lines),
          "the blackbox of generation 0 does not name the kill: %s"
          % bb[-2000:])
    return out


def ops_plane_phase(make_net=resnet50_nhwc, image=224, batch=OPS_BATCH,
                    train_batch=HOTSWAP_BATCH, sites=BN_RELU_SITES,
                    device="cuda", worker_args=""):
    """Phase 17: (a) two profiled runs of the AMP LARS step, their
    reports rendered by ``mxprof report`` and diffed by ``mxprof diff``
    (no drift); (b) ``mx.profiler`` over replays in the second run; (c)
    the observed always-on trainer; (d) the supervised crash-restart.
    Every artifact under a temporary directory; returns the numbers."""
    import tempfile
    from mxnet_tpu_torch import profiling
    from mxnet_tpu_torch.profiling import cli as pcli
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="mxtt-ops-") as tmp:
        runs = []
        for i in range(2):
            runs.append(ops_profiled_run(
                os.path.join(tmp, "run%d" % i), make_net=make_net,
                batch=batch, image=image,
                trace_replays=OPS_PROFILER_REPLAYS if i else 0,
                sites=sites, device=device))
            gc.collect()
            if device == "cuda":
                release_cuda()
        rep_rc, rep_text = _cli_output(
            pcli.main, ["report", "--dir", os.path.join(tmp, "run0")])
        diff_rc, diff_text = _cli_output(
            pcli.main, ["diff", runs[0]["report"], runs[1]["report"]])
        first = runs[0]
        print("ops plane (a) profiled step (ResNet-50 v1 NHWC, bf16 AMP, "
              "LARS, batch %d): %s" % (batch, json.dumps(
                  {k: v for k, v in first.items() if k != "report"})))
        rl = first["roofline"]
        print("ops plane (a) roofline: step %.3f ms, %.4g flops a step, "
              "MFU %.4f against 989 TFLOP/s (bf16 dense), bandwidth "
              "%.4f of %.4g B/s (peaks assumed: %s), floor %.3f ms (%s)"
              % (first["ms_per_step"], first["totals"]["flops"],
                 first["mfu_vs_989_tflops"], rl["bandwidth_util"],
                 rl["peak_bytes_per_s"], rl["peaks_assumed"],
                 1e3 * rl["floor_step_s"], first["card"]))
        print("mxprof report:\n%s" % rep_text)
        print("mxprof diff of the two runs: %s" % diff_text.strip())
        check(rep_rc == 0 and "executables:" in rep_text,
              "mxprof report exited %d" % rep_rc)
        check(diff_rc == 0 and "no drift" in diff_text,
              "mxprof diff of two runs: %s" % diff_text)
        second = runs[1]
        print("ops plane (b) mx.profiler: %s" % json.dumps(
            {k: second.get(k) for k in (
                "trace_device_kernel_events", "trace_hand_kernel_events",
                "trace_per_replay", "graph_kernels_in_trace",
                "cachedop_ranges",
                "ms_per_step", "card")}))
        out["profiled"] = runs
        if device == "cuda":
            release_cuda()
        out["observed"] = ops_observed_trainer(
            os.path.join(tmp, "observed"), make_net=make_net, image=image,
            batch=train_batch, device=device)
        gc.collect()
        if device == "cuda":
            release_cuda()
        out["supervised"] = ops_supervised(
            os.path.join(tmp, "supervised"), worker_args=worker_args)
    profiling.reset()
    out["phase_s"] = time.perf_counter() - t_phase
    print("ops plane phase: %.1f s" % out["phase_s"])
    out["launches"] = {n: {"warm_up_walked": first["warm_launches"][n],
                           "replayed_%d_steps" % OPS_STEPS:
                               first["launches"][n]}
                       for n in OPS_KERNELS}
    return out


# ---------------------------------------------------------------------
# phase 18: multi-process data-parallel training under the supervisor,
# watched by the fleet plane
# ---------------------------------------------------------------------

DIST_RANKS = 2
DIST_BATCH = 32                    # a rank's batch
DIST_STEPS = 6
DIST_PUBLISH = 2                   # ContinuousTrainer(publish_every=)
DIST_KILL_NTH = 2                  # rank 1 dies in the step-4 publish
DIST_SEED = 0                      # rank r initializes from seed + r
DIST_BARRIER_MS = 20000
DIST_LEASE_TTL_S = 4.0
DIST_GRACE_S = 40.0                # above the barrier bound
DIST_SCRAPE_MS = 250
DIST_LINGER_S = 60.0               # generation 1 stays up until the
                                   # parent's mxtelemetry fleet has run
DIST_ORACLE_TOL = 1e-6             # step-1 update, world vs one process
DIST_SUPERVISOR_TIMEOUT_S = 360


def dist_shard_batch(num_parts, part_index, step, batch, image, classes,
                     device="cuda"):
    """Step ``step``'s batch of part ``part_index`` of a synthetic
    dataset of ``num_parts * batch`` samples a step, split the way
    ``num_parts``/``part_index`` split a record file: part p holds the
    contiguous samples ``[p * L, (p + 1) * L)``, and its step s reads
    the s-th ``batch`` of them.  Sample i is drawn from seed i."""
    import torch
    from mxnet_tpu_torch.ndarray import NDArray
    per_part = batch * DIST_STEPS
    first = part_index * per_part + (step - 1) * batch
    xs, ys = [], []
    for i in range(first, first + batch):
        gen = torch.Generator(device=device).manual_seed(1000003 + i)
        xs.append(torch.randn((image, image, 3), generator=gen,
                              device=device))
        ys.append(torch.randint(0, classes, (1,), generator=gen,
                                device=device))
    return NDArray(torch.stack(xs)), NDArray(torch.cat(ys).float())


def _bytes_digest(tensors):
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.digest()


def _state_tensors(trainer, i):
    state = trainer._updater.states.get(i)
    if state is None:
        return []
    return [s for s in (state if isinstance(state, (list, tuple))
                        else [state]) if s is not None]


def dist_digests(net, trainer):
    """Per structural name: the sha256 of each trainable weight
    (``weights``), of each running statistic (``stats``) and of each
    weight's optimizer state (``momenta``)."""
    index = {id(p): i for i, p in enumerate(trainer._params)}
    out = {"weights": {}, "stats": {}, "momenta": {}}
    for name, p in sorted(net._collect_params_with_prefix().items()):
        if p.grad_req == "null":
            out["stats"][name] = _bytes_digest([p._data]).hex()
        else:
            out["weights"][name] = _bytes_digest([p._data]).hex()
            out["momenta"][name] = _bytes_digest(
                _state_tensors(trainer, index[id(p)])).hex()
    return out


def _materialize(net, image, device):
    """Give every deferred parameter its shape and value: one batch-1
    forward of zeros outside the tape (BatchNorm reads its running
    statistics and leaves them)."""
    import torch
    from mxnet_tpu_torch import autograd
    with autograd.pause():
        net(torch.zeros((1, image, image, 3), device=device))


def _write_json(path, obj):
    tmp = path + ".%d.tmp" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def dist_worker(root, out_dir, steps=DIST_STEPS,
                publish_every=DIST_PUBLISH, batch=DIST_BATCH, image=224,
                device="cuda", make_net=None):
    """One rank of phase 18, one process a rank and generation: joins
    the world (``mx.distributed_init``), serves its obs server, builds
    ResNet-50 v1 NHWC from seed ``DIST_SEED + rank``, broadcasts rank
    0's weights through ``Trainer(kvstore="dist_sync")``, resumes a ``ContinuousTrainer`` from the newest intact step
    of ``root`` and trains its part of the data to step ``steps``.
    Writes ``g<gen>_r<rank>.json`` under ``out_dir`` after every step,
    with the digest of the weights after the broadcast and of the
    weights and momenta after every step, which the parent compares
    across the ranks; on a ``BarrierTimeout`` records it and exits 3
    through ``failfast_exit``.  Its flight recorder
    (``flight_g<gen>_r<rank>``) holds the chaos KILL's wall-clock
    mark."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import chaos, gluon, obs, telemetry
    from mxnet_tpu_torch import distributed as dist
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.obs import goodput
    from mxnet_tpu_torch.serving import ContinuousTrainer
    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    t_start = time.time()
    check(mx.distributed_init(), "distributed_init joined no world")
    nproc, rank = dist.world()
    # the ranks share the host's cores, as torchrun's one thread a rank
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    gen = dist.generation()
    rec = {"generation": gen, "rank": rank, "pid": os.getpid(),
           "t_start": t_start, "t_joined": time.time(), "steps": []}
    path = os.path.join(out_dir, "g%d_r%d.json" % (gen, rank))
    telemetry.enable()
    obs.flight.install(os.path.join(out_dir, "flight_g%d_r%d"
                                    % (gen, rank)), sigusr2=False)
    obs.enable_goodput()
    goodput.ledger(window_steps=publish_every)
    obs.serve(0)
    chaos.arm_from_spec()
    net = (make_net or resnet50_nhwc)()
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(DIST_SEED + rank))
    _materialize(net, image, device)
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD,
                            kvstore="dist_sync")
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.allreduce_grads()       # no gradient yet: the initial sync
    if cuda:
        torch.cuda.synchronize()
    rec["initial_broadcast_s"] = time.perf_counter() - t0
    everything = [p._data for _n, p in
                  sorted(net._collect_params_with_prefix().items())]
    rec["initial_digest"] = _bytes_digest(everything).hex()
    classes = net.output._units
    ct = ContinuousTrainer(
        net, trainer, gluon.loss.SoftmaxCrossEntropyLoss(),
        lambda step: dist_shard_batch(nproc, rank, step, batch, image,
                                      classes, device),
        root, publish_every=publish_every)
    ckpt = ct.resume()
    resumed = ckpt.step if ckpt is not None else 0
    rec["resumed_from"] = resumed
    if ckpt is not None:
        want = json.load(open(os.path.join(
            out_dir, "step%d_r0.json" % resumed)))
        got = dist_digests(net, trainer)
        rec["resume_equal_to_rank0_dump"] = {
            part: got[part] == want[part] for part in got}
    registry.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kv_timer = telemetry.timer("kvstore.time")
    kv0 = (kv_timer.count, kv_timer.sum,
           telemetry.counter("dist.bytes").value)
    rec["publish_s"] = []

    def counts():
        publishes = telemetry.registry().get("train_loop.publish")
        rec["publish_s"] = [e.get("seconds") for e in (
            publishes.recent if publishes is not None else [])]
        rec["steps_run"] = ct.step - resumed
        rec["launches"] = {n: registry.launches(n)
                           for n in ("bn_relu_apply", "bn_relu_bwd")}
        rec["launch_dtypes"] = {n: registry.launch_dtypes(n)
                                for n in ("bn_relu_apply", "bn_relu_bwd")}
        steps_run = max(rec["steps_run"], 1)
        rec["allreduce"] = {
            "calls": kv_timer.count - kv0[0],
            "ms_per_step": 1e3 * (kv_timer.sum - kv0[1]) / steps_run,
            "bytes_per_step": (telemetry.counter("dist.bytes").value
                               - kv0[2]) / steps_run}
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated() \
            if cuda else None

    step_timer = telemetry.timer("trainer.step_time")
    while ct.step < steps:
        # step 1 runs cuDNN's deterministic algorithms, as the oracle
        # does (c); the later steps its default ones
        torch.backends.cudnn.deterministic = ct.step == 0
        if cuda:
            torch.cuda.synchronize()
        before = (step_timer.sum, kv_timer.sum, len(rec["publish_s"]))
        t0 = time.perf_counter()
        try:
            ct.run_steps(1)
        except dist.BarrierTimeout as e:
            counts()
            rec["kill"] = {
                "error": type(e).__name__, "tag": e.tag,
                "ranks": list(e.ranks),
                "presumed_dead": list(e.presumed_dead),
                "elapsed_s": e.elapsed_s, "t_wall": time.time(),
                "step": ct.step,
                "latest_step": ct.manager.latest_step(),
                "step_visible": os.path.isdir(
                    ct.manager.step_dir(ct.step))}
            _write_json(path, rec)
            print("rank %d generation %d: %s: %s" % (rank, gen,
                                                     type(e).__name__, e),
                  flush=True)
            dist.failfast_exit(3)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step = ct.step
        digests = dist_digests(net, trainer)
        state = json.dumps([digests["weights"], digests["momenta"]],
                           sort_keys=True).encode()
        counts()
        trainer_s = step_timer.sum - before[0]
        allreduce_s = kv_timer.sum - before[1]
        publish_s = sum(rec["publish_s"][before[2]:])
        rec["steps"].append({
            "step": step, "s": dt, "published": step % publish_every == 0,
            "train_s": dt - publish_s,
            "forward_backward_s": dt - publish_s - trainer_s,
            "allreduce_s": allreduce_s,
            "update_s": trainer_s - allreduce_s,
            "digest": hashlib.sha256(state).hexdigest(),
            "t_wall": time.time()})
        if step == 1 and gen == 0 and rank == 0:
            torch.save({n: p._data.detach().cpu() for n, p in
                        net._collect_params_with_prefix().items()
                        if p.grad_req != "null"},
                       os.path.join(out_dir, "step1_weights.pt"))
        if step % publish_every == 0 and gen == 0:
            _write_json(os.path.join(out_dir, "step%d_r%d.json"
                                     % (step, rank)), digests)
        counts()
        _write_json(path, rec)
        # the digests above are this check's work, not the step's: the
        # ranks meet after it, so neither's next timed step waits in the
        # allreduce for the other's digests
        dist.barrier("dist_phase_step")
    counts()
    dist.barrier("dist_phase_done")
    # both ranks stay up (their obs servers answering) until the parent
    # has run mxtelemetry fleet against them
    deadline = time.time() + DIST_LINGER_S
    while time.time() < deadline and not os.path.exists(
            os.path.join(out_dir, "fleet_rendered")):
        time.sleep(0.1)
    ct.close()
    obs.server.stop()
    rec["t_end"] = time.time()
    _write_json(path, rec)
    return 0


def dist_oracle(make_net=resnet50_nhwc, image=224, batch=DIST_BATCH,
                device="cuda"):
    """Phase 18 (c)'s single process: rank 0's initial net, both ranks'
    step-1 batches through forward and backward in turn (each from the
    initial running statistics, as each rank starts), their gradients
    summed in rank order and one SGD update at the local batch size.  Returns the trainable weights before and after, on the
    host."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    cuda = device == "cuda"
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    net = make_net()
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(DIST_SEED))
    _materialize(net, image, device)
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD,
                            kvstore=None)
    params = sorted(net._collect_params_with_prefix().items())
    named = [(n, p) for n, p in params if p.grad_req != "null"]
    stats = [(p, p._data.detach().clone()) for _n, p in params
             if p.grad_req == "null"]
    w0 = {n: p._data.detach().cpu().clone() for n, p in named}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    grads = []
    for part in range(DIST_RANKS):
        # each rank's step 1 starts from the initial running statistics
        # (BatchNorm centres its batch moments on them)
        for p, value in stats:
            p._data.copy_(value)
        x, y = dist_shard_batch(DIST_RANKS, part, 1, batch, image,
                                net.output._units, device)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        grads.append([p._data.grad.clone() for _n, p in named])
        for _n, p in named:
            p._data.grad = None
    for (_n, p), parts in zip(named, zip(*grads)):
        total = parts[0].clone()
        for g in parts[1:]:
            total += g
        p._data.grad = total
    trainer.step(batch)
    if cuda:
        torch.cuda.synchronize()
    w1 = {n: p._data.detach().cpu().clone() for n, p in named}
    torch.backends.cudnn.deterministic = was
    return w0, w1


def _update_rel_err(w0, w1_world, w1_oracle):
    """||world update - oracle update|| / ||oracle update|| over every
    trainable weight together."""
    import torch
    num = den = 0.0
    for n in w0:
        du = (w1_world[n] - w0[n]).double()
        do = (w1_oracle[n] - w0[n]).double()
        num += float(((du - do) ** 2).sum())
        den += float((do ** 2).sum())
    return (num ** 0.5) / max(den ** 0.5, 1e-30), \
        all(torch.equal(w1_world[n], w1_oracle[n]) for n in w0)


def _fleet_row(snap, t0):
    agg = snap["aggregate"]
    return {"t": snap["t"], "rel_s": snap["t"] - t0,
            "replicas": [(r["rank"], r["generation"], r["pid"], r["state"])
                         for r in snap["replicas"]],
            "firing": [a["rule"] for a in snap["alerts"]["firing"]],
            "transitions": [(a["rule"], a["state"])
                            for a in snap["alerts"]["transitions"]],
            "goodput_skew": agg.get("goodput_skew")}


def _both_up(row, gen):
    ok = [r for r in row["replicas"] if r[1] == gen and r[3] == "ok"]
    return sorted(r[0] for r in ok) == list(range(DIST_RANKS))


def dist_phase(make_net=resnet50_nhwc, image=224, batch=DIST_BATCH,
               steps=DIST_STEPS, publish_every=DIST_PUBLISH,
               sites=BN_RELU_SITES, device="cuda", worker_args=""):
    """Phase 18: two ranks of ``dist_worker`` under the port's
    ``Supervisor`` (``max_restarts=2``), rank 1 chaos-KILLed at the
    ``committed`` gate of the step-4 publish in generation 0, the world
    relaunched and run to step ``steps``; the step-1 oracle first; a
    ``FleetMonitor`` over the workers' endpoint files all along, with
    ``mxtelemetry fleet`` run once against the live generation 1 and
    this process's ``/alertz`` serving the monitor's engine.  Checks
    (a)-(e) of the module docstring; returns the numbers."""
    import tempfile
    import urllib.request
    import torch
    from mxnet_tpu_torch import chaos, obs
    from mxnet_tpu_torch.obs import fleet
    from mxnet_tpu_torch.supervisor import Supervisor
    t_phase = time.perf_counter()
    card = gpu_line() if device == "cuda" else "cpu"
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="mxtt-dist-") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        eps = os.path.join(tmp, "endpoints")
        t0 = time.perf_counter()
        w0, w1_oracle = dist_oracle(make_net, image, batch, device)
        out["oracle_s"] = time.perf_counter() - t0
        if device == "cuda":
            release_cuda()
        here = os.path.dirname(os.path.abspath(__file__))
        code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
                "sys.exit(chip_smoke.dist_worker(%r, %r, %d, %d, %d%s))"
                % (here, ckpt, tmp, steps, publish_every, batch,
                   (", " + worker_args) if worker_args else ""))
        spec = chaos.make_spec(seed=0, rules=[{
            "point": "checkpoint.sharded.barrier.committed",
            "action": "kill", "nth": DIST_KILL_NTH, "rank": 1,
            "generation": 0}])
        env = dict(os.environ, MXNET_TPU_CHAOS_SPEC=spec,
                   MXNET_TPU_GENERATION="0",
                   MXNET_TPU_DIST_BARRIER_TIMEOUT_MS=str(DIST_BARRIER_MS),
                   MXNET_TPU_DIST_LEASE_TTL_S=str(DIST_LEASE_TTL_S))
        sup = Supervisor([sys.executable, "-u", "-c", code], DIST_RANKS,
                         max_restarts=2, grace_s=DIST_GRACE_S, env=env,
                         endpoints_dir=eps)
        mon = fleet.FleetMonitor(eps, scrape_ms=DIST_SCRAPE_MS)
        obs.serve(0)
        alertz_url = "http://127.0.0.1:%d/alertz" % obs.server.port()
        timeline, procs, rounds_ms, cli = [], {}, [], {}
        stop = threading.Event()
        t_wall0 = time.time()

        def run_cli():
            res = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.telemetry",
                 "fleet", eps, "--rounds", "2", "--interval-ms",
                 str(DIST_SCRAPE_MS)], capture_output=True, text=True,
                timeout=120, cwd=here)
            cli.update(rc=res.returncode, text=res.stdout,
                       err=res.stderr[-2000:])
            open(os.path.join(tmp, "fleet_rendered"), "w").close()

        def watch():
            cli_thread = None
            while not stop.is_set():
                # every worker of every generation, for its exit code
                procs.update((p.pid, p) for p in list(sup._procs))
                t = time.perf_counter()
                try:
                    snap = mon.poll_once()
                except Exception as e:  # noqa: BLE001 -- (e) fails on it
                    timeline.append({"t": time.time(), "error": repr(e)})
                else:
                    rounds_ms.append(1e3 * (time.perf_counter() - t))
                    row = _fleet_row(snap, t_wall0)
                    timeline.append(row)
                    if cli_thread is None and _both_up(row, 1):
                        cli_thread = threading.Thread(target=run_cli,
                                                      daemon=True)
                        cli_thread.start()
                stop.wait(DIST_SCRAPE_MS / 1e3)
            if cli_thread is not None:
                cli_thread.join(120)

        watcher = threading.Thread(target=watch, daemon=True)
        result = {}
        runner = threading.Thread(
            target=lambda: result.setdefault("rc", sup.run()), daemon=True)
        t_world = time.perf_counter()
        watcher.start()
        runner.start()
        runner.join(DIST_SUPERVISOR_TIMEOUT_S)
        if runner.is_alive():
            sup.close()
            runner.join(30)
        out["world_s"] = time.perf_counter() - t_world
        with urllib.request.urlopen(alertz_url, timeout=10) as r:
            alertz = json.loads(r.read())
        stop.set()
        watcher.join(150)
        mon.close()
        obs.server.stop()
        recs = {}
        for g in (0, 1):
            for r in range(DIST_RANKS):
                p = os.path.join(tmp, "g%d_r%d.json" % (g, r))
                if os.path.exists(p):
                    recs[(g, r)] = json.load(open(p))
        flight_g0_r1 = os.path.join(tmp, "flight_g0_r1")
        kill_marks = [r["t"] for r in (obs.flight.read(flight_g0_r1)
                                       if os.path.exists(flight_g0_r1)
                                       else ())
                      if r.get("name") == "chaos.kill"]
        w1_path = os.path.join(tmp, "step1_weights.pt")
        w1_world = torch.load(w1_path) if os.path.exists(w1_path) else None
    check(not runner.is_alive() and result.get("rc") == 0
          and sup.restarts == 1 and sup.generation == 1,
          "supervisor: rc %r, %d restarts, generation %d"
          % (result.get("rc"), sup.restarts, sup.generation))
    check(sorted(recs) == [(0, 0), (0, 1), (1, 0), (1, 1)],
          "phase 18 records: %s" % sorted(recs))
    # (a) the initial broadcast and (b) every step: each rank's
    # digests, written to its record, are rank 0's
    for (g, r), rec in sorted(recs.items()):
        if r == 0:
            continue
        rec0 = recs[(g, 0)]
        check(rec["initial_digest"] == rec0["initial_digest"],
              "(a) generation %d rank %d differs from rank 0 after the "
              "initial broadcast" % (g, r))
        mine = {s["step"]: s["digest"] for s in rec["steps"]}
        theirs = {s["step"]: s["digest"] for s in rec0["steps"]}
        bad = sorted(n for n in set(mine) | set(theirs)
                     if mine.get(n) != theirs.get(n))
        check(mine and not bad,
              "(b) generation %d rank %d differs from rank 0 after steps "
              "%s (its steps %s, rank 0's %s)"
              % (g, r, bad, sorted(mine), sorted(theirs)))
    # (b) the fused kernels at every site of every step a rank ran, in
    # fp32
    for key, rec in sorted(recs.items()):
        want = sites * rec["steps_run"]
        for name in ("bn_relu_apply", "bn_relu_bwd"):
            check(rec["launches"][name] == want
                  and (sites == 0 or rec["launch_dtypes"][name]
                       == {"float32": want}),
                  "(b) generation %d rank %d: %s launched %s (%s), want "
                  "%d = %d x %d steps in float32"
                  % (key + (name, rec["launches"][name],
                            rec["launch_dtypes"][name], want, sites,
                            rec["steps_run"])))
    # (c) the step-1 update against the one-process oracle
    check(w1_world is not None, "(c) rank 0 wrote no step-1 weights")
    rel, bitwise = _update_rel_err(w0, w1_world, w1_oracle)
    out["oracle"] = {"update_rel_err": rel, "bitwise": bitwise,
                     "limit": DIST_ORACLE_TOL}
    print("multi-process oracle (step 1, 2 ranks x batch %d vs one "
          "process summing both shards' gradients in rank order): %s"
          % (batch, json.dumps(out["oracle"])))
    check(rel <= DIST_ORACLE_TOL,
          "(c) the world's step-1 update is %.3g from the oracle's "
          "(limit %g)" % (rel, DIST_ORACLE_TOL))
    # (d) the kill, the abort and the relaunch
    kill = recs[(0, 0)].get("kill") or {}
    check(kill.get("error") == "BarrierTimeout" and 1 in kill.get("ranks", ())
          and kill.get("step") == 2 * publish_every
          and kill.get("latest_step") == publish_every
          and not kill.get("step_visible"),
          "(d) generation 0 rank 0: %s" % kill)
    g0_pids = {recs[(0, r)]["pid"] for r in range(DIST_RANKS)}
    rcs = {r: procs[recs[(0, r)]["pid"]].poll()
           if recs[(0, r)]["pid"] in procs else None
           for r in range(DIST_RANKS)}
    check(rcs[0] == 3, "(d) rank 0 of generation 0 exited %r, not 3 "
                       "through failfast_exit" % rcs[0])
    # the kill's time is the dying rank's own mark, the chaos KILL's
    # last write to its flight recorder
    t_kill = kill_marks[0] if len(kill_marks) == 1 else None
    check(t_kill is not None and rcs[1] not in (None, 0, 3),
          "(d) rank 1 of generation 0 did not die at the chaos point: "
          "exit %r, kill marks %s" % (rcs[1], kill_marks))
    for r in range(DIST_RANKS):
        rec = recs[(1, r)]
        check(rec["resumed_from"] == publish_every
              and all(rec["resume_equal_to_rank0_dump"].values())
              and rec["steps"] and rec["steps"][-1]["step"] == steps,
              "(d) generation 1 rank %d: resumed from %s, equal to rank "
              "0's step-%d dump %s, last step %s"
              % (r, rec["resumed_from"], publish_every,
                 rec.get("resume_equal_to_rank0_dump"),
                 rec["steps"][-1]["step"] if rec["steps"] else None))
    # (e) the fleet
    errors = [row["error"] for row in timeline if "error" in row]
    rows = [row for row in timeline if "error" not in row]
    up0 = [row for row in rows if _both_up(row, 0)]
    down = [row for row in rows if row["t"] >= t_kill and any(
        rr[0] == 1 and rr[1] == 0 and rr[3] == "down"
        for rr in row["replicas"])]
    fired = [row for row in rows if row["t"] >= t_kill
             and "replica_down" in row["firing"]]
    up1 = [row for row in rows if _both_up(row, 1)]
    resolved = [row for row in rows if up1 and row["t"] >= up1[0]["t"]
                and ("replica_down", "resolved") in row["transitions"]]
    g1_pids = {rr[2] for row in up1[:1] for rr in row["replicas"]}
    skew = next((row["goodput_skew"] for row in reversed(up1)
                 if row["goodput_skew"]), None)
    fleet_out = {
        "rounds": len(rows), "round_errors": len(errors),
        "round_ms_p50": sorted(rounds_ms)[len(rounds_ms) // 2]
        if rounds_ms else None,
        "round_ms_max": max(rounds_ms) if rounds_ms else None,
        "down_after_kill_s": down[0]["t"] - t_kill if down else None,
        "fire_after_kill_s": fired[0]["t"] - t_kill if fired else None,
        "resolve_after_gen1_up_s": resolved[0]["t"] - up1[0]["t"]
        if resolved else None,
        "gen1_up_after_kill_s": up1[0]["t"] - t_kill if up1 else None,
        "goodput_skew": skew}
    out["fleet"] = fleet_out
    print("fleet monitor over phase 18 (scrape every %d ms): %s"
          % (DIST_SCRAPE_MS, json.dumps(fleet_out)))
    print("goodput skew over the two ranks of generation 1: %s"
          % json.dumps(skew))
    print("mxtelemetry fleet (generation 1 live), exit %s:\n%s"
          % (cli.get("rc"), cli.get("text", "").rstrip()))
    hist = [h for h in alertz.get("history", ())
            if h.get("rule") == "replica_down"]
    print("/alertz of this process: monitors %s, firing %s, replica_down "
          "history %s" % (alertz.get("monitors"),
                          [a.get("rule") for a in alertz.get("firing", ())],
                          [h.get("state") for h in hist]))
    check(not errors, "(e) %d monitor round(s) raised; the first: %s"
          % (len(errors), errors[:1]))
    check(up0, "(e) the monitor never saw both ranks of generation 0 up")
    check(down and down[0]["t"] - t_kill <= DIST_LEASE_TTL_S,
          "(e) rank 1 not presumed down within %.1f s of the kill: %s"
          % (DIST_LEASE_TTL_S, fleet_out))
    check(fired, "(e) replica_down never fired after the kill")
    check(up1 and not (g1_pids & g0_pids),
          "(e) generation 1 never up on new pids: %s" % (up1[:1],))
    check(resolved, "(e) replica_down never resolved in generation 1")
    check(skew is not None and skew.get("max_over_median") is not None,
          "(e) no goodput skew over the ranks of generation 1: %s" % skew)
    check(cli.get("rc") == 0 and "2 replica(s), 2 up / 0 down"
          in cli.get("text", ""),
          "(e) mxtelemetry fleet: exit %s\n%s%s" % (
              cli.get("rc"), cli.get("text"), cli.get("err")))
    check(alertz.get("schema") == "mxalertz.v1"
          and alertz.get("monitors") == 1
          and any(h.get("state") == "resolved" for h in hist),
          "(e) /alertz: %s" % json.dumps(alertz)[:2000])
    # the numbers
    per_rank = {}
    for (g, r), rec in sorted(recs.items()):
        # each process's first step sets up cuDNN and the allocator
        plain = rec["steps"][1:]

        def ms(part):
            vals = sorted(s[part] for s in plain)
            return 1e3 * vals[len(vals) // 2] if vals else None
        per_rank["g%d.r%d" % (g, r)] = {
            "steps": [s["step"] for s in rec["steps"]],
            "ms_per_step": ms("train_s"),
            "ms_forward_backward": ms("forward_backward_s"),
            "ms_allreduce": ms("allreduce_s"), "ms_update": ms("update_s"),
            "first_step_ms": {
                part: 1e3 * rec["steps"][0][part]
                for part in ("train_s", "forward_backward_s",
                             "allreduce_s", "update_s")},
            "initial_broadcast_s": rec["initial_broadcast_s"],
            "publish_s": rec.get("publish_s"),
            "allreduce": rec.get("allreduce"),
            "peak_mem_bytes": rec.get("peak_mem_bytes"),
            "launches": rec["launches"]}
    first_g1 = max(recs[(1, r)]["steps"][0]["t_wall"]
                   for r in range(DIST_RANKS))
    out.update(per_rank=per_rank, kill={
        "barrier_timeout": kill, "rank0_exit_code": rcs[0],
        "rank1_exit_code": rcs[1],
        "kill_to_barrier_timeout_s": kill["t_wall"] - t_kill,
        "kill_to_gen1_first_step_both_s": first_g1 - t_kill},
        launches={"generation %d rank %d" % k: v["launches"]
                  for k, v in sorted(recs.items())})
    for key, row in per_rank.items():
        share = (row["ms_allreduce"] / row["ms_per_step"]
                 if row["ms_allreduce"] and row["ms_per_step"] else None)
        print("multi-process rank %s (ResNet-50 v1 NHWC fp32, dist_sync, "
              "batch %d a rank, %d ranks on one card): %s; allreduce share "
              "of the step %s; %s" % (key, batch, DIST_RANKS,
                                      json.dumps(row), share, card))
    print("multi-process kill and relaunch: %s" % json.dumps(out["kill"]))
    out["phase_s"] = time.perf_counter() - t_phase
    print("multi-process phase: %.1f s (world %.1f s, oracle %.1f s)"
          % (out["phase_s"], out["world_s"], out["oracle_s"]))
    return out


def kernel_entry(name, launches, kern, serve_launches=None, **extra):
    """One kernel's entry of the per-kernel JSON line; a kernel of the
    checkpoint-and-serve phase also gives its launches there, and
    ``extra`` adds the entries of other paths (their launches, their
    shapes' numbers)."""
    from mxnet_tpu_torch.kernels import registry
    spec = registry.get(name)
    entry = {"name": spec.name, "route": "cuda",
             "source": "mxnet_tpu_torch/" + spec.source,
             "replaces": spec.replaces.split()[0], "launches": launches,
             "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
             "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
             "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}
    if serve_launches is not None:
        entry["launches_checkpoint_and_serve"] = serve_launches
    entry.update(extra)
    return entry


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import _capture
    # every capture and replay of phases 1-15 under
    # torch.cuda.set_sync_debug_mode("error"): a host read left inside a
    # captured region fails the run
    with _capture.checking_syncs():
        entries = drive()
    # phase 16 captures a servable while another replays and reads its
    # logits on the host and a trainer runs: the process-wide check is
    # for runs that do one thing at a time, so it runs outside it
    release_cuda()
    print("hot-swap phases: outside the sync check (three threads use "
          "the card at once)")
    hot = hotswap_phase()
    release_cuda()
    gen = generative_swap_phase()
    # phase 17: the ops plane observing ResNet-50 training (its
    # supervised worker and obs server are other processes and threads)
    release_cuda()
    ops = ops_plane_phase()
    # phase 18: two ranks train through dist_sync under the supervisor
    # (other processes on this card), watched by a fleet monitor here
    release_cuda()
    dist = dist_phase()
    for entry in entries:
        name = entry["name"]
        if name in ("bn_relu_apply", "bn_relu_bwd", "paged_attention"):
            entry["launches_hotswap"] = hot["launches"].get(
                name, {"total": 0})
            entry["launches_generative_swap"] = gen["launches"].get(
                name, {"total": 0})
        if name in OPS_KERNELS:
            entry["launches_ops_plane"] = ops["launches"][name]
        if name in ("bn_relu_apply", "bn_relu_bwd"):
            entry["launches_dist_sync"] = {
                who: counts[name] for who, counts in
                dist["launches"].items()}
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive():
    """Phases 1-15; returns the per-kernel entries of the JSON line."""
    import torch
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
    ckpt_root = checkpoint_phase(net, step, x, y)
    bd = train_step_breakdown(step, x, y, train["ms_per_step"])
    capture_report("ResNet-50 fp32 SGD TrainStep", step.capture_stats(),
                   {"ms_per_step": train["ms_per_step"],
                    "img_per_s": train["img_per_s"]},
                   bd["device_idle_share"], 1)
    del step, x, y
    train_oracle(net)
    del net
    torch.cuda.empty_cache()
    capture_holds()
    torch.cuda.empty_cache()
    bucketed_holds()
    torch.cuda.empty_cache()
    net, step, (ids, labels), bert = bert_main_path()
    bd = train_step_breakdown(step, ids, labels, bert["ms_per_step"],
                              hand=BERT_KERNELS, label="BERT step breakdown")
    capture_report("BERT LAMB TrainStep", step.capture_stats(),
                   {"ms_per_step": bert["ms_per_step"],
                    "tokens_per_s": bert["tokens_per_s"]},
                   bd["device_idle_share"], 1)
    sizes = [p.data().size for p in net.collect_params().values()]
    del step, ids, labels
    torch.cuda.empty_cache()
    bert_oracle(net)
    del net
    torch.cuda.empty_cache()
    net, step, (x, y), lars = amp_lars_main_path()
    bd = train_step_breakdown(amp_step(step), x, y, lars["ms_per_step"],
                              hand=LARS_KERNELS,
                              label="AMP LARS step breakdown")
    capture_report("AMP LARS TrainStep.run_steps", step.capture_stats(),
                   {"ms_per_step": lars["ms_per_step"],
                    "img_per_s": lars["img_per_s"],
                    "peak_mem_bytes": lars["peak_mem_bytes"]},
                   bd["device_idle_share"], 1)
    live = [p for p in step._trainer._params if p.grad_req != "null"]
    lars_sizes = [p.data().size for p in live]
    lars_skips = [step._trainer.optimizer._skip_lars(i)
                  for i, p in enumerate(step._trainer._params)
                  if p.grad_req != "null"]
    del step, x, y, live
    torch.cuda.empty_cache()
    amp_lars_oracle(net)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    bert_bf16 = bert_bf16_phase()
    pretrain = bert_pretrain_phase()
    mnist_feed_path(mnist_main_path())
    mnist_oracle()
    dense = densenet_phase()
    release_cuda()
    imagenet = imagenet_input_phase()
    release_cuda()
    attn = kernel_phase(scale)
    bn = bn_relu_kernel_phase()
    flash = flash_kernel_phase(BERT_BATCH * BERT_HEADS, BERT_SEQ, 64)
    ln = layernorm_kernel_phase(BERT_BATCH * BERT_SEQ, 768)
    lamb = lamb_kernel_phase(sizes)
    lars_k = lars_kernel_phase(lars_sizes, lars_skips)
    bf16_k = bert_bf16_kernel_phase()
    pretrain_k = bert_pretrain_kernel_phase()
    torch.cuda.empty_cache()
    serve = serve_phase(ckpt_root)
    decode_ckpt = decode_checkpoint_phase()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    counts = bert["launches"]

    def bf16_path(name):
        extra = {"launches_bert_bf16_adam": {
                     key: run["launches"][name]
                     for key, run in bert_bf16["main"].items()},
                 "bert_bf16_adam": bf16_k[name],
                 "launches_bert_pretrain":
                     pretrain["main"]["launches"][name]}
        kind = {"flash_attention_fwd": "fwd",
                "flash_attention_bwd": "bwd"}.get(name)
        if kind is not None:
            extra["bert_pretrain_masked"] = pretrain_k[kind]
        return extra

    def densenet_path(name):
        """A ``bn_relu_*`` kernel's launches on DenseNet-121's paths and its
        times at three of its shapes; a kernel's launches through the
        ``mx.nd`` routes."""
        routes = {route: r["launches"].get(name, 0)
                  for route, r in dense["routes"].items()}
        kind = {"bn_relu_apply": "fwd", "bn_relu_bwd": "bwd"}.get(name)
        if kind is None:
            return {"launches_mx_nd_routes": routes}
        key = name + "_launches"
        extra = {"launches_densenet": {
                     "train_step": dense["main"][key],
                     "imperative_loop": dense["loop"][key],
                     "mx_nd_routes": routes},
                 "densenet": {what: dict(t[kind], shape=t["shape"],
                                         rows=t["rows"])
                              for what, t in
                              dense["kernels"]["times"].items()}}
        if kind == "fwd":
            extra["launches_densenet"]["zoo_sweep"] = {
                n: z["launches"] for n, z in dense["zoo"].items()}
        return extra

    def input_path(name):
        """A kernel's launches on the ImageNet input path's timed window
        (two streamed epochs), by dtype."""
        main = imagenet["main"]
        return {"launches_imagenet_input": main["launches"][name],
                "launch_dtypes_imagenet_input":
                    main["launch_dtypes"][name]}

    return [
        kernel_entry("paged_attention", decode["paged_attention_launches"],
                     attn, decode_ckpt["paged_attention_launches"]),
        kernel_entry("bn_relu_apply", train["bn_relu_apply_launches"],
                     bn["fwd"], serve["bn_relu_apply_launches"],
                     **densenet_path("bn_relu_apply"),
                     **input_path("bn_relu_apply")),
        kernel_entry("bn_relu_bwd", train["bn_relu_bwd_launches"],
                     bn["bwd"], **densenet_path("bn_relu_bwd"),
                     **input_path("bn_relu_bwd")),
        kernel_entry("flash_attention_fwd", counts["flash_attention_fwd"],
                     flash["fwd"], **bf16_path("flash_attention_fwd"),
                     **densenet_path("flash_attention_fwd")),
        kernel_entry("flash_attention_bwd", counts["flash_attention_bwd"],
                     flash["bwd"], **bf16_path("flash_attention_bwd"),
                     **densenet_path("flash_attention_bwd")),
        kernel_entry("layernorm_fwd", counts["layernorm_fwd"], ln,
                     **bf16_path("layernorm_fwd")),
        kernel_entry("lamb_phase1", counts["lamb_phase1"], lamb),
        kernel_entry("lars_flat", lars["launches"]["lars_flat"], lars_k,
                     **input_path("lars_flat"))]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAIL: %s" % e, file=sys.stderr)
        sys.exit(1)
