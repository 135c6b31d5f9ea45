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
   ``loss.backward()``, ``trainer.step`` and ``metric.update``, 156
   batches (a third of the epoch), then hybridized two untimed batches
   (eager, then captured) and 100 timed ones.  Every loss must be
   finite and the accuracy in [0, 1]; a fresh net must cut the loss
   of one fixed batch 3x in 60 steps.  It prints samples/s, ms/step,
   the share of wall time waiting on the loader, the device's idle
   share (``torch.profiler`` over 20 more batches) and peak memory.
   Then the same loop through the DataLoader's device-feed route,
   ``DataLoader(..., ctx=mx.gpu(0))``: 156 batches of a fresh net, its
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

15. the ImageNet input path (ROADMAP item 6), after DenseNet: 4,096
   raw 224x224x3 records (``bench.py :: _build_rec(fmt="raw")``'s
   images from seed 0, labels ``i % 1000``, 0.62 GB) written by the
   port's ``recordio`` into a temporary directory under ``build/`` and
   removed at the end; ``mx.io.ImageRecordIter(ctx=mx.gpu(0),
   dtype="bfloat16")`` (batch 512, shuffle, random mirror, ImageNet's
   mean and std, 4 threads) -- a ``DeviceFeed`` over an ``ImageIter``
   -- feeding ResNet-50 v1 NHWC under bf16 AMP with bucketed LARS
   (``make_lars_step``) as ``step(batch)`` after an NHWC transpose on
   the card, at most two steps ahead of it.  The step is warmed and
   captured on a zero batch, timed on a synthetic device batch, then the
   counters are zeroed and two streamed epochs (16 steps) timed from
   the first record read to the last step's sync: img/s each epoch
   beside the synthetic rate, the overlap share ``1 - consumer_wait /
   producer_busy``, peak memory and reservation; every loss finite and
   the last below the first; ``bn_relu_apply`` and ``bn_relu_bwd``
   33 x 16 on bf16 rows and ``lars_flat`` 16 on fp32.  Then the card's
   idle share over six profiled streamed steps, the loader's parts each
   timed alone (``read_batch`` native and Python, ``next_np`` at
   0/1/2/4/8 threads, the pinned copy of a 77 MB batch,
   ``DeviceTransform`` and the transpose), a landed batch against ``DeviceTransform``'s plain
   CPU result on its host batch (1 bf16 ulp), which recordio route
   ran and which codecs import; with OpenCV or PIL, 1,024 JPEG records
   at 256x256, quality 90, read with ``rand_crop`` at 1/2/4/8 threads
   and streamed through two steps.  The records were just written; two
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
   ``mx.profiler`` over a lead-in and four replays of the second run:
   the dumped Chrome trace's device events, grouped by graph launch,
   must name the three kernels inside the replayed graph, three replays
   agreeing kernel for kernel (counted), each with every hand kernel's
   launches a step, and every other replay only lacking records (the
   tracer drops those it timestamps before the trace's start, and late
   in a long process some inside the trace);
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

19. the symbolic front end and the recurrent nets, fp32 with TF32 off,
   random weights from seed 0, token streams Zipf-distributed over
   10,000 ids from a seed, under the host-read check of phases 1-15.
   (a) ``examples/module_mnist.py``'s loop: ``Module.fit`` of the
   784-128-64-10 MLP with ``SoftmaxOutput`` over 2,048 synthetic samples
   (batch 128, SGD 0.1/0.9, 2 epochs, ``Speedometer(128, 10)``,
   ``do_checkpoint`` under ``build/``, an eval set of 512); one train
   graph replayed for every batch but the first; ``Module.load`` of
   epoch 2 scores the eval set equal to the live module; the validation
   accuracy at least the JAX example's on the CPU from the same weights
   and batches less 0.02.  (b) MXNet's bucketing LSTM language model
   (upstream ``cudnn_lstm_bucketing.py``'s widths: ``Embedding(10000,
   200)`` -> time-major ``RNN(lstm, 200, 2 layers)`` ->
   ``FullyConnected(10000)`` -> ``SoftmaxOutput``) through
   ``BucketingModule.fit``, buckets 10-60 at batch 32, SGD 0.01, wd
   1e-5, every bucket 6 times: perplexities finite and the second
   epoch's under the first's, one train graph a bucket replayed for
   every batch but its first, one shared weight tensor across the
   buckets.  (c) the Gluon word language model (upstream
   ``example/gluon/word_language_model``: ``Embedding(10000, 650)`` ->
   ``LSTM(650, 2 layers, dropout 0.5)`` -> ``Dropout(0.5)`` ->
   ``Dense(10000)``), hybridized, bptt 35, batch 32, the imperative
   loop with the global-norm clip and ``Trainer("sgd", lr=20)``, the
   hidden state carried and detached, 30 steps: losses finite and
   falling; two replays of one captured training call differ (a new
   dropout mask each), eval replays equal.  Then the oracles, card
   against CPU at batch 4: (b) at buckets 10 and 60, (c) with dropout
   0; the loss within 1e-5 and each gradient within 1e-4 norm-wise, or
   4x the permuted-batch floor where that is larger.  Each path prints
   its rate, ms/step, graphs and replays, the device's idle share and
   peak memory; no hand kernel launches in phase 19 (the kernels line
   carries ``launches_symbolic``, all 0).
20. the deployment path, after phase 19, under the same host-read check,
   random weights from seed 0 at full width with every running
   statistic and BatchNorm scale moved off its default (two
   training-mode forwards, then a seeded draw of gamma and beta).  (1)
   ``resnet50_v1(layout="NHWC")`` fp32 hybridized at b32 x 224^2, then
   ``net.export``: the graph holds 33 ``fused_batch_norm_relu`` nodes
   and no BatchNorm feeding a relu; ``SymbolBlock.imports`` on the card,
   hybridized, ``optimize_for`` and an inference ``mx.mod.Module`` from
   ``mx.model.load_checkpoint`` each within 1e-5 of the largest logit of
   the live net, with ``bn_relu_apply`` = 33 x forwards; the card
   against the CPU at b8 within 1e-4.  (2) ``ModelRegistry.register(
   symbol=, params=)`` served by 8 clients (256 requests, phase 13's
   bursts and buckets) beside a ``block=`` servable of the live net:
   one answer per request, none after the drain, each within 1e-4 of
   the ``SymbolBlock``'s batch-1 forward, ``bn_relu_apply`` = 33 x
   executor calls.  (3) ``mx.Predictor`` over b1, b8 and b32 with room
   for two: two graphs resident, one ``serving.compile_evictions``, the
   evicted class recaptured within 1e-5; ``export_compiled`` ->
   ``CompiledPredictor`` in a child process whose one block is the
   archive's ``SymbolBlock``, within 1e-5 (the child runs beside (4)).
   (4) ResNet-50 v1 NCHW exported, ``mx.onnx.export_model``,
   ``get_model_metadata``, ``import_model``, ``register(onnx=)`` at
   buckets 1, 4, 8: answers within 1e-4 of the live net's batch-1
   forward, no hand-kernel launch; the channels-last graph and a lone
   fused node do not convert (the JAX package's errors).  (5) the C
   predict runtime on the host against the card's logits for one image
   within 1e-4, and ``examples/cpp_predict/main.cc`` built with ``g++``
   against the port's library (built in a thread from the phase's
   start) printing ``output shape: (1, 1000)``; both run on the host
   while (4) serves.  Each step prints its times, sizes, rates and
   the card's name and power limit; the kernels line carries
   ``launches_deploy`` by route (every kernel but ``bn_relu_apply`` 0).
21. sparse storage and the contrib op families, after phase 20, seed 0,
   data made on the host.  (a) outside the host-read check: upstream
   ``example/sparse/linear_classification`` at Avazu's scale -- 1,000,000
   hashed features, batch 8,192, 15 ids a row from a Zipf(1.2) draw
   capped at the feature count, values 1, labels from a planted weight
   vector -- 100 steps of ``csr_matrix(..., ctx=mx.gpu(0))``,
   ``row_sparse_pull`` of the batch's unique ids into a dense weight from
   a ``local`` kvstore under ``AdaGrad(0.1, rescale_grad=1/8192)``,
   ``sparse.dot`` forward, the logistic gradient by ``sparse.dot(...,
   transpose_a=True)`` pushed at the batch's ids as a
   ``RowSparseNDArray``: the log-loss of the last 10 steps under the
   first 10's; the rows no batch named bitwise their initial value with
   no history; three steps against a float64 numpy oracle (weights and
   history within 1e-5) and against the port on the CPU (within the
   larger of 1e-5 and 4x the CPU's distance from the same steps with
   each batch's rows permuted, over 4 permutations: the card sums each
   id's gradient with fp32 atomics in no fixed order; a control with the
   most frequent id's gradient dropped from step 2 on the CPU side must
   fail that limit), one step of
   SGD's lazy row update and of its momentum route against the oracle;
   steps/s, rows and bytes pulled against the table's and the host syncs
   a step.  (b) upstream ``example/quantization``'s
   ``imagenet_gen_qsym.py`` -> ``imagenet_inference.py``: ResNet-50 v1
   NCHW by phase 20's recipe, exported and loaded back,
   ``quantize_model(calib_mode="naive")`` over 5 batches of 32 with the
   stem excluded (52 ``quantized_conv``, 1 ``quantized_fully_connected``),
   then ``mx.mod.Module`` and a hybridized ``SymbolBlock`` at b32 under
   the host-read check: every int8 site's int32 accumulator on the card
   bitwise the CPU's on the CPU walk's inputs, the logits of 4 images
   within 1e-4 of the CPU run's largest or 4x the spread one ulp of the
   input gives the CPU's own logits, if larger (one ulp before a
   ``quantize_v2`` may round to the next int8 step, and the card's
   float32 layers differ from the CPU's by ulps), the SymbolBlock within
   1e-5 of the Module; ms a batch against the fp32 net's, the int8 logits'
   error and top-1 agreement against fp32 over 256 images.  (c) under
   the host-read check, each card result against the port's CPU run
   within 1e-4 of its largest value: the linalg chain on 64 SPD 256 x 256
   matrices (and its gradient; within 1e-4 of max(1, the largest value),
   the log-determinants being near 0; the eigen- and singular values,
   from cuSOLVER and from LAPACK, within 1e-3, and each device's
   reconstruction within 1e-3 of its input) with ``moments`` over a
   (32, 56, 56, 256) activation; BERT-base's interleaved
   self-attention (seq 512, batch 8, 12 heads; forward and gradient,
   and against ``flash_attention`` on
   the same q, k, v outside the counted window) and its encoder-decoder
   pair at qlen 128; ``box_iou`` of 8 x 6,000 against 8 x 100 boxes and
   ``box_nms`` of (8, 6,000, 6) proposals at 0.7 (bitwise); ``ROIAlign``
   with its gradient and ``ROIPooling`` on a (2, 1024, 38, 50) map, 128
   ROIs an image, 14 x 14, scale 1/16 (the CPU on the first 16 ROIs);
   ``foreach`` over an ``LSTMCell(650)`` for 35 steps at batch 32,
   ``while_loop`` (64 steps) and ``cond`` on a device predicate, each
   hybridized: one captured graph, replayed.  No hand kernel is on
   these paths: the kernels line carries ``launches_contrib`` by part,
   all 0.
22. the NumPy front end and the engine and runtime helpers, after phase
   21, seed 0, fp32 with TF32 off.  (a) ``npx.set_np()``, then
   ``bert_base(vocab_size=30522, max_length=512, dropout=0.1)`` on
   ``gpu(0)`` (random weights from seed 0), fed ``mx.np`` arrays (ids by
   ``np.random.randint``, labels and next-sentence labels by
   ``np.array``, batch 8 x 512), the masked-LM and next-sentence cross
   entropy written with ``npx.log_softmax``, ``npx.pick`` and
   ``np.mean``, 4 imperative steps of ``Trainer(..., "adam")`` (lr
   2e-5): every block output an ``mx.np.ndarray``.  Then the same 4
   steps from the same weights and ``mx.random.seed`` with
   ``npx.reset_np()`` through ``mx.nd`` (block outputs plain
   ``NDArray``s), then the np run again inside ``mx.engine.bulk(64)``;
   the counters zeroed before the first and read after the third:
   ``flash_attention_fwd`` = ``flash_attention_bwd`` = 12 x 4 x 3,
   ``layernorm_fwd`` = 26 x 4 x 3, every other kernel 0.  Every loss
   finite and the last below the first; the first loss of every run
   bitwise the same; the losses and final weights of the np and bulk
   runs bitwise the nd run's when a second nd run (outside the counted
   window) is bitwise the first, else within 4x the distance of the two
   nd runs (the flash backward adds dq with fp32 atomics in no fixed
   order).  It prints each run's step times, then where one more np
   step's time goes (``torch.profiler``: device time by category, the
   hand kernels' share, the idle share).  (b) every ``mx.np``
   function, generated unary name and ``ndarray`` member and every
   ``npx`` op at user widths ((4,096, 768) fp32; ``dot``/``matmul``/
   ``tensordot``/``einsum`` (4,096, 768) x (768, 3,072); the MLM logits
   (4,096, 30,522); a ResNet activation (8, 64, 56, 56)) on the card
   against the same call under ``with mx.cpu():``: equal result types,
   dtypes and shapes, sorts, arg-ops, selections and copies bitwise, the
   rest within 1e-5 of the CPU result's largest magnitude.  (c)
   ``test_utils.check_consistency`` of ten ops of the table, ``cpu(0)``
   against ``gpu(0)``, and ``runtime.Features()`` on the card (``CUDA``,
   ``CUDNN``, ``GPU`` and ``KERNELS`` true, ``TPU``, ``XLA`` and
   ``PALLAS`` false; its ``repr`` printed).  (d) the sixth deviation's
   cost: ``host_us`` of a chain of 256 eager ``mx.np`` adds on a (768,)
   array, microseconds an op, outside and inside
   ``mx.engine.bulk(256)``.  The kernels line carries
   ``launches_numpy``, (a)'s counts.
23. the static half of ``analysis/``, after phase 22, under the
   host-read check; (c) starts first, on the host beside the card work.
   (a) ResNet-50 v1 NHWC fp32 exported by ``HybridBlock.export``
   (phase 20's graph: 33 ``fused_batch_norm_relu`` nodes), bound at b32
   on ``mx.gpu(0)`` unchecked, with ``check=True`` and under
   ``MXNET_TPU_GRAPH_CHECK=1``: no error diagnostic, the check alone
   (timed) allocates nothing and launches nothing, each checked bind's
   forward bitwise the unchecked one, ``bn_relu_apply`` = 33 x 4
   forwards a bind; three broken twins (a duplicate input, a contradicted
   shape, an unknown op) raise ``GraphCheckError`` naming their rule
   with no launch and no allocation, by each route.  (b) the AMP LARS
   step of BASELINE config 5 at b512 walked (its eager warm-up) and
   captured, then ``perf_audit``, ``numerics_audit`` and
   ``memory_audit``: their flops, bytes and memory the CostReport's;
   ``bn_relu_*`` and ``lars_flat`` under their own names; ``convert_share
   > 0``; the H100's bf16 ridge; ``peak_hbm_bytes`` within 15% of
   ``torch.cuda.max_memory_allocated`` around the capture; ``diff_audit``
   of each artifact against itself clean, against a copy with one metric
   grown a drift naming the step and metric; the top advisories printed.
   (c) ``python -m mxnet_tpu_torch.analysis --self --json --sarif`` exits
   0 with no finding (a SARIF 2.1.0 document of the ``mxlint-torch``
   tool); over a planted file the document lists its nine rules' ids;
   ``audit_retrace()`` clean; seconds and counts by rule printed.  The
   kernels line carries ``launches_analysis``: (a)'s forwards and (b)'s
   walked warm-up.
24. meshes and in-graph collectives, after phase 23, in a child world of
   one rank started through ``python -m mxnet_tpu_torch.launch -n 1``
   (NCCL, so this process never joins a world), fp32, TF32 off, cuDNN
   deterministic, seed 0.  (a) ResNet-50 v1 NHWC at b32, SGD 0.05/0.9,
   ``TrainStep(mesh=make_mesh({"dp": 1}))``, 4 steps (eager, captured,
   two replays) under the host-read check: ``bn_relu_*`` 33 x 4; the
   collectives a replay (counted through the replays) > 0 and equal to
   the profiling walk's ``collective`` instructions and to the gradient
   buckets + 2 x the 53 BatchNorm sites; losses, weights and momenta
   within 1e-6 norm-wise of the same step without a mesh.  (b)
   ``bert_base(vocab_size=30522, max_length=512, dropout=0,
   tp_mesh=make_mesh({"tp": 1}))`` with ``shard_tp``, LAMB, 8 x 512, 3
   captured steps: flash fwd and bwd 12 x 3, ``layernorm_fwd`` 26 x 3,
   ``lamb_phase1`` 3; held at ``bucketed_holds``' rule against the same
   model unsharded (its q/k/v tensors, so LAMB's per-tensor trust ratios
   match), both from the plain BERT's seeded weights; the key bias
   printed apart.  (c) ``pipeline_apply`` over BERT-base's 12 layers
   (functional, through the flash and LayerNorm kernels; 2 microbatches
   of 4 x 512, forward and backward) against the layers in sequence;
   ``ring_attention`` at (96, 512, 64), full and causal, and
   ``MixtureOfExperts`` (8 experts, 768/3,072, 8,192 tokens) against
   their plain math; a ``TensorParallelMLP`` saved and restored with
   ``restore(sharding=)`` and whole, bitwise.  Each part prints a
   "mesh (...)" line with its collectives' calls and bytes and a
   profile (ms a call, device busy, NCCL kernel ms and share); the
   kernels line carries ``launches_mesh`` by part.  ``chip_paths.py
   mesh4`` runs the same paths at four ranks, one card each, (a)
   against the b128 step on rank 0 by :func:`mesh_dp_rule`, with two
   planted faults (:func:`planted_fault`) that must each fail it.
25. the surface, after phase 24, under the host-read check, cuDNN
   deterministic: the networks as pure functions of their parameters
   (``HybridBlock.functionalize``).  (a) ResNet-50 v1 NHWC fp32 at b32,
   hybridized: the eval ``pure_fn`` bitwise ``net(x)`` (its eager call
   and a replay of its graph), ``bn_relu_apply`` 33; one training-mode
   ``pure_fn`` and ``torch.autograd.grad`` over its parameter values:
   the aux bitwise the running statistics one eager training forward of
   a copy of the net writes, the gradients within
   ``SURFACE_GRAD_LIMIT`` norm-wise of that copy's ``autograd.record()``
   backward, ``bn_relu_apply`` and ``bn_relu_bwd`` 33 each, and every
   parameter of the net bitwise as it was.  (b) The eval ``pure_fn``
   captured into one CUDA graph (``_capture.GraphOwner``) and replayed 3
   times, each replay bitwise the eager ``pure_fn``, ``bn_relu_apply``
   33 x 4 counted through the replays.  (c) ``bert_base(vocab_size=
   30522, max_length=512, dropout=0.1)`` at 8 x 128: the eval
   ``pure_fn`` bitwise ``net(ids)``, ``flash_attention_fwd`` 12 and
   ``layernorm_fwd`` 26; one training call (dropout drawn from a
   seeded ``torch.Generator``) and ``grad``: flash fwd and bwd 12 each.
   (d) ``mx.gpu(0).memory_info()`` is the allocator's bytes and the
   card's total, ``empty_cache()`` lowers the reserved bytes after a
   1 GiB temporary is freed, and ``analysis.hbm_plan(fn=, args=)`` on
   (a)'s eval forward at b32 (probe 4x, b128) predicts the peak at b64
   within ``SURFACE_HBM_LIMIT`` of the peak measured there.  It prints
   "surface (...)" lines and its seconds; the kernels line carries
   ``launches_surface`` by part.

The ImageNet records of phase 15 are written from the run's start in a
CPU-only worker process (:class:`HostWorker`, on the upper half of the
cpus); the input phase waits for them before its window.  A worker that
raises, dies or misses its bound fails the run, naming the job.

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
optimizer state).  Phases 1-15, 19, 20, 22 and 23, phase 21's inference
and op families and phase 24's (a) and (b) (in its child world) run
under ``_capture.checking_syncs()``: every
capture and replay runs under ``torch.cuda.set_sync_debug_mode(
"error")``, so a host read left inside a captured region fails it.

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
MNIST_EPOCH_BATCHES = 156         # a third of the 468-batch epoch
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


def mnist_main_path(ctx=None, epoch_batches=MNIST_EPOCH_BATCHES,
                    hybrid_batches=MNIST_HYBRID_BATCHES,
                    memorise_steps=MNIST_MEMORISE_STEPS,
                    profiled=MNIST_PROFILED_BATCHES):
    """``epoch_batches`` of the example's loop unhybridized (0: the
    whole epoch, 468 batches of 128), then ``hybrid_batches``
    hybridized, on ``ctx`` (the card by
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
        "card": gpu_line() if device != "cpu" else None})
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
        phase_done("bert_bf16:%s" % key)
    release_cuda()
    out["oracle"] = bert_bf16_oracle(arrays, prefix)
    del arrays
    release_cuda()
    phase_done("bert_bf16:oracle")
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
    phase_done("pretrain:main")
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


def layernorm_inputs(rows, dim, dtype, gen, misalign=False):
    """``(rows, dim)`` rows of ``dtype`` and fp32 gamma and beta; with
    ``misalign``, x is a contiguous view one element into a flat buffer,
    so its data pointer is not 16-byte aligned."""
    import torch
    x = (torch.randn(rows, dim, generator=gen, device="cuda") * 3 + 1) \
        .to(dtype)
    if misalign:
        flat = torch.empty(rows * dim + 1, dtype=dtype, device="cuda")
        flat[1:].copy_(x.reshape(-1))
        x = flat[1:].view(rows, dim)
    g = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    return x, g, b


def layernorm_check(rows, dim, dtype, gen, misalign=False):
    """The LayerNorm kernel against its plain version: the largest
    error relative to the largest output, on the route the launcher
    takes for these rows."""
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference,
                                                   layernorm_route)
    x, g, b = layernorm_inputs(rows, dim, dtype, gen, misalign)
    err = rel_err(layernorm_fwd_cuda(x, g, b), layernorm_reference(x, g, b))
    key = str(dtype).split(".")[-1]
    what = "(%d, %d) %s%s" % (rows, dim, key,
                              " misaligned" if misalign else "")
    print("layernorm %s, %s route: rel err %.3g (limit %g)"
          % (what, layernorm_route(x, g, b), err, ROW_TOL[key]))
    check(err <= ROW_TOL[key], "layernorm %s: %.3g > %g"
          % (what, err, ROW_TOL[key]))
    return err


def layernorm_bound(rows, dim, itemsize):
    """The least time of a LayerNorm forward: the rows read and written
    once and the two fp32 vectors read once at 3.35 TB/s, against 8
    fp32 operations an element; (ms, "bytes" or "operations", bytes)."""
    nbytes = 2 * rows * dim * itemsize + 2 * dim * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * rows * dim / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def layernorm_times(rows, dim, dtype, gen):
    """Times of the LayerNorm kernel, its plain version and
    ``F.layer_norm`` on ``(rows, dim)`` rows of ``dtype`` (fp32 gamma and
    beta, as the layers hold them), with the bound, the kernel's share
    of it and the route it took."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_reference,
                                                   layernorm_route)
    x = torch.randn(rows, dim, generator=gen, device="cuda").to(dtype)
    g = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    t = {"ms": time_ms(lambda: layernorm_fwd_cuda(x, g, b)),
         "plain_ms": time_ms(lambda: layernorm_reference(x, g, b)),
         "library_ms": time_ms(lambda: F.layer_norm(
             x, (dim,), g.to(dtype), b.to(dtype)))}
    t["bound_ms"], t["bound_by"], nbytes = layernorm_bound(
        rows, dim, x.element_size())
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    t["route"] = layernorm_route(x, g, b)
    print("layernorm times (%d, %d) %s, %s route: %s (%d bytes at 3.35 "
          "TB/s); %.1f%% of the bound; library = F.layer_norm"
          % (rows, dim, str(dtype).split(".")[-1], t["route"],
             json.dumps(t), nbytes, 100 * t["share_of_bound"]))
    return t


def layernorm_kernel_phase(rows, dim):
    """The LayerNorm kernel against its plain version at the BERT rows,
    at a width that is no whole number of packs, on misaligned rows and
    above the register route's cap (the generic route), both dtypes;
    then its fp32 times at the BERT rows."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    for r, c, misalign in ((rows, dim, False), (1000, 100, False),
                           (4099, dim, True), (257, 12288, False)):
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            errs[key] = max(errs.get(key, 0.0),
                            layernorm_check(r, c, dtype, gen, misalign))
    t = layernorm_times(rows, dim, torch.float32, gen)
    return dict(t, max_abs_err=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"])


LAYERNORM_SHAPES = ((32768, 768, "float32"), (32768, 768, "bfloat16"),
                    (16384, 768, "float32"))


def layernorm_routes(shapes=LAYERNORM_SHAPES):
    """The LayerNorm kernel's two routes on the same rows, in turns
    (ring, generic, generic, ring): the ring on x as allocated, the
    generic route on a copy of x one element into a flat buffer (a
    misaligned pointer, what sends a caller there), beside the bound
    and a yardstick of what the card reaches moving the same rows
    (``Tensor.copy_`` of x into another tensor, one read and one
    write): what a misaligned caller pays, and how far from the
    memory's reach the ring is."""
    import torch
    from mxnet_tpu_torch.kernels.layernorm import (layernorm_fwd_cuda,
                                                   layernorm_route)
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for rows, dim, dtype in shapes:
        x, g, b = layernorm_inputs(rows, dim, getattr(torch, dtype), gen)
        xm = layernorm_inputs(rows, dim, getattr(torch, dtype), gen,
                              misalign=True)[0]
        on = {layernorm_route(x, g, b): x, layernorm_route(xm, g, b): xm}
        check(sorted(on) == ["generic", "ring"], "layernorm routes %dx%d "
              "%s: took %s" % (rows, dim, dtype, sorted(on)))

        def run(route):
            return lambda: layernorm_fwd_cuda(on[route], g, b)
        order = ("ring", "generic", "generic", "ring")
        times = [(r, time_ms(run(r))) for r in order]
        t = {r: [ms for name, ms in times if name == r]
             for r in ("ring", "generic")}
        t["bound_ms"] = layernorm_bound(rows, dim, x.element_size())[0]
        y = torch.empty_like(x)
        t["copy_ms"] = time_ms(lambda: y.copy_(x))
        key = "%dx%d %s" % (rows, dim, dtype)
        out[key] = t
        print("layernorm routes %s: %s" % (key, json.dumps(t)))
    return out


def layernorm_phase():
    """The LayerNorm kernel alone: its checks and fp32 times at the BERT
    rows, its bf16 BERT shapes and its two routes against each other."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    return {"kernel": layernorm_kernel_phase(BERT_BATCH * BERT_SEQ, 768),
            "bf16_path": {str(d).split(".")[-1]: layernorm_times(
                32768, 768, d, gen) for d in (torch.float32, torch.bfloat16)},
            "routes": layernorm_routes()}


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
    phase_done("densenet:main")
    oracle = train_oracle(net, make_net=densenet121_nhwc,
                          label="DenseNet-121 oracle (card vs CPU)",
                          floor_factor=DENSENET_FLOOR_FACTOR)
    del net
    release_cuda()
    phase_done("densenet:oracle")
    loop = densenet_imperative_path()
    release_cuda()
    phase_done("densenet:loop")
    kernels = densenet_kernel_checks()
    release_cuda()
    phase_done("densenet:kernels")
    zoo = zoo_sweep()
    phase_done("densenet:zoo")
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
INPUT_RECORDS = 4096
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
JPEG_RECORDS = 1024
JPEG_QUALITY = 90
JPEG_THREAD_SWEEP = (1, 2, 4, 8)
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


def write_input_records(root, records=INPUT_RECORDS, image=INPUT_IMAGE,
                        source=INPUT_SOURCE, jpeg_records=JPEG_RECORDS):
    """The ImageNet input phase's records under ``root``: ``records`` raw
    ``image``-square crops and, where a codec imports, ``jpeg_records``
    JPEGs of the ``source``-square images: ``{"raw", "raw_s", "jpg",
    "jpg_s"}`` (paths, seconds; ``jpg`` None without a codec).  Host
    work alone: the run writes them in the host worker from its
    start."""
    codecs = codec_versions()
    t0 = time.perf_counter()
    out = {"raw": make_records(os.path.join(root, "raw"), records,
                               crop=image, hw=source)}
    out["raw_s"] = time.perf_counter() - t0
    out["jpg"] = out["jpg_s"] = None
    if codecs["cv2"] or codecs["PIL"]:
        t0 = time.perf_counter()
        out["jpg"] = make_records(os.path.join(root, "jpg"), jpeg_records,
                                  fmt="jpg", hw=source)
        out["jpg_s"] = time.perf_counter() - t0
    return out


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


def jpeg_path(rec, write_s, step, batch, image, records, sweep, ctx):
    """The ``records`` JPEG records at ``rec`` (``source``-square, quality
    90, written in ``write_s``) read through the same iterator with
    ``rand_crop=True``: host img/s at each thread count of ``sweep``,
    then one streamed pass of ``steps`` steps into ``step``."""
    import torch
    import mxnet_tpu_torch as mx
    cuda = ctx.device_type == "gpu"
    out = {"records": records, "write_s": write_s,
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
                         sites=BN_RELU_SITES, ctx=None, root=INPUT_ROOT,
                         written=None):
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
    skipped (the CPU rehearsal).  ``written``, when given, returns
    ``(directory, write_input_records's value)`` for records written
    elsewhere (the host worker), waiting for them; the phase removes
    the directory at its end."""
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
    tmp = None
    if written is None:
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="imagenet-input-", dir=root)
        here = tmp
        written = lambda: (here, write_input_records(
            here, records, image, source, jpeg_records))
    try:
        t0 = time.perf_counter()
        tmp, files = written()
        wait_s = time.perf_counter() - t0
        rec, write_s = files["raw"], files["raw_s"]
        phase_done("imagenet_input:records")
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
                 "write_s": write_s, "records_wait_s": wait_s,
                 "batch": batch, "epochs": epochs,
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
        phase_done("imagenet_input:streamed")
        out["parts"] = input_parts(rec, batch, image, threads, sweep,
                                   sweep_batches, cuda)
        print("ImageNet input parts (each alone; records just "
              "written): %s" % json.dumps(dict(out["parts"], card=gpu_line()
                                             if cuda else None)))
        out["landed"] = landed_batch_check(rec, batch, image, threads, ctx)
        print("ImageNet input landed batch vs host batch: %s"
              % json.dumps(out["landed"]))
        phase_done("imagenet_input:parts")
        if files["jpg"] is not None:
            out["jpeg"] = jpeg_path(files["jpg"], files["jpg_s"], step,
                                    batch, image, jpeg_records, jpeg_sweep,
                                    ctx)
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
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def mnist_feed_path(host_stats=None, ctx=None,
                    batches=MNIST_EPOCH_BATCHES):
    """The MNIST loop of ``mnist_main_path`` through the DataLoader's
    device-feed route: ``DataLoader(..., ctx=mx.gpu(0))`` lands each
    batch on the card (no ``as_in_context`` copy left in the loop),
    ``batches`` of a fresh net, unhybridized.  Prints samples/s and the
    feed's overlap share beside the host route's from ``host_stats``,
    and the loader's own pace over as many more batches with no
    training."""
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
        net, trainer, loss_fn, loader, ctx, batches)
    n = len(losses)
    check(n == batches and all(np.isfinite(losses)),
          "MNIST feed route: %d batches, losses %s" % (n, losses[-3:]))
    feed = loader._feed
    # the loader alone, no training: the producer's own pace
    t0 = time.perf_counter()
    alone = 0
    for data, _label in loader:
        alone += 1
        if alone == batches:
            break
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
# one more replay traced: late in a long process the tracer may drop a
# replay's records anywhere in the trace, not only before its start
# (the lead-in); the counted replays are the complete ones
OPS_PROFILER_SPARE = 1
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


def complete_replays(replays):
    """Of the kernel counts of replays of one graph, the one with the
    most kernel events (the complete replay: a replay whose records the
    tracer dropped holds fewer, and only fewer) and every replay equal
    to it."""
    full = max(replays, key=lambda k: sum(k.values()), default={})
    return full, [k for k in replays if k == full]


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
    more replays and one spare, after one lead-in replay, and dumps its
    Chrome trace; its device events, grouped by graph launch, are
    searched for the three kernels inside the replayed graph.  At least
    ``trace_replays`` replays after the lead-in must agree kernel for
    kernel (they are counted); every other replay may only lack kernels
    (the tracer drops records it timestamps before the trace's start,
    and late in a long process some inside it), and what each replay
    holds is in ``trace_per_replay``.  Saves the reports under
    ``report_dir``."""
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
                for _ in range(1 + trace_replays + OPS_PROFILER_SPARE):
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
        full, complete = complete_replays(
            [r["kernels"] for r in replays[1:]])
        counted = complete[:trace_replays]

        def hand(kernels):
            return {n: sum(c for k, c in kernels.items() if g in k)
                    for n, g in OPS_KERNELS.items()}
        found = {n: sum(hand(k)[n] for k in counted) for n in OPS_KERNELS}
        out["trace"] = trace
        out["trace_device_kernel_events"] = sum(
            1 for e in events if e.get("cat") in ("kernel", "gpu_kernel"))
        out["trace_per_replay"] = [
            {"lead_in": i == 0, "complete": i > 0 and r["kernels"] == full,
             "kernel_events": sum(r["kernels"].values()),
             "hand_kernel_events": hand(r["kernels"]),
             "launch_to_first_kernel_us": r["launch_to_first_kernel_us"]}
            for i, r in enumerate(replays)]
        out["trace_hand_kernel_events"] = found
        out["graph_kernels_in_trace"] = all(found.values())
        out["cachedop_ranges"] = sum(
            1 for e in events if e.get("name", "").startswith("mx.cachedop"))
        traced = 1 + trace_replays + OPS_PROFILER_SPARE
        print("mx.profiler dumps() over %d replays:\n%s" % (traced, dumps))
        if cuda:
            check(len(replays) == traced,
                  "the profiler trace holds %d graph launches, want a "
                  "lead-in and %d more" % (len(replays), traced - 1))
            check(out["graph_kernels_in_trace"],
                  "the profiler trace of %d replays names the hand "
                  "kernels %s: CUPTI reported no kernel of the replayed "
                  "graph" % (trace_replays, found))
            check(len(complete) >= trace_replays,
                  "fewer than %d of the %d replays after the lead-in "
                  "agree kernel for kernel: %s"
                  % (trace_replays, traced - 1, out["trace_per_replay"]))
            check(all(c <= full[k] for r in replays
                      for k, c in r["kernels"].items()),
                  "a replay holds kernel events the complete replays "
                  "lack: %s" % out["trace_per_replay"])
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


# ---------------------------------------------------------------------
# phase 19: the symbolic front end and recurrent nets
# ---------------------------------------------------------------------

# (a) examples/module_mnist.py at its widths
MODULE_MNIST_SAMPLES = 2048
MODULE_MNIST_EVAL = 512
MODULE_MNIST_BATCH = 128
MODULE_MNIST_EPOCHS = 2
# the JAX example's validation accuracy on the CPU over the same batches
# from the same initial weights (module_mnist_run with mxnet_tpu; tests/
# test_torch_module.py reads it again), and the margin the card may lose
MODULE_MNIST_JAX_ACCURACY = 0.8046875
MODULE_MNIST_MARGIN = 0.02
SYM_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "symbolic-smoke")
# (b) upstream example/rnn/bucketing/cudnn_lstm_bucketing.py's defaults
LM_VOCAB = 10000
LSTM_EMBED = 200
LSTM_HIDDEN = 200
LSTM_LAYERS = 2
LSTM_BUCKETS = (10, 20, 30, 40, 50, 60)
LSTM_BATCH = 32
LSTM_BATCHES_PER_BUCKET = 3       # an epoch: 3 batches of each bucket
LSTM_EPOCHS = 2                   # every bucket trains 6 times
# (c) upstream example/gluon/word_language_model/train.py's defaults
WLM_EMBED = 650
WLM_HIDDEN = 650
WLM_LAYERS = 2
WLM_DROPOUT = 0.5
WLM_BPTT = 35
WLM_BATCH = 32
WLM_LR = 20.0
WLM_CLIP = 0.25
WLM_STEPS = 30
SYM_PROFILED_STEPS = 5
SYM_ORACLE_BATCH = 4
SYM_ORACLE_BUCKETS = (10, 60)
# card against CPU, one step at full width (fp32, TF32 off): the loss
# relative, each gradient norm-wise; a measured permuted-batch floor
# (two CPU runs summing in another order) larger than these sets 4x it
SYM_LOSS_LIMIT = 1e-5
SYM_GRAD_LIMIT = 1e-4
SYM_FLOOR_FACTOR = 4.0


def zipf_tokens(n, seed, vocab=LM_VOCAB):
    """``n`` token ids drawn from a Zipf law over ``vocab`` ids (the
    k-th most frequent id with probability proportional to 1/k), as the
    words of a text corpus fall."""
    p = 1.0 / np.arange(1, vocab + 1)
    return np.random.RandomState(seed).choice(vocab, size=n, p=p / p.sum()) \
        .astype(np.float32)


def module_mnist_symbol(sym):
    """``examples/module_mnist.py``'s MLP: 784-128-64-10."""
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")


def module_mnist_data(n, seed):
    """``examples/module_mnist.py :: synthetic_mnist``."""
    centers = np.random.RandomState(42).randn(10, 784).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = centers[y] + 0.3 * rng.randn(n, 784).astype(np.float32)
    return x, y.astype(np.float32)


class _StepClock:
    """A batch-end callback keeping each batch's end time and the
    running value of the metric."""

    def __init__(self):
        self.t, self.values = [], []

    def __call__(self, param):
        self.t.append((param.epoch, time.perf_counter()))
        self.values.append((param.epoch, param.eval_metric.get()[1]))

    def step_ms(self, epoch):
        ts = [t for e, t in self.t if e == epoch]
        return 1e3 * float(np.median(np.diff(ts))) if len(ts) > 1 else None


def _busy_share(run, steps, wall_ms):
    """Under ``torch.profiler`` over ``steps`` calls of ``run()``: the
    device's busy ms a step, its idle share against ``wall_ms`` (the
    unprofiled step) and the five largest device events (name, ms a
    step, count a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    check(busy > 0, "the profiler saw no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "top_device_events": [[e.key[:60],
                                   e.self_device_time_total / 1e3 / steps,
                                   e.count / steps] for e in top]}


def _graph_totals(stats, mode):
    return {"graphs": sum(s.get(mode, {}).get("graphs", 0)
                          for s in stats.values()),
            "replays": sum(s.get(mode, {}).get("replays", 0)
                           for s in stats.values())}


def _no_launches(label):
    from mxnet_tpu_torch.kernels import registry
    launches = {k: registry.launches(k) for k in registry.list_kernels()}
    check(not any(launches.values()),
          "%s launched hand kernels: %s" % (label, launches))
    return launches


def module_mnist_run(mx, ctx, batch_end_callback=None,
                     epoch_end_callback=None, epochs=MODULE_MNIST_EPOCHS):
    """``examples/module_mnist.py``'s loop with package ``mx`` (this
    port's or the JAX package's: the calls are the same) on ``ctx``:
    ``Module.fit`` of the MLP over 2,048 synthetic samples, batch 128,
    shuffled, SGD 0.1/0.9, an eval set of 512.  The batch order comes
    from numpy's seed 0 and the initial weights from a seeded numpy draw
    of the example's ``Uniform(0.01)`` (biases 0), so both packages run
    the same loop.  Returns ``(module, eval iterator)``."""
    np.random.seed(0)
    x, y = module_mnist_data(MODULE_MNIST_SAMPLES, 0)
    train = mx.io.NDArrayIter(x, y, MODULE_MNIST_BATCH, shuffle=True)
    val = mx.io.NDArrayIter(*module_mnist_data(MODULE_MNIST_EVAL, 1),
                            batch_size=MODULE_MNIST_BATCH)
    symbol = module_mnist_symbol(mx.sym)
    shapes, _, _ = symbol.infer_shape(data=(MODULE_MNIST_BATCH, 784))
    rng = np.random.RandomState(0)
    init = {n: mx.nd.array(np.zeros(s, np.float32) if n.endswith("bias")
                           else rng.uniform(-0.01, 0.01, s)
                           .astype(np.float32), ctx=mx.cpu())
            for n, s in zip(symbol.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    mod = mx.mod.Module(symbol, context=ctx)
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            eval_metric="acc", arg_params=init,
            batch_end_callback=batch_end_callback,
            epoch_end_callback=epoch_end_callback, num_epoch=epochs)
    return mod, val


def module_fit_path(ctx=None, root=SYM_ROOT, epochs=MODULE_MNIST_EPOCHS):
    """(a) ``examples/module_mnist.py``'s loop (:func:`module_mnist_run`)
    with ``Speedometer(128, 10)`` and ``do_checkpoint``; then
    ``Module.load`` of the last epoch scores the eval set equal to the
    live module, and the validation accuracy reaches the JAX example's
    on the CPU from the same weights and batches, less 0.02."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.kernels import registry
    ctx = ctx or mx.gpu(0)
    cuda = ctx.device_type == "gpu"
    os.makedirs(root, exist_ok=True)
    prefix = os.path.join(root, "mnist_module")
    clock = _StepClock()
    speed = mx.callback.Speedometer(MODULE_MNIST_BATCH, 10)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    mod, val = module_mnist_run(
        mx, ctx, batch_end_callback=[clock, speed],
        epoch_end_callback=mx.callback.do_checkpoint(prefix), epochs=epochs)
    wall = time.perf_counter() - t0
    launches = _no_launches("module fit")
    score = mod.score(val, mx.metric.Accuracy())
    acc = score[0][1]
    check(all(np.isfinite(v) for _, v in clock.values),
          "module fit: non-finite metric %s" % clock.values[-3:])
    for e in range(epochs):
        check(os.path.exists("%s-%04d.params" % (prefix, e + 1)),
              "module fit: do_checkpoint wrote no epoch %d" % (e + 1))
    loaded = mx.mod.Module.load(prefix, epochs, context=ctx)
    loaded.bind(data_shapes=val.provide_data, label_shapes=val.provide_label,
                for_training=False)
    loaded.init_params()
    reloaded = loaded.score(val, mx.metric.Accuracy())
    check(reloaded == score, "module fit: Module.load scores %s, the live "
          "module %s" % (reloaded, score))
    out_live = mod.predict(val).asnumpy()
    out_loaded = loaded.predict(val).asnumpy()
    floor = MODULE_MNIST_JAX_ACCURACY - MODULE_MNIST_MARGIN
    check(acc >= floor, "module fit: validation accuracy %.4f under %.4f "
          "(the JAX example's %.4f less %.2f)"
          % (acc, floor, MODULE_MNIST_JAX_ACCURACY, MODULE_MNIST_MARGIN))
    n = len(clock.t)
    stats = {"epochs": epochs, "batches": n, "batch": MODULE_MNIST_BATCH,
             "samples_per_s": n * MODULE_MNIST_BATCH / wall,
             "speedometer_samples_per_s": speed.last_speed,
             "ms_per_step": clock.step_ms(epochs - 1),
             "validation_accuracy": acc, "reloaded_accuracy": reloaded[0][1],
             "jax_cpu_accuracy": MODULE_MNIST_JAX_ACCURACY,
             "reloaded_max_abs_diff": float(np.abs(out_live
                                                   - out_loaded).max()),
             "hand_kernel_launches": launches}
    if cuda:
        cs = mod._exec.capture_stats()
        stats.update(train=_graph_totals({0: cs}, "train"),
                     eval=_graph_totals({0: cs}, "eval"),
                     peak_mem_bytes=torch.cuda.max_memory_allocated())
        check(stats["train"]["graphs"] == 1
              and stats["train"]["replays"] == n - 1,
              "module fit: train graphs %s over %d batches"
              % (stats["train"], n))
        val.reset()
        batch = next(iter(val))

        def step():
            mod.forward_backward(batch)
            mod.update()
        stats.update(_busy_share(step, SYM_PROFILED_STEPS,
                                 stats["ms_per_step"]))
        stats["card"] = gpu_line()
    print("module fit (examples/module_mnist.py: 784-128-64-10, batch 128, "
          "SGD 0.1/0.9, 2 epochs): %s" % json.dumps(stats))
    return stats


def lstm_lm_sym_gen(sym, batch, vocab=LM_VOCAB, embed=LSTM_EMBED,
                    hidden=LSTM_HIDDEN, layers=LSTM_LAYERS):
    """The graph of upstream ``cudnn_lstm_bucketing.py`` a bucket:
    ``Embedding`` -> time-major fused ``RNN`` (lstm) -> ``FullyConnected``
    -> ``SoftmaxOutput`` over every token; zero initial states."""
    from mxnet_tpu_torch.ops.nn import rnn_param_size
    n_params = rnn_param_size("lstm", embed, hidden, layers, False)

    def sym_gen(seq_len):
        data = sym.var("data")
        label = sym.var("softmax_label")
        emb = sym.Embedding(data, input_dim=vocab, output_dim=embed,
                            name="embed")
        rnn = sym.RNN(sym.swapaxes(emb, dim1=0, dim2=1),
                      sym.var("lstm_parameters", shape=(n_params,)),
                      sym._zeros(shape=(layers, batch, hidden)),
                      sym._zeros(shape=(layers, batch, hidden)),
                      state_size=hidden, num_layers=layers, mode="lstm",
                      name="lstm")
        out = sym.Reshape(sym.swapaxes(rnn[0], dim1=0, dim2=1),
                          shape=(-1, hidden))
        pred = sym.FullyConnected(out, num_hidden=vocab, name="pred")
        return (sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                  name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


class _BucketBatches:
    """An iterator of bucketed LM batches (``bucket_key`` = sequence
    length), each bucket ``per_bucket`` times an epoch in a shuffled
    order, over a Zipf token stream; the label is the next token."""

    def __init__(self, mx, buckets, batch, per_bucket, seed,
                 vocab=LM_VOCAB):
        self.mx, self.batch, self.seed = mx, batch, seed
        rng = np.random.RandomState(seed)
        self.keys = [k for k in buckets for _ in range(per_bucket)]
        rng.shuffle(self.keys)
        need = sum(batch * (k + 1) for k in self.keys)
        self.stream = zipf_tokens(need, seed, vocab)
        self.default_bucket_key = max(buckets)
        self.provide_data = [mx.io.DataDesc("data", (batch, max(buckets)))]
        self.provide_label = [mx.io.DataDesc("softmax_label",
                                             (batch, max(buckets)))]
        self.reset()

    def reset(self):
        self.pos, self.i = 0, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.keys):
            raise StopIteration
        k = self.keys[self.i]
        n = self.batch * (k + 1)
        seqs = self.stream[self.pos:self.pos + n].reshape(self.batch, k + 1)
        self.pos += n
        self.i += 1
        mx = self.mx
        b = mx.io.DataBatch(
            data=[mx.nd.array(seqs[:, :-1], ctx=mx.cpu())],
            label=[mx.nd.array(seqs[:, 1:], ctx=mx.cpu())],
            provide_data=[mx.io.DataDesc("data", (self.batch, k))],
            provide_label=[mx.io.DataDesc("softmax_label", (self.batch, k))])
        b.bucket_key = k
        return b


def lstm_lm_init(mx):
    """Upstream's initializer: Xavier (in, magnitude 2.34) on the
    weight matrices, uniform on the fused RNN's flat parameters."""
    return mx.init.Mixed(["lstm_parameters", ".*"],
                         [mx.init.Uniform(0.1),
                          mx.init.Xavier(factor_type="in", magnitude=2.34)])


def bucketing_lstm_path(ctx=None, buckets=LSTM_BUCKETS, batch=LSTM_BATCH,
                        per_bucket=LSTM_BATCHES_PER_BUCKET,
                        epochs=LSTM_EPOCHS, widths=None):
    """(b) MXNet's bucketing LSTM language model through
    ``BucketingModule.fit``: buckets 10-60 at batch 32, SGD lr 0.01,
    momentum 0, wd 1e-5; every bucket trains ``per_bucket`` x ``epochs``
    times.  Checks: every running perplexity finite, the last epoch's
    under the first's, one train graph a bucket, replays = the bucket's
    batches less its one eager call, and every bucket's executor
    reading the one set of shared weights."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.kernels import registry
    ctx = ctx or mx.gpu(0)
    cuda = ctx.device_type == "gpu"
    widths = widths or {}
    mx.random.seed(0)
    torch.manual_seed(0)
    vocab = widths.get("vocab", LM_VOCAB)
    train = _BucketBatches(mx, buckets, batch, per_bucket, seed=0,
                           vocab=vocab)
    mod = mx.mod.BucketingModule(lstm_lm_sym_gen(mx.sym, batch, **widths),
                                 default_bucket_key=max(buckets),
                                 context=ctx)
    clock = _StepClock()
    metric = mx.metric.Perplexity(ignore_label=None)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=metric, batch_end_callback=clock,
            optimizer="sgd", initializer=lstm_lm_init(mx),
            optimizer_params={"learning_rate": 0.01, "momentum": 0.0,
                              "wd": 1e-5},
            num_epoch=epochs)
    wall = time.perf_counter() - t0
    launches = _no_launches("bucketing LSTM")
    values = clock.values
    check(all(np.isfinite(v) for _, v in values),
          "bucketing LSTM: non-finite perplexity %s" % values)
    per_epoch = [[v for e, v in values if e == k][-1] for k in range(epochs)]
    check(per_epoch[-1] < per_epoch[0],
          "bucketing LSTM: perplexity %s did not fall" % per_epoch)
    tokens = sum(batch * k for k in train.keys) * epochs
    stats = {"buckets": list(buckets), "batch": batch,
             "batches": len(clock.t), "tokens_per_s": tokens / wall,
             "ms_per_step": 1e3 * wall / len(clock.t),
             "perplexity_per_epoch": per_epoch,
             "hand_kernel_launches": launches}
    weights = [m._exec.arg_dict["lstm_parameters"] for m in
               mod._buckets.values()]
    check(all(w._data.data_ptr() == weights[0]._data.data_ptr()
              and np.array_equal(w.asnumpy(), weights[0].asnumpy())
              for w in weights),
          "bucketing LSTM: the buckets' weights differ")
    if cuda:
        cs = mod.capture_stats()
        counts = {k: train.keys.count(k) * epochs for k in buckets}
        per_key = {k: cs[k]["train"] for k in buckets}
        for k in buckets:
            check(per_key[k]["graphs"] == 1
                  and per_key[k]["replays"] == counts[k] - 1,
                  "bucketing LSTM: bucket %d graphs %s over %d batches"
                  % (k, per_key[k], counts[k]))
        stats.update(train=_graph_totals(cs, "train"),
                     train_per_bucket={k: [v["graphs"], v["replays"]]
                                       for k, v in per_key.items()},
                     peak_mem_bytes=torch.cuda.max_memory_allocated())
        b = next(iter(_BucketBatches(mx, (max(buckets),), batch, 1, 9,
                                     vocab)))

        def step():
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        # the largest bucket's steps, unprofiled then profiled
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SYM_PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
        wall_top = 1e3 * (time.perf_counter() - t1) / SYM_PROFILED_STEPS
        top = stats["bucket_%d" % max(buckets)] = dict(
            ms_per_step=wall_top,
            **_busy_share(step, SYM_PROFILED_STEPS, wall_top))
        stats["device_idle_share"] = top["device_idle_share"]
        stats["card"] = gpu_line()
    print("bucketing LSTM (cudnn_lstm_bucketing.py: vocab %d, embed %d, "
          "hidden %d x %d layers, buckets %s, batch %d, SGD 0.01): %s"
          % (vocab, widths.get("embed", LSTM_EMBED),
             widths.get("hidden", LSTM_HIDDEN),
             widths.get("layers", LSTM_LAYERS), list(buckets), batch,
             json.dumps(stats)))
    return stats


def word_lm_model(gluon, vocab=LM_VOCAB, embed=WLM_EMBED, hidden=WLM_HIDDEN,
                  layers=WLM_LAYERS, dropout=WLM_DROPOUT):
    """Upstream ``example/gluon/word_language_model/model.py``'s
    ``RNNModel`` (LSTM, untied): ``(ids (T, N), h, c) -> (logits (T*N,
    vocab), h, c)``."""
    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(vocab, embed)
                self.rnn = gluon.rnn.LSTM(hidden, num_layers=layers,
                                          dropout=dropout, input_size=embed)
                self.decoder = gluon.nn.Dense(vocab, in_units=hidden)

        def hybrid_forward(self, F, inputs, h, c):
            emb = self.drop(self.encoder(inputs))
            output, (h, c) = self.rnn(emb, [h, c])
            output = self.drop(output)
            return self.decoder(output.reshape((-1, hidden))), h, c
    return RNNModel()


def clip_global_norm(mx, grads, max_norm):
    """The example's ``clip_global_norm`` in ``mx.nd`` ops, on the
    device: every gradient scaled by ``min(1, max_norm / norm)``."""
    total = mx.nd.sqrt(mx.nd.add_n(*[mx.nd.sum(g * g) for g in grads]))
    scale = mx.nd.clip(max_norm / (total + 1e-8), 0.0, 1.0)
    for g in grads:
        g[:] = mx.nd.broadcast_mul(g, scale)
    return total


def word_lm_path(ctx=None, steps=WLM_STEPS, widths=None, batch=WLM_BATCH,
                 bptt=WLM_BPTT):
    """(c) the Gluon word language model: the net hybridized, the loop
    ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` averaged over
    the batch's tokens -> ``backward`` -> the global-norm clip at 0.25
    -> ``Trainer("sgd", lr=20).step(1)``, the hidden state carried
    across batches and detached between them (upstream ``train.py``).  Checks: losses finite, the last under the
    first; two replays of one captured training call on one batch give
    different outputs (a new dropout mask each), eval mode equal ones."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.kernels import registry
    ctx = ctx or mx.gpu(0)
    cuda = ctx.device_type == "gpu"
    widths = widths or {}
    mx.random.seed(0)
    torch.manual_seed(0)
    net = word_lm_model(gluon, **widths)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    hidden = widths.get("hidden", WLM_HIDDEN)
    layers = widths.get("layers", WLM_LAYERS)
    vocab = widths.get("vocab", LM_VOCAB)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": WLM_LR, "momentum": 0.0,
                             "wd": 0.0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    stream = zipf_tokens((steps + 2) * bptt * batch + 1, seed=1,
                         vocab=vocab)
    ids = mx.nd.array(stream[:-1].reshape(batch, -1).T, ctx=ctx)
    nxt = mx.nd.array(stream[1:].reshape(batch, -1).T, ctx=ctx)
    h = mx.nd.zeros((layers, batch, hidden), ctx=ctx)
    c = mx.nd.zeros((layers, batch, hidden), ctx=ctx)
    losses, stamps = [], []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        data = ids[i * bptt:(i + 1) * bptt]
        target = nxt[i * bptt:(i + 1) * bptt]
        h, c = h.detach(), c.detach()
        with autograd.record():
            out, h, c = net(data, h, c)
            loss = loss_fn(out, target.reshape((-1,))).mean()
        loss.backward()
        clip_global_norm(mx, [p.grad() for p in params], WLM_CLIP)
        trainer.step(1)
        losses.append(loss)
        stamps.append(time.perf_counter())
    losses = [float(v.asscalar()) for v in losses]
    wall = time.perf_counter() - t0
    launches = _no_launches("word LM")
    check(all(np.isfinite(losses)), "word LM: non-finite loss %s"
          % losses[-3:])
    check(losses[-1] < losses[0], "word LM: loss %.4f -> %.4f did not fall"
          % (losses[0], losses[-1]))
    # one captured training call replayed twice on one batch: a new
    # dropout mask each replay; eval mode twice: the same output
    data, target = ids[:bptt], nxt[:bptt]
    outs = []
    for _ in range(2):
        with autograd.record():
            out, _h, _c = net(data, h.detach(), c.detach())
            loss = loss_fn(out, target.reshape((-1,)))
        loss.backward()
        outs.append(out.asnumpy())
    check(not np.array_equal(outs[0], outs[1]),
          "word LM: two training replays drew the same dropout mask")
    evals = [net(data, h.detach(), c.detach())[0].asnumpy()
             for _ in range(3)]
    check(np.array_equal(evals[1], evals[2]),
          "word LM: eval mode gave different outputs")
    stats = {"steps": steps, "bptt": bptt, "batch": batch,
             "tokens_per_s": steps * bptt * batch / wall,
             "ms_per_step": 1e3 * float(np.median(np.diff(stamps))),
             "loss_first": losses[0], "loss_last": losses[-1],
             "hand_kernel_launches": launches}
    if cuda:
        cache = net.cache_stats()
        owner = next(iter(cache["graphs"].values()))
        stats.update(graphs=owner["graphs"], replays=owner["replays"],
                     keys=len(cache["keys"]),
                     peak_mem_bytes=torch.cuda.max_memory_allocated())
        check(owner["graphs"] >= 2 and owner["replays"] >= steps - 1,
              "word LM: graphs %s" % owner)

        def step():
            with autograd.record():
                o, _h, _c = net(data, h.detach(), c.detach())
                lo = loss_fn(o, target.reshape((-1,))).mean()
            lo.backward()
            clip_global_norm(mx, [p.grad() for p in params], WLM_CLIP)
            trainer.step(1)
        stats.update(_busy_share(step, SYM_PROFILED_STEPS,
                                 stats["ms_per_step"]))
        stats["card"] = gpu_line()
    print("word LM (example/gluon/word_language_model: vocab %d, LSTM %d x "
          "%d layers, dropout %.1f, bptt %d, batch %d, SGD lr %g, clip "
          "%g): %s" % (vocab, hidden, layers, WLM_DROPOUT, bptt, batch,
                       WLM_LR, WLM_CLIP, json.dumps(stats)))
    return stats


def _array_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _hold(label, dists, floors, limit):
    """Each distance within ``limit``, or within ``SYM_FLOOR_FACTOR``
    times its measured floor where that is larger."""
    worst = {}
    for k, d in dists.items():
        bound = max(limit, SYM_FLOOR_FACTOR * floors[k])
        worst[k] = [d, floors[k], bound]
        check(d <= bound, "%s: %s %.3g > %.3g (floor %.3g)"
              % (label, k, d, bound, floors[k]))
    return worst


def _lstm_oracle_step(mx, ctx, seq_len, arrays, data, label, widths):
    """One training forward and backward of the bucketing LM's graph at
    ``seq_len``: the mean token cross-entropy and every gradient."""
    batch = data.shape[0]
    symbol = lstm_lm_sym_gen(mx.sym, batch, **widths)(seq_len)[0]
    mod = mx.mod.Module(symbol, context=ctx)
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", label.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in arrays.items()})
    b = mx.io.DataBatch(data=[mx.nd.array(data, ctx=mx.cpu())],
                        label=[mx.nd.array(label, ctx=mx.cpu())])
    mod.forward(b, is_train=True)
    mod.backward()
    prob = mod.get_outputs()[0].asnumpy().astype(np.float64)
    lab = label.reshape(-1).astype(np.int64)
    loss = float(-np.log(prob[np.arange(lab.size), lab]).mean())
    grads = {k: mod._exec.grad_dict[k].asnumpy() for k in arrays}
    return loss, grads


def symbolic_oracles(ctx=None, batch=SYM_ORACLE_BATCH,
                     keys=SYM_ORACLE_BUCKETS, lstm_widths=None,
                     wlm_widths=None):
    """Card against CPU, one step each at the paths' full widths, batch
    4: (b) at two bucket keys, (c) with dropout 0.  The loss within
    1e-5 relative and each gradient within 1e-4 norm-wise, or 4x the
    fp32 floor (the CPU step over the batch permuted, against the CPU
    step) where that is larger."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    ctx = ctx or mx.gpu(0)
    out = {}
    rng = np.random.RandomState(5)
    torch.manual_seed(0)
    lstm_widths = lstm_widths or {}
    symbol = lstm_lm_sym_gen(mx.sym, batch, **lstm_widths)(max(keys))[0]
    shapes, _, _ = symbol.infer_shape(data=(batch, max(keys)),
                                      softmax_label=(batch, max(keys)))
    arrays = {n: (0.1 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(symbol.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    vocab = lstm_widths.get("vocab", LM_VOCAB)
    perm = np.roll(np.arange(batch), 1)
    for k in keys:
        stream = zipf_tokens(batch * (k + 1), seed=10 + k, vocab=vocab) \
            .reshape(batch, k + 1)
        data, label = stream[:, :-1], stream[:, 1:]
        lc, gc_ = _lstm_oracle_step(mx, mx.cpu(), k, arrays, data, label,
                                    lstm_widths)
        lp, gp = _lstm_oracle_step(mx, mx.cpu(), k, arrays, data[perm],
                                   label[perm], lstm_widths)
        lg, gg = _lstm_oracle_step(mx, ctx, k, arrays, data, label,
                                   lstm_widths)
        dists = {"loss": abs(lg - lc) / abs(lc)}
        floors = {"loss": abs(lp - lc) / abs(lc)}
        out["bucketing LSTM bucket %d loss" % k] = _hold(
            "bucketing LSTM oracle (bucket %d)" % k, dists, floors,
            SYM_LOSS_LIMIT)
        out["bucketing LSTM bucket %d gradients" % k] = _hold(
            "bucketing LSTM oracle (bucket %d)" % k,
            {n: _array_rel(gg[n], gc_[n]) for n in arrays},
            {n: _array_rel(gp[n], gc_[n]) for n in arrays}, SYM_GRAD_LIMIT)
    # (c): one step of the word LM, dropout 0
    wlm = dict(wlm_widths or {}, dropout=0.0)
    nets = {}
    for where, c in (("cpu", mx.cpu()), ("card", ctx)):
        mx.random.seed(0)
        nets[where] = word_lm_model(gluon, **wlm)
        nets[where].initialize(ctx=c)
    src = nets["cpu"]
    for i, p in enumerate(src.collect_params().values()):
        p.set_data(mx.nd.array((0.05 * np.random.RandomState(100 + i).randn(
            *p.shape)).astype(np.float32), ctx=mx.cpu()))
    for a, b in zip(src.collect_params().values(),
                    nets["card"].collect_params().values()):
        b.set_data(mx.nd.array(a.data().asnumpy(), ctx=ctx))
    hidden = wlm.get("hidden", WLM_HIDDEN)
    layers = wlm.get("layers", WLM_LAYERS)
    wvocab = wlm.get("vocab", LM_VOCAB)
    stream = zipf_tokens(WLM_BPTT * batch + 1, seed=33, vocab=wvocab)
    ids = stream[:-1].reshape(batch, -1).T
    nxt = stream[1:].reshape(batch, -1).T
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def wlm_step(net, c, cols):
        x = mx.nd.array(ids[:, cols], ctx=c)
        y = mx.nd.array(nxt[:, cols], ctx=c)
        z = mx.nd.zeros((layers, batch, hidden), ctx=c)
        with autograd.record():
            o, _h, _c = net(x, z, z)
            lo = loss_fn(o, y.reshape((-1,)))
        lo.backward()
        return float(lo.mean().asscalar()), [
            p.grad().asnumpy() for p in net.collect_params().values()]

    lc, gc_ = wlm_step(nets["cpu"], mx.cpu(), np.arange(batch))
    lp, gp = wlm_step(nets["cpu"], mx.cpu(), perm)
    lg, gg = wlm_step(nets["card"], ctx, np.arange(batch))
    names = [n[len(src.prefix):] for n in src.collect_params()]
    out["word LM loss"] = _hold("word LM oracle",
                                {"loss": abs(lg - lc) / abs(lc)},
                                {"loss": abs(lp - lc) / abs(lc)},
                                SYM_LOSS_LIMIT)
    out["word LM gradients"] = _hold(
        "word LM oracle",
        {n: _array_rel(g, w) for n, g, w in zip(names, gg, gc_)},
        {n: _array_rel(p, w) for n, p, w in zip(names, gp, gc_)},
        SYM_GRAD_LIMIT)
    for k, v in out.items():
        print("symbolic oracle, %s (card vs CPU, batch %d, fp32, TF32 off; "
              "[distance, permuted floor, bound]): %s"
              % (k, batch, json.dumps(v)))
    return out


def symbolic_phase(root=SYM_ROOT):
    """Phase 19: (a) ``Module.fit``, (b) the bucketing LSTM, (c) the
    word LM, then the oracles; the checkpoints under ``root`` are
    removed at the end."""
    t0 = time.perf_counter()
    try:
        out = {"module_fit": module_fit_path(root=root)}
        release_cuda()
        out["bucketing_lstm"] = bucketing_lstm_path()
        release_cuda()
        out["word_lm"] = word_lm_path()
        release_cuda()
        out["oracles"] = symbolic_oracles()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {path: out[path]["hand_kernel_launches"]
                       for path in ("module_fit", "bucketing_lstm",
                                    "word_lm")}
    out["phase_s"] = time.perf_counter() - t0
    print("symbolic phase: %.1f s" % out["phase_s"])
    return out


# ---------------------------------------------------------------------
# phase 20: deployment -- export, SymbolBlock, Module, Predictor, the
# .mxa archive, the registry's graph sources, ONNX and the C predict ABI
# ---------------------------------------------------------------------

DEPLOY_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "deploy-smoke")
DEPLOY_BATCH = 32
DEPLOY_CPU_BATCH = 8
DEPLOY_FORWARDS = 4                # counted forwards of a route
DEPLOY_REQUESTS = 256
DEPLOY_CLIENTS = 8
DEPLOY_ONNX_REQUESTS = 32
DEPLOY_ONNX_BUCKETS = (1, 4, 8)
DEPLOY_PREDICTOR_BATCHES = (1, 8, 32)
# two routes running the same kernels in the same order on the same
# inputs (the live net and its exported graph, a replay and an eager
# call): their logits agree to the last bits, relative to the largest
DEPLOY_SAME_TOL = 1e-5
# the card against the CPU, a served answer against a batch-1 forward,
# an ONNX runtime against the card: fp32 summed in other orders
DEPLOY_REL_TOL = SERVE_REL_TOL
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def resnet50_nchw():
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    return resnet50_v1()


def _np(a):
    """An NDArray, a tensor or an array as float64 numpy."""
    a = getattr(a, "_data", a)
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _max_rel(got, want):
    """``max |got - want|`` relative to ``max |want|``; the shapes must
    agree and ``got`` be finite."""
    got, want = _np(got), _np(want)
    check(got.shape == want.shape and np.isfinite(got).all(),
          "output of shape %s (finite: %s), want %s"
          % (got.shape, bool(np.isfinite(got).all()), want.shape))
    return float(np.abs(got - want).max() / np.abs(want).max())


def deploy_net(make_net, image, channels_last, device, seed=0):
    """A net of random weights from ``seed`` whose running statistics
    and BatchNorm scales are off their defaults (running mean 0 and
    variance 1 would hide a swapped or missing aux state): two
    training-mode forwards, then a seeded draw of every gamma and
    beta."""
    import torch
    from mxnet_tpu_torch import autograd
    net = make_net()
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    shape = (8, image, image, 3) if channels_last else (8, 3, image, image)
    with torch.no_grad():
        for _ in range(2):
            with autograd.train_mode():
                net(torch.randn(shape, generator=gen, device=device))
        draw = torch.Generator().manual_seed(seed + 2)
        for p in net.collect_params().values():
            if p.name.endswith("_gamma"):
                p.set_data(torch.rand(p.shape, generator=draw) + 0.5)
            elif p.name.endswith("_beta"):
                p.set_data(0.1 * torch.randn(p.shape, generator=draw))
    return net


def _graph_ops(sym_file):
    """The exported graph's op counts, and the BatchNorm nodes that feed
    a relu ``Activation`` directly (a pair the graph did not fuse)."""
    from collections import Counter
    with open(sym_file) as f:
        nodes = json.load(f)["nodes"]
    unfused = [n["name"] for n in nodes
               if n["op"] == "Activation"
               and n["attrs"].get("act_type") == "relu"
               and nodes[n["inputs"][0][0]]["op"] == "BatchNorm"]
    return Counter(n["op"] for n in nodes), unfused


def _route_launches(kernels, run):
    """``run()`` with every launch counter zeroed first; the counts of
    ``kernels`` after it, by name."""
    from mxnet_tpu_torch.kernels import registry
    registry.reset_launches()
    out = run()
    return out, {k: registry.launches(k) for k in kernels}


def _repeat(fn, n):
    def run():
        out = None
        for _ in range(n):
            out = fn()
        return out
    return run


def _cpu_model():
    """The host CPU's model name (``/proc/cpuinfo``) and core count."""
    import platform
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return "%s, %s, %d cores" % (name, platform.machine(), os.cpu_count())


_COMPILED_CHILD = r"""
import gc, json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture
from mxnet_tpu_torch.gluon import Block
from mxnet_tpu_torch.kernels import registry
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ctx = mx.cpu() if sys.argv[5] == "cpu" else mx.gpu(0)
x = np.load(sys.argv[3])
with _capture.checking_syncs():
    t0 = time.perf_counter()
    cp = mx.CompiledPredictor(sys.argv[2], ctx=ctx)
    load_s = time.perf_counter() - t0
    registry.reset_launches()
    for _ in range(int(sys.argv[6])):
        y = cp(x)[0]
    launches = {k: registry.launches(k) for k in registry.list_kernels()}
blocks = sorted({type(o).__name__ for o in gc.get_objects()
                 if isinstance(o, Block)})
np.save(sys.argv[4], y.asnumpy())
print(json.dumps({"load_s": load_s, "launches": launches,
                  "blocks": blocks, "meta": cp.meta,
                  "graphs": cp._owner.graphs}))
"""


def deploy_graph_route(net, x, root, image, cpu_batch, sites, device,
                       fused_nodes=BN_RELU_SITES, forwards=DEPLOY_FORWARDS):
    """Step 1: the channels-last net hybridized, exported and run back
    through ``SymbolBlock``, ``optimize_for`` and an inference
    ``Module``; the card against the CPU."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import registry
    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    kernels = registry.list_kernels()
    net.hybridize()
    with torch.no_grad():
        for _ in range(3):              # eager, capture, replay
            live = net(x)
    prefix = os.path.join(root, "resnet50-nhwc")
    t0 = time.perf_counter()
    sym_file, params_file = net.export(prefix)
    export_s = time.perf_counter() - t0
    ops, unfused = _graph_ops(sym_file)
    check(ops["fused_batch_norm_relu"] == fused_nodes,
          "exported graph holds %d fused_batch_norm_relu nodes, want %d"
          % (ops["fused_batch_norm_relu"], fused_nodes))
    check(not unfused, "BatchNorm directly followed by a relu in the "
          "exported graph: %s" % unfused[:3])
    out = {"export_s": export_s, "json_bytes": os.path.getsize(sym_file),
           "params_bytes": os.path.getsize(params_file),
           "graph_ops": dict(ops)}

    # SymbolBlock on the card, hybridized
    t0 = time.perf_counter()
    sb = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                      ctx=ctx)
    out["imports_s"] = time.perf_counter() - t0
    sb.hybridize()
    with torch.no_grad():
        for _ in range(2):
            sb(x)
        got, counts = _route_launches(kernels,
                                      _repeat(lambda: sb(x), forwards))
    out["symbol_block_rel_err"] = _max_rel(got, live)
    check(out["symbol_block_rel_err"] <= DEPLOY_SAME_TOL,
          "SymbolBlock logits differ from the live net's by %.3g"
          % out["symbol_block_rel_err"])
    launches = {"symbol_block": counts}
    check(counts["bn_relu_apply"] == sites * forwards,
          "SymbolBlock: bn_relu_apply %d launches != %d sites x %d "
          "forwards" % (counts["bn_relu_apply"], sites, forwards))
    if cuda:
        stats = sb.cache_stats()["graphs"]
        out["symbol_block_graphs"] = {d: {k: s[k] for k in (
            "graphs", "capture_s", "pool_bytes", "replays")}
            for d, s in stats.items()}

    # optimize_for: hybridize and call, the eager call of a fresh key
    with torch.no_grad():
        opt = net.optimize_for(x)
    out["optimize_for_rel_err"] = _max_rel(opt, live)
    out["optimize_for_bitwise"] = bool(torch.equal(opt.cpu(), live.cpu()))
    check(out["optimize_for_rel_err"] <= DEPLOY_SAME_TOL,
          "optimize_for differs from the hybridized call by %.3g"
          % out["optimize_for_rel_err"])

    # the exported files as a checkpoint of an inference Module
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=(),
                        context=ctx)
    mod.bind(data_shapes=[("data", tuple(x.shape))], for_training=False)
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    batch = mx.io.DataBatch(data=[mx.NDArray(x)])

    def module_forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]

    for _ in range(2):
        module_forward()
    got, counts = _route_launches(kernels, _repeat(module_forward,
                                                   forwards))
    out["module_rel_err"] = _max_rel(got, live)
    check(out["module_rel_err"] <= DEPLOY_SAME_TOL,
          "Module logits differ from the live net's by %.3g"
          % out["module_rel_err"])
    check(counts["bn_relu_apply"] == sites * forwards,
          "Module: bn_relu_apply %d launches != %d sites x %d forwards"
          % (counts["bn_relu_apply"], sites, forwards))
    launches["module"] = counts
    del mod

    # the card against the CPU on the same files at the smaller batch
    xs = x[:cpu_batch]
    with torch.no_grad():
        for _ in range(2):
            dev = sb(xs)
        with mx.cpu():
            host = mx.gluon.SymbolBlock.imports(
                sym_file, ["data"], params_file, ctx=mx.cpu())
            t0 = time.perf_counter()
            ref = host(xs.cpu())
            out["cpu_forward_s"] = time.perf_counter() - t0
    out["card_vs_cpu_rel_err"] = _max_rel(dev, ref)
    check(out["card_vs_cpu_rel_err"] <= DEPLOY_REL_TOL,
          "the card's SymbolBlock differs from the CPU's by %.3g > %g"
          % (out["card_vs_cpu_rel_err"], DEPLOY_REL_TOL))
    return sb, live, sym_file, params_file, out, launches


def deploy_registry_route(net, sb, sym_file, params_file, image, buckets,
                          requests, clients, sites, device):
    """Step 2: ``register(symbol=, params=)`` served by concurrent
    clients beside a ``block=`` servable of the live net."""
    import torch
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import ModelRegistry, ServableClosed
    rng = np.random.RandomState(20)
    images = rng.standard_normal(
        (requests, image, image, 3)).astype(np.float32)
    reg = ModelRegistry()
    out = {}
    try:
        for source in ("symbol", "block"):
            t0 = time.perf_counter()
            if source == "symbol":
                sv = reg.register("resnet50-" + source, symbol=sym_file,
                                  params=params_file,
                                  input_shape=(image, image, 3),
                                  buckets=buckets)
            else:
                sv = reg.register("resnet50-" + source, block=net,
                                  input_shape=(image, image, 3),
                                  buckets=buckets)
            register_s = time.perf_counter() - t0
            check(sv.source == source, "servable source %r, want %r"
                  % (sv.source, source))
            registry.reset_launches()
            responses, lat, wall = _serve(
                sv, images, _client_bursts(rng, requests, clients))
            stats = sv.stats()
            launches = {k: registry.launches(k)
                        for k in registry.list_kernels()}
            reg.unregister(sv.name, drain=True)
            check(sv.closed and sv.stats() == stats,
                  "%s servable answered after its drain" % source)
            try:
                sv.submit(images[0])
            except ServableClosed:
                pass
            else:
                raise SmokeFailure("a closed servable took a request")
            check(stats.get("responses") == requests
                  and stats.get("errors", 0) == 0,
                  "%s servable counts %s for %d requests"
                  % (source, stats, requests))
            check(launches["bn_relu_apply"] == sites * stats["batches"],
                  "%s servable: bn_relu_apply %d launches != %d sites x "
                  "%d executor calls" % (source, launches["bn_relu_apply"],
                                         sites, stats["batches"]))
            out[source] = {
                "register_s": register_s,
                "requests_per_s": requests / wall,
                "latency_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "latency_p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "batches": stats["batches"], "launches": launches}
            if source == "symbol":
                worst = 0.0
                with torch.no_grad():
                    for img, got in zip(images, responses):
                        want = sb(torch.from_numpy(img[None]).to(device))
                        worst = max(worst, _max_rel(got, want[0]))
                out[source]["max_rel_err"] = worst
                check(worst <= DEPLOY_REL_TOL,
                      "symbol servable differs from the SymbolBlock's "
                      "batch-1 forward by %.3g > %g" % (worst,
                                                        DEPLOY_REL_TOL))
    finally:
        reg.shutdown(drain=False)
    return out


def deploy_predictor_route(net, sym_file, params_file, x, root, sites,
                           device, forwards=DEPLOY_FORWARDS,
                           batches=DEPLOY_PREDICTOR_BATCHES):
    """Step 3: ``mx.Predictor`` over three shape classes with room for
    two, then ``export_compiled``: returns the numbers, the launches and
    the archive's job for a ``CompiledPredictor`` child
    (:func:`start_compiled_child`), the archive's input and the live
    net's logits for it saved beside it."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.kernels import registry
    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    kernels = registry.list_kernels()
    with torch.no_grad():
        wants = {b: net(x[:b]) for b in batches}
    was_on = telemetry.enabled()
    telemetry.enable()
    telemetry.reset("serving.")
    out = {}
    try:
        pred = mx.Predictor(sym_file, params_file, ctx=ctx,
                            jit_cache_size=2)
        for b in batches:
            for _ in range(2):           # eager, then captured
                pred.forward(data=x[:b])
        resident = list(pred._jit_cache.values())
        out["resident_classes"] = len(resident)
        out["resident_graphs"] = sum(o.graphs for o in resident)
        out["evictions"] = telemetry.counter(
            "serving.compile_evictions").value
        check(out["resident_classes"] == 2 and out["evictions"] == 1,
              "Predictor LRU: %d classes resident, %d evictions"
              % (out["resident_classes"], out["evictions"]))
        if cuda:
            check(out["resident_graphs"] == 2, "Predictor: %d graphs "
                  "resident, want 2" % out["resident_graphs"])
        b0 = batches[0]
        for _ in range(2):               # the evicted class comes back
            got = pred.forward(data=x[:b0])[0]
        out["recaptured_rel_err"] = _max_rel(got, wants[b0])
        check(out["recaptured_rel_err"] <= DEPLOY_SAME_TOL,
              "Predictor's recaptured class differs by %.3g"
              % out["recaptured_rel_err"])
        b1 = batches[-1]
        got, counts = _route_launches(kernels, _repeat(
            lambda: pred.forward(data=x[:b1])[0], forwards))
        out["rel_err"] = _max_rel(got, wants[b1])
        check(out["rel_err"] <= DEPLOY_SAME_TOL,
              "Predictor differs from the live net by %.3g"
              % out["rel_err"])
        check(counts["bn_relu_apply"] == sites * forwards,
              "Predictor: bn_relu_apply %d launches != %d sites x %d "
              "forwards" % (counts["bn_relu_apply"], sites, forwards))
    finally:
        telemetry.reset("serving.")
        if not was_on:
            telemetry.disable()
    launches = {"predictor": counts}
    del pred

    path = os.path.join(root, "resnet50-nhwc.mxa")
    t0 = time.perf_counter()
    mx.predictor.export_compiled(net, path, [tuple(x.shape)])
    out["mxa_export_s"] = time.perf_counter() - t0
    out["mxa_bytes"] = os.path.getsize(path)
    job = {"path": path, "x": os.path.join(root, "mxa-input.npy"),
           "y": os.path.join(root, "mxa-output.npy"),
           "want": wants[x.shape[0]].cpu().numpy()}
    np.save(job["x"], x.cpu().numpy())
    return out, launches, job


def start_compiled_child(job, device, forwards=DEPLOY_FORWARDS):
    """Serve the ``.mxa`` archive with ``CompiledPredictor`` in a child
    ``python`` that imports no model code (the one block it builds is
    the archive's ``SymbolBlock``; it runs while step 4 serves);
    returns the process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    job["t0"] = time.perf_counter()
    return subprocess.Popen(
        [sys.executable, "-c", _COMPILED_CHILD, REPO_ROOT, job["path"],
         job["x"], job["y"], device, str(forwards)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_compiled_child(proc, job, sites, forwards=DEPLOY_FORWARDS):
    """Wait for the child of :func:`start_compiled_child` and check its
    logits and launches; returns its numbers and every kernel's
    launches as the child counted them."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"mxa_child_s": time.perf_counter() - job["t0"]}
    check(proc.returncode == 0, "CompiledPredictor child failed: %s"
          % stderr[-2000:])
    child = json.loads(stdout.strip().splitlines()[-1])
    check(child["blocks"] == ["SymbolBlock"], "the CompiledPredictor "
          "child built blocks %s, want only the archive's SymbolBlock"
          % child["blocks"])
    out["mxa_rel_err"] = _max_rel(np.load(job["y"]), job["want"])
    check(out["mxa_rel_err"] <= DEPLOY_SAME_TOL,
          "CompiledPredictor differs from the live net by %.3g"
          % out["mxa_rel_err"])
    launches = child["launches"]
    check(launches["bn_relu_apply"] == sites * forwards,
          "CompiledPredictor: bn_relu_apply %d launches != %d sites x %d "
          "forwards" % (launches["bn_relu_apply"], sites, forwards))
    out["mxa_load_s"], out["mxa_graphs"] = child["load_s"], child["graphs"]
    return out, launches


def deploy_onnx_route(make_nchw, channels_last_files, root, image, buckets,
                      requests, clients, device, on_onnx):
    """Step 4: ResNet-50 v1 NCHW exported, converted to ONNX, read back
    and served from the ONNX file; the channels-last graph does not
    convert.  ``on_onnx(onnx_file, image)`` is called once the file and
    the first request's image exist, before the servable registers (it
    starts step 5 on the host).  Returns the card's logits for that
    image (step 5's yardstick) and the numbers."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serving import ModelRegistry
    net = deploy_net(make_nchw, image, False, device, seed=4)
    net.hybridize()
    prefix = os.path.join(root, "resnet50-nchw")
    sym_file, params_file = net.export(prefix)
    ops, _ = _graph_ops(sym_file)
    check(ops["fused_batch_norm_relu"] == 0, "the NCHW graph holds %d "
          "fused nodes" % ops["fused_batch_norm_relu"])
    onnx_file = prefix + ".onnx"
    t0 = time.perf_counter()
    mx.onnx.export_model(sym_file, params_file,
                         in_shapes=[(1, 3, image, image)],
                         in_types=[np.float32], onnx_file_path=onnx_file)
    out = {"onnx_export_s": time.perf_counter() - t0,
           "onnx_bytes": os.path.getsize(onnx_file)}
    meta = mx.onnx.get_model_metadata(onnx_file)
    check(meta["input_tensor_data"] == [("data", (1, 3, image, image))]
          and len(meta["output_tensor_data"]) == 1,
          "ONNX metadata %s" % meta)
    t0 = time.perf_counter()
    sym, arg_params, aux_params = mx.onnx.import_model(onnx_file)
    out["onnx_import_s"] = time.perf_counter() - t0
    out["onnx_params"] = [len(arg_params), len(aux_params)]
    rng = np.random.RandomState(21)
    images = rng.standard_normal(
        (requests, 3, image, image)).astype(np.float32)
    on_onnx(onnx_file, images[:1])
    reg = ModelRegistry()
    try:
        t0 = time.perf_counter()
        sv = reg.register("resnet50-onnx", onnx=onnx_file,
                          input_shape=(3, image, image), buckets=buckets)
        out["register_s"] = time.perf_counter() - t0
        check(sv.source == "onnx", "servable source %r" % sv.source)
        registry.reset_launches()
        responses, lat, wall = _serve(sv, images,
                                      _client_bursts(rng, requests,
                                                     clients))
        out["launches"] = {k: registry.launches(k)
                           for k in registry.list_kernels()}
        out.update(requests_per_s=requests / wall,
                   latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
                   latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
                   batches=sv.stats()["batches"])
    finally:
        reg.shutdown(drain=True)
    worst = 0.0
    with torch.no_grad():
        for img, got in zip(images, responses):
            want = net(torch.from_numpy(img[None]).to(device))[0]
            worst = max(worst, _max_rel(got, want))
        first = net(torch.from_numpy(images[:1]).to(device))
    out["max_rel_err"] = worst
    check(worst <= DEPLOY_REL_TOL, "ONNX servable differs from the live "
          "NCHW net's batch-1 forward by %.3g > %g" % (worst,
                                                       DEPLOY_REL_TOL))
    check(sum(out["launches"].values()) == 0, "the NCHW ONNX route "
          "launched hand kernels: %s" % out["launches"])
    # the channels-last graph has no ONNX form: the JAX package's
    # exporter stops at its first channels-last Convolution, and its
    # fused_batch_norm_relu nodes have no converter either
    cl_sym, cl_params = channels_last_files
    raised = {}
    for what, call in (
            ("channels_last_graph", lambda: mx.onnx.export_model(
                cl_sym, cl_params, in_shapes=[(1, image, image, 3)],
                onnx_file_path=os.path.join(root, "nhwc.onnx"))),
            ("fused_node", lambda: mx.onnx.export_model(
                mx.sym.fused_batch_norm_relu(
                    mx.sym.var("data"), mx.sym.var("gamma"),
                    mx.sym.var("beta"), mx.sym.var("mean"),
                    mx.sym.var("var"), axis=3)[0], {},
                in_shapes=[(1, 4, 4, 8)] + [(8,)] * 4,
                onnx_file_path=os.path.join(root, "fused.onnx")))):
        try:
            call()
        except mx.MXNetError as e:
            raised[what] = str(e)
        else:
            raise SmokeFailure("ONNX export of the %s did not raise" % what)
    check("fused_batch_norm_relu" in raised["fused_node"],
          "the fused node's ONNX error does not name it: %s"
          % raised["fused_node"])
    out["raised"] = raised
    return first, out


def start_native_build(root):
    """Build the C predict runtime and ``examples/cpp_predict/main.cc``
    against it with ``g++``, in a thread, while the card runs steps
    1-3; returns the job, whose ``exe`` (or ``error``) the thread
    sets."""
    job = {"t0": time.perf_counter()}

    def build():
        try:
            from mxnet_tpu_torch import _native
            check(_native.load_predict() is not None,
                  "the native predict runtime did not build")
            so = _native.predict_so_path()
            exe = os.path.join(root, "cpp_predict")
            src = os.path.join(REPO_ROOT, "examples", "cpp_predict",
                               "main.cc")
            proc = subprocess.run(
                ["g++", "-O2", "-std=c++17", src, "-o", exe,
                 "-L%s" % so.parent, "-lmxtpu_predict",
                 "-Wl,-rpath,%s" % so.parent],
                capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, "cpp_predict build failed: %s"
                  % proc.stderr[-2000:])
            job["build_s"] = time.perf_counter() - job["t0"]
            job["exe"] = exe
        except BaseException as e:      # raised by the main thread
            job["error"] = e

    job["thread"] = threading.Thread(target=build, daemon=True)
    job["thread"].start()
    return job


def start_host_runtimes(build, onnx_file, image_arr, image, procs):
    """Step 5 started: the C runtime (``NativePredictor``, in a thread:
    its C call releases the GIL) and the ``cpp_predict`` example (a
    plain process, added to ``procs``) each run one image on the host,
    two cores, while the card serves step 4; returns the job."""
    from mxnet_tpu_torch.predictor import NativePredictor
    build["thread"].join()
    if "error" in build:
        raise build["error"]
    job = {"build_s": build["build_s"], "t0": time.perf_counter()}
    job["example"] = subprocess.Popen(
        [build["exe"], onnx_file, "1", "3", str(image), str(image)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs.append(job["example"])

    def native():
        try:
            pred = NativePredictor(onnx_file)
            t1 = time.perf_counter()
            job["got"] = pred.forward(image_arr)
            job["host_ms"] = 1e3 * (time.perf_counter() - t1)
            pred.close()
        except BaseException as e:      # raised by the main thread
            job["error"] = e

    job["thread"] = threading.Thread(target=native, daemon=True)
    job["thread"].start()
    return job


def finish_host_runtimes(job, card_logits):
    """Step 5 checked: the C runtime's logits against the card's, and
    the example's output line."""
    job["thread"].join(timeout=600)
    stdout, stderr = job["example"].communicate(timeout=600)
    check(not job["thread"].is_alive(), "the native predictor did not "
          "finish in 600 s")
    if "error" in job:
        raise job["error"]
    rel = _max_rel(job["got"], card_logits)
    check(rel <= DEPLOY_REL_TOL, "the native predictor differs from the "
          "card by %.3g > %g" % (rel, DEPLOY_REL_TOL))
    check(job["example"].returncode == 0
          and "output shape: (1, 1000)" in stdout,
          "cpp_predict: rc %s, stdout %r, stderr %r"
          % (job["example"].returncode, stdout[-300:], stderr[-300:]))
    return {"native_rel_err": rel,
            "native_host_ms_per_image": job["host_ms"],
            "cpu_model": _cpu_model(), "build_s": job["build_s"],
            "host_runtimes_s": time.perf_counter() - job["t0"],
            "cpp_predict_output": stdout.strip().splitlines()[0]}


def deploy_phase(make_net=resnet50_nhwc, make_nchw=resnet50_nchw,
                 image=224, batch=DEPLOY_BATCH, cpu_batch=DEPLOY_CPU_BATCH,
                 buckets=SERVE_BUCKETS, requests=DEPLOY_REQUESTS,
                 clients=DEPLOY_CLIENTS, onnx_buckets=DEPLOY_ONNX_BUCKETS,
                 onnx_requests=DEPLOY_ONNX_REQUESTS, sites=BN_RELU_SITES,
                 fused_nodes=BN_RELU_SITES,
                 predictor_batches=DEPLOY_PREDICTOR_BATCHES, device="cuda",
                 root=DEPLOY_ROOT):
    """Phase 20: the deployment path (see the module docstring); the
    files under ``root`` are removed at the end.  ``fused_nodes`` is
    the exported graph's ``fused_batch_norm_relu`` count, ``sites`` the
    ``bn_relu_apply`` launches a forward (0 on the CPU, where the plain
    version counts none).  Returns the numbers and, by route, every
    kernel's launches."""
    import torch
    cuda = device == "cuda"
    t0 = time.perf_counter()
    card = gpu_line() if cuda else None
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    procs = []                          # stopped at the end, come what may
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        build = start_native_build(root)
        net = deploy_net(make_net, image, True, device)
        x = torch.randn((batch, image, image, 3), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(3))
        sb, _live, sym_file, params_file, graph, launches = \
            deploy_graph_route(net, x, root, image, cpu_batch, sites,
                               device, fused_nodes)
        print("deploy graph route (ResNet-50 v1 NHWC fp32, b%d): %s"
              % (batch, json.dumps(dict(graph, card=card))))
        serving = deploy_registry_route(net, sb, sym_file, params_file,
                                        image, buckets, requests, clients,
                                        sites, device)
        launches["registry_symbol"] = serving["symbol"].pop("launches")
        launches["registry_block"] = serving["block"].pop("launches")
        print("deploy registry from the files (%d requests, %d clients): "
              "%s" % (requests, clients,
                      json.dumps(dict(serving, card=card))))
        pred, more, job = deploy_predictor_route(
            net, sym_file, params_file, x, root, sites, device,
            batches=predictor_batches)
        launches.update(more)
        del sb, net, x
        release_cuda()
        # the archive's child (its own process: a python that builds no
        # block) loads while step 4 runs here; its forwards are counted,
        # not timed
        child = start_compiled_child(job, device)
        procs.append(child)
        host = []
        first, onnx = deploy_onnx_route(
            make_nchw, (sym_file, params_file), root, image, onnx_buckets,
            onnx_requests, min(clients, 4), device,
            lambda f, img: host.append(start_host_runtimes(
                build, f, img, image, procs)))
        launches["registry_onnx"] = onnx.pop("launches")
        print("deploy ONNX route (ResNet-50 v1 NCHW fp32; served beside "
              "the C runtime on two host cores and the .mxa child): %s"
              % json.dumps(dict(onnx, card=card)))
        peak = torch.cuda.max_memory_allocated() if cuda else None
        native = finish_host_runtimes(host[0], first)
        more, launches["compiled_predictor"] = finish_compiled_child(
            child, job, sites)
        pred.update(more)
        print("deploy Predictor and CompiledPredictor: %s"
              % json.dumps(dict(pred, card=card)))
        print("deploy native predictor on the host (one image beside the "
              "ONNX servable): %s" % json.dumps(dict(native, card=card)))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    stray = {route: {k: n for k, n in counts.items()
                     if n and k != "bn_relu_apply"}
             for route, counts in launches.items()}
    check(not any(stray.values()), "the deployment routes launched other "
          "kernels: %s" % stray)
    out = {"graph": graph, "serving": serving, "predictor": pred,
           "onnx": onnx, "native": native, "launches": launches,
           "peak_mem_bytes": peak, "phase_s": time.perf_counter() - t0}
    print("deploy phase: %.1f s, peak memory %s B (%s)"
          % (out["phase_s"], peak, card))
    return out


# ---------------------------------------------------------------------
# phase 21: sparse storage and the contrib op families
# ---------------------------------------------------------------------
# upstream example/sparse/linear_classification on Avazu: 1,000,000
# hashed features, 15 nonzeros a row; ids from a seeded Zipf(1.2)
SPARSE_FEATURES = 1_000_000
SPARSE_BATCH = 8192
SPARSE_NNZ = 15
SPARSE_ZIPF = 1.2
SPARSE_STEPS = 100
SPARSE_LR = 0.1
SPARSE_ORACLE_STEPS = 3
SPARSE_ORACLE_TOL = 1e-5
# card-vs-CPU limit of the three AdaGrad steps: the card sums each id's
# gradient over up to 8,192 rows with fp32 atomics in no fixed order, so
# it is held to the larger of SPARSE_ORACLE_TOL and SPARSE_FLOOR_FACTOR x
# the largest distance of the CPU's steps from the same steps with each
# batch's rows permuted (SPARSE_FLOOR_PERMS permutations, measured in the
# run: 7.1e-6-1.05e-5 on the history on the CPU); a control with one
# id's gradient dropped from one step on the CPU side must fail it
SPARSE_FLOOR_PERMS = 4
SPARSE_FLOOR_FACTOR = 4.0
# example/quantization imagenet_gen_qsym.py -> imagenet_inference.py
QUANT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "contrib-smoke")
QUANT_BATCH = 32
QUANT_CALIB_BATCHES = 5
QUANT_CPU_IMAGES = 4
QUANT_TOP1_IMAGES = 256
QUANT_CONVS = 52                   # ResNet-50 v1's convolutions but the stem
QUANT_LOGIT_TOL = 1e-4             # of the CPU run's largest logit
QUANT_FLOOR_FACTOR = 4.0           # x the CPU's one-ulp-input spread
# (c): the op families at user widths, card against the port's CPU run
LINALG_BATCH, LINALG_N = 64, 256
BERT_QKV = (512, 8, 12, 64)        # seq, batch, heads, head dim
ENCDEC_QLEN = 128
NMS_SHAPE = (8, 6000, 6)
ROI_MAP = (2, 1024, 38, 50)
ROI_PER_IMAGE = 128
ROI_POOLED = (14, 14)
ROI_CPU_ROIS = 16                  # the ROIs also run on the CPU
LSTM_SCAN = (35, 32, 650)          # steps, batch, hidden
WHILE_ITERS = 64
CONTRIB_TOL = 1e-4
LINALG_EIG_TOL = 1e-3
# the card, then the CPU run it is held against ("cpu", "cpu" rehearses
# part (c) on the CPU alone)
CONTRIB_DEVICES = ("cuda", "cpu")


def _host_syncs(run):
    """``run()`` with PyTorch's sync debug mode warning at every call that
    waits for the card; returns its result and the warnings' count."""
    import warnings
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def sparse_logreg_data(steps, batch=SPARSE_BATCH, features=SPARSE_FEATURES,
                       nnz=SPARSE_NNZ, seed=0):
    """``steps`` CSR batches of ids drawn from Zipf(1.2) (capped at the
    feature count), values 1, and labels drawn from a planted weight
    vector; made on the host in bulk.  Each batch is ``(data, indices,
    indptr, labels, unique ids)``."""
    rng = np.random.default_rng(seed)
    planted = rng.standard_normal(features).astype(np.float32) * 0.5
    ids = np.minimum(rng.zipf(SPARSE_ZIPF, (steps, batch, nnz)) - 1,
                     features - 1).astype(np.int32)
    ids.sort(axis=-1)
    indptr = np.arange(0, batch * nnz + 1, nnz, dtype=np.int32)
    data = np.ones(batch * nnz, np.float32)
    z = planted[ids].sum(-1) - 0.25
    labels = (rng.random((steps, batch)) < 1 / (1 + np.exp(-z))) \
        .astype(np.float32)
    return [(data, ids[s].reshape(-1), indptr, labels[s].reshape(-1, 1),
             np.unique(ids[s])) for s in range(steps)], planted


def sparse_logreg_permuted(batches, seed):
    """``batches`` with each batch's rows (ids and labels) in a seeded
    random order: the same steps, summed in another order."""
    rng = np.random.default_rng(seed)
    out = []
    for data, idx, indptr, labels, uniq in batches:
        n = len(labels)
        p = rng.permutation(n)
        out.append((data, idx.reshape(n, -1)[p].reshape(-1), indptr,
                    labels[p], uniq))
    return out


def sparse_logreg_steps(batches, ctx, opt, w0, seed=0, drop=None):
    """The training loop of ``example/sparse/linear_classification``
    through the port's entry points on ``ctx``: a ``local`` kvstore
    holding the weight table and the bias under ``opt``, each step
    ``row_sparse_pull`` of the batch's rows into a dense weight, the
    logistic loss through ``sparse.dot``, the gradient at the batch's ids
    pushed as a ``RowSparseNDArray`` (the bias's dense).  ``drop=(step,
    id)`` zeroes that id's pushed gradient at that step (a planted
    fault).  Returns the store, the per-step log-losses (on the device)
    and the seconds."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse
    feats = w0.shape[0]
    with ctx:
        kv = mx.kv.create("local")
        kv.init("weight", mx.nd.array(w0))
        kv.init("bias", mx.nd.zeros((1,)))
        kv.set_optimizer(opt)
        w = mx.nd.zeros(w0.shape)
        b = mx.nd.zeros((1,))
        losses = []
        t0 = time.perf_counter()
        for s, (data, idx, indptr, labels, uniq) in enumerate(batches):
            csr = sparse.csr_matrix((data, idx, indptr),
                                    shape=(len(labels), feats), ctx=ctx)
            rows = mx.nd.array(uniq, ctx=ctx)
            kv.row_sparse_pull("weight", out=w, row_ids=rows)
            kv.pull("bias", out=b)
            z = mx.nd.broadcast_add(sparse.dot(csr, w), b)
            y = mx.nd.array(labels, ctx=ctx)
            p = mx.nd.sigmoid(z)
            losses.append(-(y * mx.nd.log(p + 1e-12) + (1 - y)
                            * mx.nd.log(1 - p + 1e-12)).mean())
            dy = p - y
            grad = sparse.dot(csr, dy, transpose_a=True)
            g = grad[rows]
            if drop is not None and s == drop[0]:
                g = g * mx.nd.array((uniq != drop[1]).astype(np.float32)
                                    [:, None], ctx=ctx)
            kv.push("weight", sparse.RowSparseNDArray(
                g, rows, w0.shape, ctx=ctx))
            kv.push("bias", dy.sum(axis=0))
        mx.nd.waitall()
    return kv, losses, time.perf_counter() - t0


def sparse_logreg_oracle(batches, w0, kind, steps, lr=SPARSE_LR,
                         rescale=1.0 / SPARSE_BATCH, eps=1e-7, momentum=0.9):
    """The same updates in float64 numpy: AdaGrad on the live rows
    (``kind="adagrad"``), lazy SGD (``"sgd"``) or SGD with momentum on
    the dense gradient (``"momentum"``).  Returns (weight, history)."""
    w = w0[:, 0].astype(np.float64)
    h = np.zeros_like(w)
    b = hb = 0.0
    for data, idx, indptr, labels, uniq in batches[:steps]:
        n = len(labels)
        rows_of = np.repeat(np.arange(n), np.diff(indptr))
        z = np.bincount(rows_of, weights=data * w[idx], minlength=n) + b
        dy = 1 / (1 + np.exp(-z)) - labels[:, 0]
        g = np.bincount(idx, weights=data * dy[rows_of],
                        minlength=w.shape[0]) * rescale
        gb = dy.sum() * rescale
        if kind == "adagrad":
            h[uniq] += g[uniq] ** 2
            w[uniq] -= lr * g[uniq] / np.sqrt(h[uniq] + eps)
            hb += gb * gb
            b -= lr * gb / np.sqrt(hb + eps)
        elif kind == "sgd":
            w[uniq] -= lr * g[uniq]
            b -= lr * gb
        else:
            h = momentum * h - lr * g
            w += h
            b -= lr * gb
    return w, h


def _rel(got, want, floor=0.0):
    """``max |got - want|`` over ``max |want|`` (or ``floor``, if
    larger)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), floor, 1e-30))


def sparse_cpu_floor(batches, w0, make_opt, cpu, perms=SPARSE_FLOOR_PERMS):
    """The CPU steps' own fp32 noise: the largest distance, of the
    weights and of the history, between the CPU run ``cpu`` (``(w,
    h)``) and the same steps with each batch's rows permuted, over
    ``perms`` seeded permutations."""
    import mxnet_tpu_torch as mx
    floor = {"w": 0.0, "h": 0.0}
    for k in range(perms):
        kv, _, _ = sparse_logreg_steps(
            sparse_logreg_permuted(batches, seed=k + 1), mx.cpu(),
            make_opt(), w0)
        floor["w"] = max(floor["w"], _rel(kv._store["weight"].numpy()[:, 0],
                                          cpu[0]))
        floor["h"] = max(floor["h"], _rel(
            kv._updater.states["weight"].numpy()[:, 0], cpu[1]))
    return floor


def sparse_logreg_part(steps=SPARSE_STEPS, features=SPARSE_FEATURES,
                       batch=SPARSE_BATCH):
    """Part (a): the Avazu-scale sparse logistic regression on the card,
    then its checks (see the module docstring)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import registry
    card = gpu_line()
    batches, _ = sparse_logreg_data(steps, batch, features)
    w0 = (np.random.default_rng(1).standard_normal((features, 1))
          * 0.01).astype(np.float32)
    gpu = mx.gpu(0)

    def adagrad():
        return mx.optimizer.AdaGrad(learning_rate=SPARSE_LR,
                                    rescale_grad=1.0 / batch)
    sparse_logreg_steps(batches[:2], gpu, adagrad(), w0)       # warm-up
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    kv, losses, secs = sparse_logreg_steps(batches, gpu, adagrad(), w0)
    launches = {k: registry.launches(k) for k in registry.list_kernels()}
    peak = torch.cuda.max_memory_allocated()
    _, syncs = _host_syncs(lambda: sparse_logreg_steps(
        batches[:3], gpu, adagrad(), w0))
    losses = np.array([float(v) for v in losses])
    check(np.isfinite(losses).all(), "sparse logreg: a loss is not finite")
    check(losses[-10:].mean() < losses[:10].mean(),
          "sparse logreg: log-loss %.5f over the last 10 steps, %.5f over "
          "the first 10" % (losses[-10:].mean(), losses[:10].mean()))
    w_end = kv._store["weight"].cpu().numpy()
    h_end = kv._updater.states["weight"].cpu().numpy()
    named = np.unique(np.concatenate([bt[4] for bt in batches]))
    cold = np.ones(features, bool)
    cold[named] = False
    check((w_end[cold] == w0[cold]).all(),
          "sparse logreg: a row no batch named moved")
    check((h_end[cold] == 0).all(),
          "sparse logreg: a row no batch named has history")
    # three steps against float64 numpy and against the port on the CPU
    three = batches[:SPARSE_ORACLE_STEPS]
    kv_g, _, _ = sparse_logreg_steps(three, gpu, adagrad(), w0)
    kv_c, _, _ = sparse_logreg_steps(three, mx.cpu(), adagrad(), w0)
    w_o, h_o = sparse_logreg_oracle(three, w0, "adagrad", len(three))
    live = np.unique(np.concatenate([bt[4] for bt in three]))
    got = {"card": (kv_g._store["weight"].cpu().numpy()[:, 0],
                    kv_g._updater.states["weight"].cpu().numpy()[:, 0]),
           "cpu": (kv_c._store["weight"].numpy()[:, 0],
                   kv_c._updater.states["weight"].numpy()[:, 0])}
    errs = {"adagrad_w_vs_oracle": _rel(got["card"][0][live], w_o[live]),
            "adagrad_h_vs_oracle": _rel(got["card"][1][live], h_o[live]),
            "adagrad_w_vs_cpu": _rel(got["card"][0], got["cpu"][0]),
            "adagrad_h_vs_cpu": _rel(got["card"][1], got["cpu"][1])}
    floor = sparse_cpu_floor(three, w0, adagrad, got["cpu"])
    limits = {name: SPARSE_ORACLE_TOL for name in errs}
    for which in ("w", "h"):
        limits["adagrad_%s_vs_cpu" % which] = max(
            SPARSE_ORACLE_TOL, SPARSE_FLOOR_FACTOR * floor[which])
    # the control: the CPU steps with the batch's most frequent id's
    # gradient dropped from the second step must fail the limits
    hot = int(np.bincount(three[1][1]).argmax())
    kv_x, _, _ = sparse_logreg_steps(three, mx.cpu(), adagrad(), w0,
                                     drop=(1, hot))
    control = {"w": _rel(got["card"][0],
                         kv_x._store["weight"].numpy()[:, 0]),
               "h": _rel(got["card"][1],
                         kv_x._updater.states["weight"].numpy()[:, 0])}
    check(any(control[k] > limits["adagrad_%s_vs_cpu" % k]
              for k in control),
          "sparse logreg: the control (id %d's gradient dropped from step "
          "2 on the CPU) is within the card-vs-CPU limits: %s against %s"
          % (hot, control, limits))
    print("contrib (a) card vs CPU: %s" % json.dumps(
        {"floor_cpu_vs_permuted": floor, "limits": limits,
         "ratio_to_floor": {k: errs["adagrad_%s_vs_cpu" % k]
                            / max(floor[k], 1e-30) for k in floor},
         "control_dropped_id": hot, "control_vs_card": control,
         "readings": {k: errs[k] for k in errs if k.endswith("_vs_cpu")},
         "card": card}))
    for kind, mom in (("sgd", 0.0), ("momentum", 0.9)):
        opt = mx.optimizer.SGD(learning_rate=SPARSE_LR, momentum=mom,
                               rescale_grad=1.0 / batch)
        kv_s, _, _ = sparse_logreg_steps(batches[:1], gpu, opt, w0)
        w_s, _ = sparse_logreg_oracle(batches, w0, kind, 1)
        errs["%s_w_vs_oracle" % kind] = _rel(
            kv_s._store["weight"].cpu().numpy()[:, 0], w_s)
        if mom:
            state = kv_s._updater.states["weight"]
            check(tuple(state.shape) == (features, 1),
                  "sparse logreg: the momentum route kept no dense state")
    for name, err in errs.items():
        check(err <= limits.get(name, SPARSE_ORACLE_TOL),
              "sparse logreg: %s %.3g above %g"
              % (name, err, limits.get(name, SPARSE_ORACLE_TOL)))
    rows = np.array([len(bt[4]) for bt in batches])
    out = {"steps_per_s": steps / secs, "samples_per_s": steps * batch / secs,
           "ms_per_step": 1e3 * secs / steps,
           "rows_pulled_per_step": float(rows.mean()),
           "bytes_pulled_per_step": float(rows.mean() * 4),
           "table_bytes": features * 4,
           "pulled_share_of_table": float(rows.mean() / features),
           "host_syncs_per_step": syncs / 3.0,
           "loss_first10": float(losses[:10].mean()),
           "loss_last10": float(losses[-10:].mean()),
           "rows_never_named": int(cold.sum()), "errors": errs,
           "limits": limits, "floor_cpu_vs_permuted": floor,
           "peak_mem_bytes": peak, "card": card}
    print("contrib (a) sparse logistic regression (%d features, batch %d, "
          "%d nnz a row, %d steps; AdaGrad through a local kvstore): %s"
          % (features, batch, SPARSE_NNZ, steps, json.dumps(out)))
    return out, launches


def quant_export(root, image=224, device="cuda"):
    """ResNet-50 v1 NCHW by phase 20's recipe, hybridized, exported and
    loaded back as ``(sym, arg_params, aux_params)``."""
    import mxnet_tpu_torch as mx
    net = deploy_net(resnet50_nchw, image, False, device)
    net.hybridize()
    import torch
    net(torch.zeros((2, 3, image, image), device=device))
    with mx.name.NameManager():
        net.export(os.path.join(root, "resnet50"), 0)
    sym, arg, aux = mx.model.load_checkpoint(os.path.join(root, "resnet50"),
                                             0)
    return net, sym, arg, aux


def _quantized_nodes(sym):
    return [n for n in sym._topo()
            if n.op in ("quantized_conv", "quantized_fully_connected")]


def quant_site_holds(qsym, feeds_cpu, device):
    """Every int8 op of the graph on the card, fed the CPU walk's own
    inputs to it: its int32 accumulator and range against the CPU's,
    bitwise.  Returns the sites held and the card walk's int32 tensors
    that equal the CPU's (its inputs may round to another int8 step)."""
    import torch
    from mxnet_tpu_torch.symbol.symbol import _call_node, _eval_symbol
    internals = qsym.get_internals()
    cpu_vals = _eval_symbol(internals, feeds_cpu)
    index = {(id(n), i): k for k, (n, i) in enumerate(internals._outputs)}
    sites = 0
    for node in _quantized_nodes(qsym):
        args = [cpu_vals[index[(id(s), i)]].to(device)
                for s, i in node.inputs]
        out = _call_node(node, args, False, device)
        for i, o in enumerate(out):
            want = cpu_vals[index[(id(node), i)]]
            check(torch.equal(o.cpu(), want),
                  "int8 ResNet-50: %s output %d on the card differs from "
                  "the CPU's on the same inputs" % (node.name, i))
        sites += 1
    feeds_gpu = {k: v.to(device) for k, v in feeds_cpu.items()}
    card_vals = _eval_symbol(internals, feeds_gpu)
    same = total = 0
    for node in _quantized_nodes(qsym):
        k = index[(id(node), 0)]
        total += 1
        same += bool(torch.equal(card_vals[k].cpu(), cpu_vals[k]))
    return sites, same, total


def quant_part(root=QUANT_ROOT, image=224, batch=QUANT_BATCH,
               device="cuda"):
    """Part (b): post-training int8 quantization of ResNet-50 v1 NCHW as
    ``example/quantization`` runs it (see the module docstring)."""
    import torch
    import mxnet_tpu_torch as mx
    from collections import Counter
    from mxnet_tpu_torch import _capture, gluon
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.kernels import registry
    card = gpu_line()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net, sym, arg, aux = quant_export(root, image, device)
        arg = {k: v.as_in_context(mx.gpu(0)) for k, v in arg.items()}
        aux = {k: v.as_in_context(mx.gpu(0)) for k, v in aux.items()}
        export_s = time.perf_counter() - t0
        stem = [n.name for n in sym._topo() if n.op == "Convolution"][0]
        rng = np.random.default_rng(0)
        calib = [rng.standard_normal((batch, 3, image, image))
                 .astype(np.float32) for _ in range(QUANT_CALIB_BATCHES)]
        t0 = time.perf_counter()
        with mx.gpu(0):
            qsym, qarg, qaux = quantize_model(
                sym, arg, aux, calib_mode="naive", calib_data=calib,
                excluded_sym_names=[stem])
        calib_s = time.perf_counter() - t0
        ops = Counter(n.op for n in qsym._topo() if n.op)
        check(ops["quantized_conv"] == QUANT_CONVS
              and ops["quantized_fully_connected"] == 1
              and ops["Convolution"] == 1,
              "int8 ResNet-50: the graph holds %s" % dict(ops))
        registry.reset_launches()
        with _capture.checking_syncs():
            mod = mx.mod.Module(qsym, data_names=("data",),
                                label_names=None, context=mx.gpu(0))
            mod.bind(data_shapes=[("data", (batch, 3, image, image))],
                     for_training=False)
            mod.set_params(qarg, qaux)
            params = dict(qarg)
            params.update({"aux:" + k: v for k, v in qaux.items()})
            sb = gluon.SymbolBlock(qsym, ["data"], params=params)
            sb.hybridize()
            xs = [torch.from_numpy(rng.standard_normal(
                (batch, 3, image, image)).astype(np.float32)).cuda()
                for _ in range(QUANT_TOP1_IMAGES // batch)]

            def mod_fwd(x):
                mod.forward(mx.io.DataBatch([mx.nd.NDArray(x)]),
                            is_train=False)
                return mod.get_outputs()[0]._data

            with torch.no_grad():
                for _ in range(3):
                    mod_fwd(xs[0])
                    sb(xs[0])
                int8_ms = time_ms(lambda: mod_fwd(xs[0]), iters=20)
                sb_ms = time_ms(lambda: sb(xs[0]), iters=20)
                fp32_ms = time_ms(lambda: net(xs[0]), iters=20)
                logits = [(mod_fwd(x).clone(), sb(x), net(x)) for x in xs]
        launches = {k: registry.launches(k)
                    for k in registry.list_kernels()}
        peak = torch.cuda.max_memory_allocated()
        top1 = float(np.mean(np.concatenate(
            [(q.argmax(1) == f.argmax(1)).cpu().numpy()
             for q, _, f in logits])))
        int8_err = max(_rel(q.cpu(), f.cpu()) for q, _, f in logits)
        sb_err = max(_rel(s.cpu(), q.cpu()) for q, s, _ in logits)
        # the card against the port's CPU run on the same 4 images
        x4 = xs[0][:QUANT_CPU_IMAGES].cpu()
        feeds = {k: v._data.cpu() for k, v in list(qarg.items())
                 + list(qaux.items())}
        feeds["data"] = x4
        from mxnet_tpu_torch.symbol.symbol import _eval_symbol
        cpu_logits = _eval_symbol(qsym, feeds)[0]
        card_logits = logits[0][0][:QUANT_CPU_IMAGES].cpu()
        logit_err = float((card_logits - cpu_logits).abs().max()
                          / cpu_logits.abs().max())
        # what one ulp of the input moves the CPU's own int8 logits by
        nudged = dict(feeds, data=x4 * (1 + 2.0 ** -23))
        floor = float((_eval_symbol(qsym, nudged)[0] - cpu_logits).abs()
                      .max() / cpu_logits.abs().max())
        sites, same, total = quant_site_holds(qsym, feeds, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("int8 ResNet-50 card against CPU: logits %.3g of the largest, "
          "one-ulp input floor %.3g, int32 tensors equal %d of %d, sites "
          "bitwise on the CPU's inputs %d" % (logit_err, floor, same, total,
                                               sites))
    # one ulp anywhere before a quantize_v2 may round an int8 value to
    # the next step, and 52 sites carry it on: the card's float32 layers
    # (the stem, BatchNorm, the residual sums) differ from the CPU's by
    # such ulps, so the logits are held to the CPU's own one-ulp floor
    limit = max(QUANT_LOGIT_TOL, QUANT_FLOOR_FACTOR * floor)
    check(logit_err <= limit,
          "int8 ResNet-50: card logits %.3g of the CPU's largest away "
          "(limit %.3g)" % (logit_err, limit))
    check(sb_err <= 1e-5, "int8 ResNet-50: SymbolBlock %.3g from Module"
          % sb_err)
    out = {"int8_ms_per_batch": int8_ms, "symbolblock_ms_per_batch": sb_ms,
           "fp32_ms_per_batch": fp32_ms, "int8_img_per_s":
           1e3 * batch / int8_ms, "fp32_img_per_s": 1e3 * batch / fp32_ms,
           "int8_vs_fp32_logit_rel_err": int8_err,
           "symbolblock_vs_module_rel_err": sb_err,
           "top1_agreement_int8_fp32": top1,
           "images": len(xs) * batch, "card_vs_cpu_logit_rel_err": logit_err,
           "cpu_one_ulp_input_floor": floor,
           "int8_sites_bitwise_on_cpu_inputs": sites,
           "int32_tensors_equal_in_whole_card_walk": [same, total],
           "graph_ops": {k: ops[k] for k in ("quantized_conv",
                                             "quantized_fully_connected",
                                             "quantize_v2", "dequantize",
                                             "Convolution")},
           "export_s": export_s, "calibration_s": calib_s,
           "peak_mem_bytes": peak, "card": card}
    print("contrib (b) int8 ResNet-50 v1 NCHW (naive calibration, %d "
          "batches of %d, stem excluded; Module and SymbolBlock at b%d): %s"
          % (QUANT_CALIB_BATCHES, batch, batch, json.dumps(out)))
    return out, launches


def _both_devices(fn):
    """``fn(device)`` on the card and on the CPU, each a list of
    tensors; returns the pairs as CPU tensors."""
    card, cpu = ([t.detach().cpu() for t in fn(d)] for d in CONTRIB_DEVICES)
    return list(zip(card, cpu))


def _card_vs_cpu(label, pairs, tol=CONTRIB_TOL, exact=False, floor=0.0):
    """Each (card, CPU) pair within ``tol`` of the CPU's largest value,
    or of ``floor`` if that is larger (or bitwise); returns the largest
    error."""
    errs = []
    for i, (got, want) in enumerate(pairs):
        check(got.shape == want.shape and got.dtype == want.dtype,
              "%s[%d]: %s %s against %s %s" % (
                  label, i, tuple(got.shape), got.dtype, tuple(want.shape),
                  want.dtype))
        if exact:
            check(bool((got == want).all()), "%s[%d]: not bitwise"
                  % (label, i))
            errs.append(0.0)
            continue
        errs.append(_rel(got.double().numpy(), want.double().numpy(),
                         floor))
    bad = [(i, e) for i, e in enumerate(errs) if e > tol]
    check(not bad, "%s: output (index, error) %s above %g; all %s"
          % (label, bad, tol, ["%.2g" % e for e in errs]))
    return max(errs) if errs else 0.0


def _card_ms(fn):
    """Milliseconds of one call after a warm one, the card synced."""
    import torch
    sync = torch.cuda.synchronize if CONTRIB_DEVICES[0] == "cuda" \
        else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return 1e3 * (time.perf_counter() - t0)


def linalg_family(n=LINALG_N, batch=LINALG_BATCH):
    """The linalg chain on 64 SPD matrices (scaled to a determinant near
    1, so ``det`` is finite) and ``moments`` over a ResNet activation."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    rng = np.random.default_rng(2)
    m = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    s = m @ np.swapaxes(m, -1, -2) + np.eye(n)
    s /= np.exp(np.linalg.slogdet(s)[1] / n)[:, None, None]
    s, m = s.astype(np.float32), m.astype(np.float32)
    b = rng.standard_normal((batch, n, 16)).astype(np.float32)
    act = rng.standard_normal((32, 56, 56, 256)).astype(np.float32)

    def chain(device):
        ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
        with ctx:
            S, M, B = mx.nd.array(s), mx.nd.array(m), mx.nd.array(b)
            S.attach_grad()
            with autograd.record():
                L = mx.nd.linalg_potrf(S)
                y = mx.nd.linalg_sumlogdiag(L).sum() \
                    + (mx.nd.linalg_inverse(S) * S).sum() * 1e-3
            y.backward()
            outs = [L, mx.nd.linalg_potri(L), mx.nd.linalg_trsm(L, B),
                    mx.nd.linalg_trmm(L, B, rightside=False),
                    mx.nd.linalg_sumlogdiag(L), mx.nd.linalg_syrk(M),
                    mx.nd.linalg_gemm(M, M, S, transpose_b=True, alpha=0.5,
                                      beta=2.0),
                    mx.nd.linalg_gemm2(M, B, transpose_a=True),
                    mx.nd.linalg_inverse(S), mx.nd.linalg_det(S)] \
                + list(mx.nd.linalg_slogdet(S)) \
                + [mx.nd.linalg_extractdiag(L),
                   mx.nd.linalg_makediag(mx.nd.linalg_extractdiag(L)),
                   mx.nd.linalg_extracttrian(L),
                   mx.nd.linalg_maketrian(mx.nd.linalg_extracttrian(L)),
                   S.grad]
            ut, w = mx.nd.linalg_syevd(S)
            vt, sv, v = mx.nd.linalg_svd(M)
            recon = [mx.nd.linalg_gemm2(
                mx.nd.broadcast_mul(ut, mx.nd.expand_dims(w, axis=-1)), ut,
                transpose_a=True),
                     mx.nd.linalg_gemm2(
                mx.nd.broadcast_mul(vt, mx.nd.expand_dims(sv, axis=-1)), v,
                transpose_a=True)]
            mean, var = mx.nd.moments(mx.nd.array(act), axes=(0, 1, 2))
        return [o._data for o in outs + [w, sv] + recon + [mean, var]]
    t_ms = _card_ms(lambda: chain(CONTRIB_DEVICES[0]))
    pairs = _both_devices(chain)
    n_eig = 2           # syevd's eigenvalues, svd's singular values
    err = _card_vs_cpu("linalg", pairs[:-n_eig - 4] + pairs[-2:], floor=1.0)
    # the card's eigensolvers (cuSOLVER) and LAPACK agree to ~1e-4 of
    # the largest eigenvalue in float32: values held to 1e-3 card
    # against CPU, and each device's reconstruction to 1e-3 of its input
    eig = _card_vs_cpu("linalg eigen/singular values",
                       pairs[-n_eig - 4:-4], tol=LINALG_EIG_TOL)
    inputs = [torch.from_numpy(s), torch.from_numpy(m)]
    recon = max(_card_vs_cpu("linalg reconstruction", [(r, x), (c, x)],
                             tol=LINALG_EIG_TOL)
                for (r, c), x in zip(pairs[-4:-2], inputs))
    return {"card_ms": t_ms, "max_rel_err": err, "eigen_rel_err": eig,
            "reconstruction_rel_err": recon, "ops": len(pairs)}


def attention_family(seq=BERT_QKV[0], batch=BERT_QKV[1],
                     heads=BERT_QKV[2], hd=BERT_QKV[3], qlen=ENCDEC_QLEN):
    """BERT-base's interleaved self-attention (forward and the gradient
    of the projection) and the encoder-decoder pair; the self-attention
    also against the port's ``flash_attention`` on the same q, k, v."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    rng = np.random.default_rng(3)
    qkv = (rng.standard_normal((seq, batch, heads * 3 * hd)) * 0.5) \
        .astype(np.float32)
    q_in = rng.standard_normal((qlen, batch, heads * hd)).astype(np.float32)
    kv_in = (rng.standard_normal((seq, batch, heads * 2 * hd)) * 0.5) \
        .astype(np.float32)
    cot = rng.standard_normal((seq, batch, heads * hd)).astype(np.float32)

    def run(device):
        ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
        with ctx:
            x = mx.nd.array(qkv)
            x.attach_grad()
            with autograd.record():
                att = mx.nd.softmax(mx.nd.interleaved_matmul_selfatt_qk(
                    x, heads=heads), axis=-1)
                out = mx.nd.interleaved_matmul_selfatt_valatt(
                    x, att, heads=heads)
                (out * mx.nd.array(cot)).sum().backward()
            catt = mx.nd.softmax(mx.nd.interleaved_matmul_encdec_qk(
                mx.nd.array(q_in), mx.nd.array(kv_in), heads=heads), axis=-1)
            cout = mx.nd.interleaved_matmul_encdec_valatt(
                mx.nd.array(kv_in), catt, heads=heads)
        return [out._data, x.grad._data, cout._data]
    t_ms = _card_ms(lambda: run(CONTRIB_DEVICES[0]))
    pairs = _both_devices(run)
    err = _card_vs_cpu("interleaved attention", pairs)
    return {"card_ms": t_ms, "max_rel_err": err}, pairs[0][0]


def flash_reference(out, seq=BERT_QKV[0], batch=BERT_QKV[1],
                    heads=BERT_QKV[2], hd=BERT_QKV[3]):
    """The interleaved self-attention's output against the port's
    ``flash_attention`` on the same q, k and v (run outside the counted
    window: it launches the flash kernel)."""
    import torch
    from mxnet_tpu_torch import ops
    rng = np.random.default_rng(3)
    qkv = (rng.standard_normal((seq, batch, heads * 3 * hd)) * 0.5) \
        .astype(np.float32)
    x = torch.from_numpy(qkv).cuda().reshape(seq, batch, heads, 3, hd)
    q, k, v = (x[:, :, :, i].permute(1, 2, 0, 3).reshape(
        batch * heads, seq, hd).contiguous() for i in range(3))
    with torch.no_grad():
        ref = ops.flash_attention(q, k, v)
    ref = ref.reshape(batch, heads, seq, hd).permute(2, 0, 1, 3) \
        .reshape(seq, batch, heads * hd).cpu()
    err = _rel(out.double().numpy(), ref.double().numpy())
    check(err <= CONTRIB_TOL, "interleaved attention %.3g from "
          "flash_attention" % err)
    return err


def detection_family(nms_shape=NMS_SHAPE, fmap=ROI_MAP,
                     per_image=ROI_PER_IMAGE, pooled=ROI_POOLED,
                     cpu_rois=ROI_CPU_ROIS):
    """``box_iou``, ``box_nms`` and the ROI ops at Faster R-CNN's shapes:
    IoU and NMS card against CPU in full; ``ROIAlign`` (with the gradient
    of its map) and ``ROIPooling`` timed on every ROI, held against the
    CPU on the first ``cpu_rois``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    rng = np.random.default_rng(4)
    b, n, _ = nms_shape
    xy = rng.uniform(0, 600, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 120, (b, n, 2))], -1)
    props = np.concatenate([rng.integers(0, 20, (b, n, 1)),
                            np.round(rng.uniform(0, 1, (b, n, 1)), 3),
                            boxes], -1).astype(np.float32)
    gt = boxes[:, :100].astype(np.float32)
    feat = rng.standard_normal(fmap).astype(np.float32)
    h, w = fmap[2] * 16, fmap[3] * 16
    lo = rng.uniform(0, [w - 64, h - 64], (fmap[0] * per_image, 2))
    rois = np.concatenate([np.repeat(np.arange(fmap[0]), per_image)[:, None],
                           lo, lo + rng.uniform(32, 256, lo.shape)], 1) \
        .astype(np.float32)
    scale = 1.0 / 16

    def boxes_run(device):
        ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
        with ctx:
            return [mx.nd.box_iou(mx.nd.array(boxes.astype(np.float32)),
                                  mx.nd.array(gt))._data,
                    mx.nd.box_nms(mx.nd.array(props),
                                  overlap_thresh=0.7)._data]

    def roi_run(device, r):
        ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
        with ctx:
            x = mx.nd.array(feat)
            x.attach_grad()
            with autograd.record():
                y = mx.nd.ROIAlign(x, mx.nd.array(r), pooled_size=pooled,
                                   spatial_scale=scale, sample_ratio=2)
                (y * y).sum().backward()
            p = mx.nd.ROIPooling(x, mx.nd.array(r), pooled_size=pooled,
                                 spatial_scale=scale)
        return [y._data, x.grad._data, p._data]
    nms_ms = _card_ms(lambda: boxes_run(CONTRIB_DEVICES[0]))
    box_pairs = _both_devices(boxes_run)
    _card_vs_cpu("box_iou", box_pairs[:1], tol=1e-6)
    _card_vs_cpu("box_nms", box_pairs[1:], exact=True)
    kept = float((box_pairs[1][0][..., 1] > 0).float().mean())
    roi_ms = _card_ms(lambda: roi_run(CONTRIB_DEVICES[0], rois))
    pairs = _both_devices(lambda d: roi_run(d, rois[:cpu_rois]))
    err = _card_vs_cpu("ROIAlign", pairs[:1])
    grad_err = _rel(pairs[1][0].double().numpy(), pairs[1][1].double().numpy())
    check(grad_err <= CONTRIB_TOL, "ROIAlign gradient %.3g" % grad_err)
    _card_vs_cpu("ROIPooling", pairs[2:], exact=True)
    return {"boxes_card_ms": nms_ms, "nms_kept_share": kept,
            "roi_card_ms": roi_ms, "rois": len(rois),
            "roi_align_rel_err": err, "roi_align_grad_rel_err": grad_err}


def control_flow_family(shape=LSTM_SCAN, iters=WHILE_ITERS):
    """``foreach`` over an ``LSTMCell(650)``, ``while_loop`` and ``cond``
    on a device predicate, each in a hybridized block: three calls on the
    card (eager, captured, replayed) against the CPU."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    class Scan(gluon.HybridBlock):
        def __init__(self, hidden, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = gluon.rnn.LSTMCell(hidden, input_size=hidden)

        def hybrid_forward(self, F, x, h, c):
            outs, (h, c) = F.contrib.foreach(
                lambda xt, st: self.cell(xt, st), x, [h, c])
            return outs, h, c

    class Loop(gluon.HybridBlock):
        def hybrid_forward(self, F, x, limit):
            outs, (i, y) = F.contrib.while_loop(
                lambda i, y: (y.sum() < limit).reshape(()),
                lambda i, y: (y.sum(), (i + 1.0, y * 1.05 + 0.01)),
                (limit * 0, x), max_iterations=iters)
            return F.contrib.cond(i > iters / 2, lambda a: a * 2.0,
                                  lambda a: a - 1.0, [y]), outs

    steps, batch, hidden = shape
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((steps, batch, hidden))
                         .astype(np.float32))
    h0 = torch.zeros(batch, hidden)
    v0 = torch.from_numpy(rng.uniform(0, 1, (batch, 8)).astype(np.float32))
    out = {}
    for name, make, args in (
            ("foreach_lstm", lambda: Scan(hidden, prefix="scan_"),
             (x, h0, h0)),
            ("while_loop_cond", lambda: Loop(prefix="loop_"),
             (v0, torch.tensor(2000.0)))):
        res = []
        for device in CONTRIB_DEVICES:
            net = make()
            net.initialize(device=device,
                           generator=torch.Generator().manual_seed(0))
            net.hybridize()
            dev_args = [a.to(device) for a in args]
            with torch.no_grad():
                calls = [net(*dev_args) for _ in range(3)]
            if device == "cuda":
                owner = next(iter(net._graph_owners.values()))
                check(owner.graphs == 1 and owner.replays >= 1,
                      "%s: %d graphs, %d replays" % (name, owner.graphs,
                                                     owner.replays))
                with torch.no_grad():
                    out[name + "_replay_ms"] = _card_ms(
                        lambda: net(*dev_args))
            res.append([t.cpu() for t in calls[-1]])
        out[name + "_rel_err"] = _card_vs_cpu(name, list(zip(*res)))
    return out


def contrib_ops_part():
    """Part (c): the op families at user widths under the host-read
    check, each card result against the port's CPU run."""
    import torch
    from mxnet_tpu_torch import _capture
    from mxnet_tpu_torch.kernels import registry
    card = gpu_line()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    with _capture.checking_syncs():
        out = {"linalg": linalg_family()}
        attn, attn_out = attention_family()
        out["interleaved_attention"] = attn
        out["detection"] = detection_family()
        out["control_flow"] = control_flow_family()
    launches = {k: registry.launches(k) for k in registry.list_kernels()}
    out["interleaved_attention"]["vs_flash_attention_rel_err"] = \
        flash_reference(attn_out)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["card"] = card
    print("contrib (c) op families at user widths (card against the CPU): "
          "%s" % json.dumps(out))
    return out, launches


def contrib_phase():
    """Phase 21: sparse storage and the contrib op families (see the
    module docstring).  Part (a) and the calibration run outside the
    host-read check; inference and part (c) inside it.  Returns the
    numbers and, by part, every kernel's launches (all 0: no hand kernel
    is on these paths)."""
    t0 = time.perf_counter()
    launches = {}
    sparse, launches["sparse_logreg"] = sparse_logreg_part()
    release_cuda()
    quant, launches["int8_resnet50"] = quant_part()
    release_cuda()
    ops_, launches["op_families"] = contrib_ops_part()
    stray = {part: {k: n for k, n in counts.items() if n}
             for part, counts in launches.items()}
    check(not any(stray.values()), "phase 21 launched hand kernels: %s"
          % stray)
    out = {"sparse": sparse, "quant": quant, "ops": ops_,
           "launches": launches, "phase_s": time.perf_counter() - t0}
    print("contrib phase: %.1f s (%s)" % (out["phase_s"], gpu_line()))
    return out


# ---------------------------------------------------------------------
# phase 22: the NumPy front end (mx.np, mx.npx), the engine and runtime
# helpers
# ---------------------------------------------------------------------

NUMPY_BATCH = 8
NUMPY_STEPS = 4
# BERT fine-tuning's learning rate: at pretraining's 1e-4 with no warm-up
# the loss rose after the second step (11.64 -> 12.77 in four steps)
NUMPY_ADAM = {"learning_rate": 2e-5}
NUMPY_BULK = 64
NUMPY_RUNS = ("np", "nd", "bulk")
NUMPY_SITES = {"flash_attention_fwd": BERT_LAYERS,
               "flash_attention_bwd": BERT_LAYERS,
               # two per encoder cell, the embedding's, the MLM head's
               "layernorm_fwd": 2 * BERT_LAYERS + 2}
# a run that differs from the nd run by more than this many times the
# distance of two nd runs (the flash backward adds dq by fp32 atomics, in
# no fixed order) has not run the same ops
NUMPY_FLOOR_FACTOR = 4.0
NUMPY_WIDTH = (4096, 768)          # BERT-base's rows at 8 x 512, units
NUMPY_FFN = 3072
NUMPY_TOL = 1e-5                   # of the CPU result's largest value
NUMPY_CHAIN = 256                  # eager adds of part (d)


def _kind(x):
    """``"ndarray"`` for an ``mx.np.ndarray``, ``"NDArray"`` otherwise."""
    import mxnet_tpu_torch as mx
    return "ndarray" if isinstance(x, mx.np.ndarray) else "NDArray"


def numpy_inputs(batch, seq, vocab, seed=0):
    """Part (a)'s batch, made with ``mx.np`` on the current context:
    ids by ``np.random.randint``, labels and next-sentence labels by
    ``np.array`` from a seeded host draw, token types zeros."""
    import mxnet_tpu_torch as mx
    mx.np.random.seed(seed)
    ids = mx.np.random.randint(0, vocab, size=(batch, seq)).astype("float32")
    rng = np.random.default_rng(seed)
    labels = mx.np.array(rng.integers(0, vocab, (batch, seq)), "float32")
    nsp = mx.np.array(rng.integers(0, 2, (batch,)), "float32")
    return {"ids": ids, "types": mx.np.zeros((batch, seq)),
            "labels": labels, "nsp": nsp}


def _numpy_loss(m, mlm, nsp, labels, nsp_labels):
    """Masked-LM and next-sentence cross entropy, each the mean over its
    positions, written in ``m`` (``mx.np``/``npx`` or ``mx.nd``)."""
    if m == "np":
        import mxnet_tpu_torch as mx
        np_, npx = mx.np, mx.npx

        def ce(s, y):
            return np_.mean(np_.negative(npx.pick(npx.log_softmax(s), y)))
    else:
        from mxnet_tpu_torch import nd

        def ce(s, y):
            return nd.mean(nd.negative(nd.pick(nd.log_softmax(s), y)))
    return ce(mlm, labels) + ce(nsp, nsp_labels)


def _numpy_step(net, trainer, feed, use_np):
    """One imperative step: forward and loss under ``record()``,
    ``backward``, ``trainer.step``; the loss and the net's outputs."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        mlm, nsp = net(feed["ids"], feed["types"])
        loss = _numpy_loss("np" if use_np else "nd", mlm, nsp,
                           feed["labels"], feed["nsp"])
    loss.backward()
    trainer.step(1)
    return loss, (mlm, nsp)


def numpy_bert_run(net, w0, inputs, mode, steps=NUMPY_STEPS, sync=None,
                   hyper=NUMPY_ADAM):
    """``steps`` imperative Adam steps of ``net`` from the weights ``w0``
    and ``mx.random.seed(0)``: ``mode`` ``"np"`` under ``npx.set_np()``
    on ``mx.np`` inputs, ``"nd"`` under ``npx.reset_np()`` through
    ``mx.nd``, ``"bulk"`` the np run inside ``mx.engine.bulk(64)``.
    Returns the losses, the final weights, the step times and the types
    of the net's outputs."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    params = list(net.collect_params().values())
    with torch.no_grad():
        for p, t in zip(params, w0):
            p.data()._data.copy_(t)
    use_np = mode != "nd"
    if use_np:
        mx.npx.set_np()
        feed = inputs
    else:
        mx.npx.reset_np()
        feed = {k: mx.nd.NDArray(v) for k, v in inputs.items()}
    mx.random.seed(0)
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(hyper))
    scope = mx.engine.bulk(NUMPY_BULK) if mode == "bulk" \
        else contextlib.nullcontext()
    losses, step_ms, kinds = [], [], []
    sync = sync or (lambda: None)
    try:
        with scope:
            for _ in range(steps):
                sync()
                t0 = time.perf_counter()
                loss, outs = _numpy_step(net, trainer, feed, use_np)
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                kinds.append([_kind(o) for o in outs])
                losses.append(float(loss.asnumpy()))
    finally:
        mx.npx.reset_np()
    weights = [p.data()._data.detach().clone() for p in params]
    return {"losses": losses, "weights": weights, "step_ms": step_ms,
            "kinds": kinds}


def numpy_step_breakdown(net, inputs, step_ms, hyper=NUMPY_ADAM):
    """Where one np step of part (a) goes: ``train_step_breakdown`` over
    one more imperative step after a first one that makes Adam's state
    (both outside the counted window)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(hyper))
    mx.npx.set_np()
    try:
        _numpy_step(net, trainer, inputs, True)
        return train_step_breakdown(
            lambda feed, _: _numpy_step(net, trainer, feed, True), inputs,
            None, step_ms, hand=("flash_fwd_kernel", "flash_bwd_kernel",
                                 "layernorm_fwd_kernel"),
            label="numpy (a) step breakdown")
    finally:
        mx.npx.reset_np()


def _runs_distance(a, b):
    """The largest relative loss difference and the norm-wise relative
    weight difference of two runs."""
    import torch
    loss = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    num = sum(float((x.double() - y.double()).pow(2).sum())
              for x, y in zip(a["weights"], b["weights"]))
    den = sum(float(y.double().pow(2).sum()) for y in b["weights"])
    same = all(torch.equal(x, y) for x, y in zip(a["weights"], b["weights"]))
    return {"loss_rel_err": loss, "weights_rel_err": (num / den) ** 0.5,
            "bitwise": same and a["losses"] == b["losses"]}


def numpy_bert_path(make_net=bert_base_net, vocab=BERT_VOCAB,
                    batch=NUMPY_BATCH, seq=BERT_SEQ, steps=NUMPY_STEPS,
                    sites=NUMPY_SITES, ctx=None, hyper=NUMPY_ADAM):
    """Part (a): BERT-base (dropout 0.1, fp32) trained from ``mx.np``
    arrays under ``npx.set_np()`` by ``steps`` imperative Adam steps,
    then the same steps through ``mx.nd`` and inside ``mx.engine.bulk``
    from the same weights and seed, then a second nd run outside the
    counted window for the floor.  Every run's first loss must be
    bitwise the np run's; the rest bitwise too when the two nd runs are,
    else within NUMPY_FLOOR_FACTOR x their distance.  The hand kernels
    launch ``sites`` times a step in each counted run, every other
    kernel never (``sites={}`` skips the count).  ``hyper`` is Adam's."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.kernels import registry
    ctx = ctx or mx.gpu(0)
    cuda = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if cuda else None
    with ctx:
        net = make_net()
        net.initialize(device="cuda" if cuda else "cpu",
                       generator=torch.Generator().manual_seed(0))
        inputs = numpy_inputs(batch, seq, vocab)
        with autograd.pause():
            net(inputs["ids"][:1], inputs["types"][:1])   # sizes deferred
        w0 = [p.data()._data.detach().clone()
              for p in net.collect_params().values()]
        kinds_in = sorted({_kind(v) for v in inputs.values()})
        registry.reset_launches()
        runs = {mode: numpy_bert_run(net, w0, inputs, mode, steps, sync,
                                     hyper)
                for mode in NUMPY_RUNS}
        counts = {k: registry.launches(k) for k in registry.list_kernels()}
        floor_run = numpy_bert_run(net, w0, inputs, "nd", steps, sync,
                                   hyper)
        if cuda:
            breakdown = numpy_step_breakdown(
                net, inputs, float(np.median(runs["np"]["step_ms"][1:])),
                hyper)
    floor = _runs_distance(floor_run, runs["nd"])
    dist = {mode: _runs_distance(runs[mode], runs["nd"])
            for mode in ("np", "bulk")}
    first = {mode: r["losses"][0] for mode, r in runs.items()}
    out = {"batch": batch, "seq": seq, "steps": steps,
           "losses": {m: r["losses"] for m, r in runs.items()},
           "step_ms": {m: r["step_ms"] for m, r in runs.items()},
           "median_step_ms": {m: float(np.median(r["step_ms"][1:] or
                                                 r["step_ms"]))
                              for m, r in runs.items()},
           "vs_nd": dist, "nd_twice": floor, "launches": counts,
           "device_idle_share": breakdown["device_idle_share"]
           if cuda else None, "card": gpu_line() if cuda else None}
    print("numpy (a) BERT-base from mx.np under npx.set_np(): %s"
          % json.dumps(out))
    check(kinds_in == ["ndarray"], "inputs not mx.np arrays: %s" % kinds_in)
    check(all(k == ["ndarray", "ndarray"] for k in runs["np"]["kinds"]
              + runs["bulk"]["kinds"]),
          "set_np block outputs: %s" % runs["np"]["kinds"])
    check(all(k == ["NDArray", "NDArray"] for k in runs["nd"]["kinds"]),
          "reset_np block outputs: %s" % runs["nd"]["kinds"])
    for mode, r in runs.items():
        check(all(np.isfinite(r["losses"])), "%s losses %s"
              % (mode, r["losses"]))
        check(r["losses"][-1] < r["losses"][0], "%s loss did not fall: %s"
              % (mode, r["losses"]))
    check(len(set(first.values())) == 1
          and floor_run["losses"][0] == first["np"],
          "first losses differ: %s" % first)
    for mode, d in dist.items():
        if floor["bitwise"]:
            check(d["bitwise"], "%s run not bitwise the nd run: %s"
                  % (mode, d))
        else:
            for key in ("loss_rel_err", "weights_rel_err"):
                check(d[key] <= NUMPY_FLOOR_FACTOR * floor[key],
                      "%s run: %s %.3g above %g x the nd floor %.3g"
                      % (mode, key, d[key], NUMPY_FLOOR_FACTOR,
                         floor[key]))
    if sites:
        n = steps * len(NUMPY_RUNS)
        for name, c in counts.items():
            want = sites.get(name, 0) * n
            check(c == want, "%s launches %d != %d" % (name, c, want))
    del net, runs, floor_run
    return out


def _np_case_inputs(width, ffn, vocab, seed=5):
    """Host inputs of part (b) at user widths."""
    rows, units = width
    rng = np.random.default_rng(seed)
    f32 = np.float32
    # distinct values everywhere: sorts, arg-ops and top-k have no ties
    perm = (np.stack([rng.permutation(units) for _ in range(rows)])
            + np.arange(rows)[:, None] * units).astype(f32)
    odd = rng.standard_normal((rows, units)).astype(f32)
    odd[::7, ::5] = np.nan
    odd[1::11, ::3] = np.inf
    odd[2::13, 1::4] = -np.inf
    return {
        "sym": rng.uniform(-1, 1, (rows, units)).astype(f32),
        "sym2": rng.uniform(-1, 1, (rows, units)).astype(f32),
        "pos": rng.uniform(0.5, 1.5, (rows, units)).astype(f32),
        "near1": rng.uniform(0.995, 1.005, (rows, units)).astype(f32),
        "perm": perm, "odd": odd,
        "w": (rng.standard_normal((units, ffn)) / np.sqrt(units)).astype(f32),
        "wt": (rng.standard_normal((ffn, units)) / np.sqrt(units)).astype(f32),
        "b": rng.standard_normal(ffn).astype(f32),
        "gamma": rng.uniform(0.5, 1.5, units).astype(f32),
        "beta": rng.uniform(-0.5, 0.5, units).astype(f32),
        "logits": rng.standard_normal((rows, vocab)).astype(f32),
        "labels": rng.integers(0, vocab, rows).astype(f32),
        "ids": rng.integers(0, vocab, (rows // 64, 64)).astype(f32),
        "table": rng.standard_normal((vocab, units)).astype(f32),
        "img": rng.standard_normal((8, 64, 56, 56)).astype(f32),
        "kern": (rng.standard_normal((64, 64, 3, 3)) / 24).astype(f32),
        "kb": rng.standard_normal(64).astype(f32),
        "stats": [rng.standard_normal(64).astype(f32) for _ in range(3)]
        + [rng.uniform(0.5, 2.0, 64).astype(f32)],
        "flat": rng.uniform(0.5, 1.5, (64, units)).astype(f32),
    }


def numpy_cases():
    """Part (b)'s cases: ``{name: (fn(np, npx, arr, X), exact)}``, every
    ``mx.np`` name (the functions, the generated unary names, the
    ``ndarray`` members) and every ``npx`` op; ``arr`` makes an
    ``mx.np`` array of a host input on the current context."""
    unary = {"abs": "sym", "exp": "sym", "log": "pos", "log2": "pos",
             "log10": "pos", "sqrt": "pos", "square": "sym", "sin": "sym",
             "cos": "sym", "tan": "sym", "tanh": "sym", "sign": "sym",
             "floor": "sym", "ceil": "sym", "isnan": "odd", "isinf": "odd",
             "isfinite": "odd", "negative": "sym"}
    exact_unary = {"abs", "sign", "floor", "ceil", "isnan", "isinf",
                   "isfinite", "negative", "square"}
    cases = {
        "array": (lambda np_, npx, arr, X: [np_.array(X["sym"]),
                                            np_.array(X["perm"], "int32")],
                  True),
        "asarray": (lambda np_, npx, arr, X: [np_.asarray(X["sym"])], True),
        "zeros": (lambda np_, npx, arr, X: [np_.zeros(X["sym"].shape)], True),
        "ones": (lambda np_, npx, arr, X: [np_.ones(X["sym"].shape)], True),
        "empty": (lambda np_, npx, arr, X: [np_.zeros(np_.empty(
            X["sym"].shape).shape)], True),
        "full": (lambda np_, npx, arr, X: [np_.full(X["sym"].shape, 0.5)],
                 True),
        "eye": (lambda np_, npx, arr, X: [np_.eye(X["sym"].shape[1])], True),
        "arange": (lambda np_, npx, arr, X: [np_.arange(X["sym"].size)],
                   True),
        "linspace": (lambda np_, npx, arr, X: [np_.linspace(
            0, 1, X["sym"].size)], True),
        "concatenate": (lambda np_, npx, arr, X: [np_.concatenate(
            [arr(X["sym"]), arr(X["pos"])], axis=1)], True),
        "stack": (lambda np_, npx, arr, X: [np_.stack(
            [arr(X["sym"]), arr(X["pos"])])], True),
        "split": (lambda np_, npx, arr, X: np_.split(arr(X["sym"]), 3,
                                                     axis=1), True),
        "dot": (lambda np_, npx, arr, X: [np_.dot(arr(X["sym"]),
                                                  arr(X["w"]))], False),
        "matmul": (lambda np_, npx, arr, X: [np_.matmul(arr(X["sym"]),
                                                        arr(X["w"]))], False),
        "tensordot": (lambda np_, npx, arr, X: [np_.tensordot(
            arr(X["sym"]), arr(X["w"]), axes=([1], [0]))], False),
        "einsum": (lambda np_, npx, arr, X: [np_.einsum(
            "ij,jk->ik", arr(X["sym"]), arr(X["w"]))], False),
        "where": (lambda np_, npx, arr, X: [np_.where(
            arr(X["sym"] > 0), arr(X["sym"]), arr(X["pos"]))], True),
        "maximum": (lambda np_, npx, arr, X: [
            np_.maximum(arr(X["sym"]), 0.25),
            np_.maximum(arr(X["sym"]), arr(X["sym2"]))], True),
        "minimum": (lambda np_, npx, arr, X: [
            np_.minimum(arr(X["sym"]), 0.25),
            np_.minimum(arr(X["sym"]), arr(X["sym2"]))], True),
        "clip": (lambda np_, npx, arr, X: [np_.clip(arr(X["sym"]), -0.5,
                                                    0.5)], True),
        "power": (lambda np_, npx, arr, X: [
            np_.power(arr(X["pos"]), 3), np_.power(arr(X["pos"]),
                                                   arr(X["sym"]))], False),
        "sum": (lambda np_, npx, arr, X: [np_.sum(arr(X["pos"])),
                                          np_.sum(arr(X["pos"]), axis=1)],
                False),
        "mean": (lambda np_, npx, arr, X: [np_.mean(arr(X["pos"])),
                                           np_.mean(arr(X["pos"]), axis=0)],
                 False),
        "var": (lambda np_, npx, arr, X: [np_.var(arr(X["pos"]), axis=1),
                                          np_.var(arr(X["pos"]), ddof=1)],
                False),
        "std": (lambda np_, npx, arr, X: [np_.std(arr(X["pos"]), axis=0),
                                          np_.std(arr(X["pos"]))], False),
        "prod": (lambda np_, npx, arr, X: [np_.prod(arr(X["near1"]),
                                                    axis=1)], False),
        "max": (lambda np_, npx, arr, X: [np_.max(arr(X["perm"])),
                                          np_.max(arr(X["perm"]), axis=1)],
                True),
        "min": (lambda np_, npx, arr, X: [np_.min(arr(X["perm"])),
                                          np_.min(arr(X["perm"]), axis=0)],
                True),
        "argmax": (lambda np_, npx, arr, X: [
            np_.argmax(arr(X["perm"])), np_.argmax(arr(X["perm"]), axis=1)],
            True),
        "argmin": (lambda np_, npx, arr, X: [
            np_.argmin(arr(X["perm"])), np_.argmin(arr(X["perm"]), axis=0)],
            True),
        "reshape": (lambda np_, npx, arr, X: [np_.reshape(
            arr(X["sym"]), (-1, 64))], True),
        "transpose": (lambda np_, npx, arr, X: [np_.transpose(
            arr(X["sym"]))], True),
        "expand_dims": (lambda np_, npx, arr, X: [np_.expand_dims(
            arr(X["sym"]), 1)], True),
        "squeeze": (lambda np_, npx, arr, X: [np_.squeeze(np_.expand_dims(
            arr(X["sym"]), 0))], True),
        "tile": (lambda np_, npx, arr, X: [np_.tile(arr(X["sym"]), (2, 1))],
                 True),
        "repeat": (lambda np_, npx, arr, X: [np_.repeat(arr(X["sym"]), 2,
                                                        axis=1)], True),
        "flip": (lambda np_, npx, arr, X: [np_.flip(arr(X["sym"])),
                                           np_.flip(arr(X["sym"]), axis=1)],
                 True),
        "cumsum": (lambda np_, npx, arr, X: [
            np_.cumsum(arr(X["pos"]), axis=1), np_.cumsum(arr(X["flat"]))],
            False),
        "sort": (lambda np_, npx, arr, X: [np_.sort(arr(X["perm"])),
                                           np_.sort(arr(X["perm"]), axis=0)],
                 True),
        "argsort": (lambda np_, npx, arr, X: [np_.argsort(arr(X["perm"]))],
                    True),
        "take": (lambda np_, npx, arr, X: [
            np_.take(arr(X["sym"]), arr(X["ids"])),
            np_.take(arr(X["table"]), arr(X["ids"]), axis=0)], True),
        "vstack": (lambda np_, npx, arr, X: [np_.vstack(
            [arr(X["sym"]), arr(X["pos"])])], True),
        "hstack": (lambda np_, npx, arr, X: [np_.hstack(
            [arr(X["sym"]), arr(X["pos"])])], True),
        "dstack": (lambda np_, npx, arr, X: [np_.dstack(
            [arr(X["sym"]), arr(X["pos"])])], True),
        "random": (lambda np_, npx, arr, X: [np_.zeros(np_.random.uniform(
            size=X["sym"].shape).shape)], True),
        # ndarray members
        ".T": (lambda np_, npx, arr, X: [arr(X["sym"]).T], True),
        ".reshape": (lambda np_, npx, arr, X: [arr(X["sym"]).reshape(
            -1, 256)], True),
        ".copy": (lambda np_, npx, arr, X: [arr(X["sym"]).copy()], True),
        ".astype": (lambda np_, npx, arr, X: [arr(X["perm"]).astype(
            "int32")], True),
        ".mean": (lambda np_, npx, arr, X: [arr(X["pos"]).mean(axis=1)],
                  False),
        ".sum": (lambda np_, npx, arr, X: [arr(X["pos"]).sum(axis=0)],
                 False),
        ".max": (lambda np_, npx, arr, X: [arr(X["perm"]).max(axis=1)],
                 True),
        ".min": (lambda np_, npx, arr, X: [arr(X["perm"]).min()], True),
        # npx
        "npx.relu": (lambda np_, npx, arr, X: [npx.relu(arr(X["sym"]))],
                     True),
        "npx.sigmoid": (lambda np_, npx, arr, X: [npx.sigmoid(
            arr(X["sym"]))], False),
        "npx.softmax": (lambda np_, npx, arr, X: [npx.softmax(
            arr(X["sym"]))], False),
        "npx.log_softmax": (lambda np_, npx, arr, X: [npx.log_softmax(
            arr(X["logits"]))], False),
        "npx.activation": (lambda np_, npx, arr, X: [
            npx.activation(arr(X["sym"]), t)
            for t in ("relu", "sigmoid", "tanh", "softrelu")], False),
        "npx.fully_connected": (lambda np_, npx, arr, X: [
            npx.fully_connected(arr(X["sym"]), arr(X["wt"]), arr(X["b"]),
                                num_hidden=X["wt"].shape[0])], False),
        "npx.convolution": (lambda np_, npx, arr, X: [npx.convolution(
            arr(X["img"]), arr(X["kern"]), arr(X["kb"]), kernel=(3, 3),
            pad=(1, 1), num_filter=64)], False),
        "npx.pooling": (lambda np_, npx, arr, X: [
            npx.pooling(arr(X["img"])),
            npx.pooling(arr(X["img"]), kernel=(3, 3), stride=(2, 2),
                        pool_type="avg")], False),
        "npx.batch_norm": (lambda np_, npx, arr, X: list(npx.batch_norm(
            arr(X["img"]), *[arr(s) for s in X["stats"]])), False),
        "npx.layer_norm": (lambda np_, npx, arr, X: [npx.layer_norm(
            arr(X["sym"]), arr(X["gamma"]), arr(X["beta"]), eps=1e-12)],
            False),
        "npx.embedding": (lambda np_, npx, arr, X: [npx.embedding(
            arr(X["ids"]), arr(X["table"]), input_dim=X["table"].shape[0],
            output_dim=X["table"].shape[1])], True),
        "npx.one_hot": (lambda np_, npx, arr, X: [npx.one_hot(
            arr(X["labels"][:512]), X["logits"].shape[1])], True),
        "npx.pick": (lambda np_, npx, arr, X: [npx.pick(
            arr(X["logits"]), arr(X["labels"]))], True),
        "npx.topk": (lambda np_, npx, arr, X: [
            npx.topk(arr(X["perm"]), k=5),
            npx.topk(arr(X["perm"]), k=3, ret_typ="value")], True),
        "npx.reshape_like": (lambda np_, npx, arr, X: [npx.reshape_like(
            arr(X["sym"]), np_.zeros((X["sym"].shape[0] // 4,
                                      X["sym"].shape[1] * 4)))], True),
    }
    for name, key in unary.items():
        cases[name] = (lambda np_, npx, arr, X, _n=name, _k=key:
                       [getattr(np_, _n)(arr(X[_k]))], name in exact_unary)
    return cases


def numpy_card_vs_cpu(width=NUMPY_WIDTH, ffn=NUMPY_FFN, vocab=BERT_VOCAB,
                      tol=NUMPY_TOL, ctxs=None):
    """Part (b): every case of :func:`numpy_cases` on the card against
    the same call under ``with mx.cpu():`` (``ctxs``, by default
    ``(gpu(0), cpu())``) -- equal result types, dtypes and shapes; exact
    cases bitwise, the rest within ``tol`` of the CPU result's largest
    finite magnitude.  Returns ``{case: error}`` and the largest."""
    import mxnet_tpu_torch as mx
    X = _np_case_inputs(width, ffn, vocab)
    errs = {}
    for name, (fn, exact) in sorted(numpy_cases().items()):
        res = []
        for ctx in ctxs or (mx.gpu(0), mx.cpu()):
            with ctx:
                outs = fn(mx.np, mx.npx, mx.np.array, X)
                res.append([(_kind(o), o.asnumpy()) for o in outs])
        worst = 0.0
        for (gk, g), (wk, w) in zip(*res):
            check(gk == wk, "%s: %s on the card, %s on the CPU"
                  % (name, gk, wk))
            check(g.shape == w.shape and g.dtype == w.dtype,
                  "%s: %s %s against %s %s" % (name, g.shape, g.dtype,
                                               w.shape, w.dtype))
            if exact:
                same = np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
                check(same, "%s: not bitwise on the card" % name)
                continue
            fin = np.isfinite(w)
            check(np.array_equal(np.isfinite(g), fin),
                  "%s: finite entries differ" % name)
            # float32 differences of close values are exact; the masks
            # keep infinities out without copying the finite entries
            with np.errstate(invalid="ignore"):
                diff = np.abs(np.where(fin, g - w, 0)).max()
            scale = max(float(np.abs(np.where(fin, w, 0)).max()), 1e-30)
            worst = max(worst, float(diff) / scale)
        errs[name] = worst
        check(worst <= tol, "%s: card %.3g from the CPU, above %g"
              % (name, worst, tol))
    top = max(errs, key=errs.get)
    return {"cases": len(errs), "errors": errs, "largest": errs[top],
            "largest_case": top}


CONSISTENCY_OPS = (
    ("FullyConnected", lambda r: [r.standard_normal((512, 768)),
                                  r.standard_normal((3072, 768)) / 28,
                                  r.standard_normal(3072)],
     {"num_hidden": 3072}),
    ("Convolution", lambda r: [r.standard_normal((8, 64, 56, 56)),
                               r.standard_normal((64, 64, 3, 3)) / 24,
                               r.standard_normal(64)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64}),
    ("Pooling", lambda r: [r.standard_normal((8, 64, 112, 112))],
     {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max"}),
    ("softmax", lambda r: [r.standard_normal((512, 30522))], {"axis": -1}),
    ("log_softmax", lambda r: [r.standard_normal((512, 30522))], {}),
    ("LayerNorm", lambda r: [r.standard_normal((4096, 768)),
                             r.uniform(0.5, 1.5, 768),
                             r.uniform(-0.5, 0.5, 768)], {"eps": 1e-12}),
    # inputs scaled by fan-in as a layer's are: the check is elementwise,
    # and at a product's scale of ~30 a near-zero entry's fp32 rounding
    # (1.3e-5) passes neither its atol nor its rtol
    ("dot", lambda r: [r.standard_normal((1024, 768)),
                       r.standard_normal((768, 1024)) / 28], {}),
    ("exp", lambda r: [r.uniform(-2, 2, (4096, 768))], {}),
    ("sum", lambda r: [r.uniform(0.5, 1.5, (4096, 768))], {"axis": 1}),
    ("transpose", lambda r: [r.standard_normal((64, 512, 768))],
     {"axes": (1, 0, 2)}),
)


def numpy_consistency_and_features():
    """Part (c): ``test_utils.check_consistency`` of ten ops of the
    table, ``cpu(0)`` against ``gpu(0)`` (its default list on a machine
    with a card; the JAX package's tolerances), and
    ``runtime.Features()`` on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import runtime, test_utils
    rng = np.random.default_rng(9)
    check(test_utils.default_context() == mx.gpu(0),
          "default_context %s" % test_utils.default_context())
    ran = []
    for name, make, params in CONSISTENCY_OPS:
        inputs = [a.astype(np.float32) for a in make(rng)]
        try:
            test_utils.check_consistency(name, inputs, params)
        except AssertionError as e:
            raise SmokeFailure("check_consistency %s: %s" % (name, e))
        ran.append(name)
    feats = runtime.Features()
    want = {"CUDA": True, "CUDNN": True, "GPU": True, "KERNELS": True,
            "TPU": False, "XLA": False, "PALLAS": False}
    got = {k: feats.is_enabled(k) for k in want}
    check(got == want, "Features on the card: %s" % got)
    line = repr(feats)
    print("numpy (c) runtime.Features() on the card: %s" % line)
    return {"check_consistency": ran, "features": got, "repr": line}


def numpy_deviation_cost(chain=NUMPY_CHAIN, size=768):
    """Part (d): host microseconds an eager ``mx.np`` add, over a chain
    of ``chain`` adds on a (``size``,) array, outside and inside
    ``mx.engine.bulk(chain)`` (the sixth deviation: the same launches)."""
    import mxnet_tpu_torch as mx
    with mx.gpu(0):
        a = mx.np.ones(size)
        b = mx.np.full(size, 1e-3)

    def run():
        x = a
        for _ in range(chain):
            x = x + b
        return x

    outside = host_us(run, iters=4) / chain
    with mx.engine.bulk(chain):
        inside = host_us(run, iters=4) / chain
        last = run()
    check(np.array_equal(last.asnumpy(), run().asnumpy()),
          "a bulk scope changed the chain's result")
    return {"host_us_per_op": outside, "host_us_per_op_in_bulk": inside,
            "chain": chain, "size": size}


def numpy_phase():
    """Phase 22: the NumPy front end and the engine and runtime helpers
    (see the module docstring).  Returns the numbers and part (a)'s
    launches of every kernel."""
    import torch
    t0 = time.perf_counter()
    card = gpu_line()
    path = numpy_bert_path()
    release_cuda()
    t1 = time.perf_counter()
    cases = numpy_card_vs_cpu()
    print("numpy (b) every mx.np/npx name at user widths, card against "
          "the CPU (%d cases, %.1f s): largest %.3g (%s); %s" % (
              cases["cases"], time.perf_counter() - t1, cases["largest"],
              cases["largest_case"], json.dumps(cases["errors"])))
    release_cuda()
    consistency = numpy_consistency_and_features()
    cost = numpy_deviation_cost()
    print("numpy (d) the sixth deviation (no bulking): %s (%s)"
          % (json.dumps(cost), card))
    out = {"path": path, "cases": {k: cases[k] for k in (
               "cases", "largest", "largest_case")},
           "consistency": consistency["check_consistency"],
           "deviation": cost, "launches": path["launches"],
           "phase_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    print("numpy phase: %.1f s (%s)" % (out["phase_s"], card))
    return out


# ---------------------------------------------------------------------
# phase 23: the static half of analysis/ -- the graph check's bind gate,
# the audits of the walked AMP LARS step, the port linting itself
# ---------------------------------------------------------------------

ANALYSIS_ROOT = os.path.join(REPO_ROOT, "build", "analysis-smoke")
ANALYSIS_BATCH = DEPLOY_BATCH      # the gate binds phase 20's graph at b32
ANALYSIS_FORWARDS = 4              # counted forwards of a bind
# memory_audit's peak against torch.cuda.max_memory_allocated around the
# key's capture: the limit phase 16 holds hbm_plan to
ANALYSIS_PEAK_TOL = 0.15
ANALYSIS_LINT_TIMEOUT = 300
ANALYSIS_STEP_LABEL = "train_step:ResNetV1"
ANALYSIS_KERNELS = ("bn_relu_apply", "bn_relu_bwd", "lars_flat")
# a file that fires these rules, for the SARIF document's rule list
ANALYSIS_PLANTED = (
    "import threading, time\n"
    "def f(a=[]):\n"
    "    try:\n"
    "        return a\n"
    "    except:\n"
    "        pass\n"
    "class M(HybridBlock):\n"
    "    def hybrid_forward(self, F, x):\n"
    "        if x.sum() > 0:\n"
    "            return x.item()\n"
    "        return x\n"
    "def save_states(path, blob):\n"
    "    with open(path, 'wb') as fh:\n"
    "        fh.write(blob)\n"
    "def spin(ready, fn):\n"
    "    threading.Thread(target=fn).start()\n"
    "    while not ready():\n"
    "        time.sleep(0.1)\n"
    "def build(nn):\n"
    "    return nn.Conv2D(500, 3)\n")
ANALYSIS_PLANTED_RULES = {"mutable-default", "bare-except", "tracer-branch",
                          "host-sync", "bare-state-write", "bare-thread",
                          "sleep-poll", "layout-hostile-conv", "pad-waste"}


def analysis_lint_start(root):
    """Phase 23 (c), host-only, started beside the card work: the port's
    mxlint over its own tree (``--self --json --sarif``) and over a
    planted file (``--sarif``, for a document that lists rules).  The
    processes see no card."""
    os.makedirs(root, exist_ok=True)
    planted = os.path.join(root, "planted.py")
    with open(planted, "w") as f:
        f.write(ANALYSIS_PLANTED)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.analysis"]
    procs = {}
    for name, args in (("self", ["--self"]), ("planted", [planted])):
        procs[name] = subprocess.Popen(
            cmd + args + ["--json", "--sarif",
                          os.path.join(root, "%s.sarif" % name)],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs, time.perf_counter()


def analysis_lint_finish(procs, t0, root):
    """Phase 23 (c): ``--self`` exits 0 with no finding and a SARIF
    2.1.0 document of the port's tool; the planted file's document
    lists its rules' ids, each a rule of the port; ``audit_retrace``
    clean in this process."""
    from mxnet_tpu_torch import __version__, analysis
    res = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=ANALYSIS_LINT_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            check(False, "mxlint %s ran past %d s" % (name,
                                                      ANALYSIS_LINT_TIMEOUT))
        check(out.strip().startswith("{"), "mxlint %s printed no JSON "
              "(rc %d): %s" % (name, proc.returncode, err[-2000:]))
        payload = json.loads(out)
        with open(os.path.join(root, "%s.sarif" % name)) as f:
            sarif = json.load(f)
        res[name] = (proc.returncode, payload, sarif)
    seconds = time.perf_counter() - t0
    rc, payload, sarif = res["self"]
    by_rule = {}
    for d in payload["diagnostics"]:
        by_rule[d["rule"]] = by_rule.get(d["rule"], 0) + 1
    check(rc == 0 and payload["errors"] == 0,
          "mxlint --self on the port: rc %d, %d error(s): %s"
          % (rc, payload["errors"], payload["diagnostics"][:3]))
    tool = sarif["runs"][0]["tool"]["driver"]
    check(sarif["version"] == "2.1.0" and tool["name"] == "mxlint-torch"
          and tool["version"] == __version__
          and sarif["runs"][0]["results"] == [],
          "mxlint --self SARIF: %s" % json.dumps(sarif)[:500])
    prc, ppay, psarif = res["planted"]
    ids = {r["id"] for r in psarif["runs"][0]["tool"]["driver"]["rules"]}
    check(prc == 1 and ids == ANALYSIS_PLANTED_RULES
          and ids <= set(analysis.RULES),
          "mxlint over the planted file: rc %d, SARIF rules %s, want %s"
          % (prc, sorted(ids), sorted(ANALYSIS_PLANTED_RULES)))
    t1 = time.perf_counter()
    retrace = analysis.audit_retrace()
    retrace_s = time.perf_counter() - t1
    check(retrace == [], "audit_retrace on the port: %s"
          % [d.format() for d in retrace])
    planted_counts = {}
    for d in ppay["diagnostics"]:
        planted_counts[d["rule"]] = planted_counts.get(d["rule"], 0) + 1
    return {"lint_s": seconds, "self_rc": rc,
            "self_findings_by_rule": by_rule,
            "self_warnings": payload["warnings"],
            "sarif_rules_planted": sorted(ids),
            "planted_findings_by_rule": planted_counts,
            "retrace_s": retrace_s, "rules_registered": len(analysis.RULES)}


def _twins(sym_file):
    """Three broken twins of the exported graph, each loaded afresh: a
    BatchNorm+ReLU site's beta renamed to its gamma (a duplicate input),
    the classifier's weight annotated with a shape its input contradicts,
    and the first convolution renamed to an op the table lacks."""
    from mxnet_tpu_torch.symbol import load as sym_load
    out = {}
    sym = sym_load(sym_file)
    site = next(n for n in sym._topo() if n.op == "fused_batch_norm_relu")
    site.inputs[2][0].name = site.inputs[1][0].name
    out["duplicate-input"] = sym
    sym = sym_load(sym_file)
    fc = next(n for n in sym._topo() if n.op == "FullyConnected")
    fc.inputs[1][0].attrs["__shape__"] = "(1000, 7)"
    out["shape-contradiction"] = sym
    sym = sym_load(sym_file)
    conv = next(n for n in sym._topo() if n.op == "Convolution")
    conv.op = "Convolutionn"
    out["unknown-op"] = sym
    return out


def analysis_gate(root, make_net=resnet50_nhwc, image=224,
                  batch=ANALYSIS_BATCH, sites=BN_RELU_SITES,
                  forwards=ANALYSIS_FORWARDS, device="cuda",
                  fused_nodes=BN_RELU_SITES):
    """Phase 23 (a): ResNet-50 v1 NHWC fp32 exported by
    ``HybridBlock.export`` (phase 20's graph), bound at ``batch`` with
    ``check=True`` and again under ``MXNET_TPU_GRAPH_CHECK=1``: no error
    diagnostic, the check alone allocates nothing and launches nothing,
    each checked bind's forward bitwise the unchecked bind's, with
    ``bn_relu_apply`` = ``sites`` x forwards; three broken twins raise
    ``GraphCheckError`` naming their rule, with no launch and no
    allocation, by ``check=True`` and by the variable."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.kernels import registry
    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    kernels = registry.list_kernels()

    def allocated():
        if not cuda:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def launched():
        return sum(registry.launches(k) for k in kernels)

    net = deploy_net(make_net, image, True, device)
    x = torch.randn((batch, image, image, 3),
                    generator=torch.Generator(device=device).manual_seed(7),
                    device=device)
    net.hybridize()
    with torch.no_grad():
        for _ in range(2):
            net(x)
    prefix = os.path.join(root, "resnet50-nhwc")
    sym_file, _params_file = net.export(prefix)
    ops, _unfused = _graph_ops(sym_file)
    check(ops["fused_batch_norm_relu"] == fused_nodes,
          "exported graph holds %d fused_batch_norm_relu nodes, want %d"
          % (ops["fused_batch_norm_relu"], fused_nodes))
    del net
    gc.collect()
    if cuda:
        release_cuda()
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    shapes = {"data": tuple(x.shape)}
    out = {"batch": batch, "graph_nodes": sum(ops.values())}

    # the check alone
    registry.reset_launches()
    mem0 = allocated()
    t0 = time.perf_counter()
    diags = analysis.check_symbol(sym, shapes=shapes)
    out["check_ms"] = 1e3 * (time.perf_counter() - t0)
    out["check_alloc_delta"] = allocated() - mem0
    out["check_launches"] = launched()
    out["diagnostics"] = sorted({d.rule for d in diags})
    errors = [d.format() for d in diags if d.severity == analysis.ERROR]
    check(not errors, "graph check of the exported ResNet-50: %s"
          % errors[:3])
    check(out["check_alloc_delta"] == 0 and out["check_launches"] == 0,
          "the graph check allocated %d bytes and launched %d kernels"
          % (out["check_alloc_delta"], out["check_launches"]))

    def bind(check_arg):
        args = {k: v.as_in_context(ctx) for k, v in arg_params.items()}
        args["data"] = mx.nd.NDArray(x)
        aux = {k: v.as_in_context(ctx) for k, v in aux_params.items()}
        m0 = allocated()
        t1 = time.perf_counter()
        ex = sym.bind(ctx, args, grad_req="null", aux_states=aux,
                      check=check_arg)
        bind_ms = 1e3 * (time.perf_counter() - t1)
        delta = allocated() - m0
        with torch.no_grad():
            for _ in range(2):             # eager, capture
                ex.forward(is_train=False)
            registry.reset_launches()
            for _ in range(forwards):
                got = ex.forward(is_train=False)[0]._data.clone()
        return got, registry.launches("bn_relu_apply"), bind_ms, delta

    plain, n_plain, _ms, _d = bind(False)
    routes = {}
    for route in ("check", "env"):
        if route == "env":
            os.environ["MXNET_TPU_GRAPH_CHECK"] = "1"
        try:
            got, n, ms, delta = bind(True if route == "check" else None)
        finally:
            os.environ.pop("MXNET_TPU_GRAPH_CHECK", None)
        routes[route] = {"bind_ms": ms, "bind_alloc_delta": delta,
                         "bn_relu_apply": n,
                         "bitwise": bool(torch.equal(got, plain))}
        check(routes[route]["bitwise"], "the %s-checked bind's forward "
              "differs from the unchecked bind's" % route)
        check(n == n_plain == sites * forwards,
              "%s bind: bn_relu_apply %d launches (unchecked %d), want "
              "%d sites x %d forwards" % (route, n, n_plain, sites,
                                          forwards))
        check(delta == 0, "the %s-checked bind allocated %d bytes"
              % (route, delta))
    out["routes"] = routes
    out["bn_relu_apply_launches"] = n_plain + sum(
        r["bn_relu_apply"] for r in routes.values())
    del plain

    twins = {}
    for rule, twin in _twins(sym_file).items():
        for route in ("check", "env"):
            registry.reset_launches()
            m0 = allocated()
            if route == "env":
                os.environ["MXNET_TPU_GRAPH_CHECK"] = "1"
            err = None
            try:
                twin.simple_bind(ctx, grad_req="null",
                                 check=True if route == "check" else None,
                                 data=shapes["data"])
            except analysis.GraphCheckError as e:
                err = e
            finally:
                os.environ.pop("MXNET_TPU_GRAPH_CHECK", None)
            rec = {"raised": err is not None,
                   "rules": sorted({d.rule for d in err.diagnostics})
                   if err is not None else [],
                   "alloc_delta": allocated() - m0,
                   "launches": launched()}
            twins["%s/%s" % (rule, route)] = rec
            check(rec["raised"] and rule in rec["rules"]
                  and rule in str(err),
                  "twin %s by %s: %s" % (rule, route, rec))
            check(rec["alloc_delta"] == 0 and rec["launches"] == 0,
                  "twin %s by %s allocated %d bytes, launched %d kernels"
                  % (rule, route, rec["alloc_delta"], rec["launches"]))
    out["twins"] = twins
    return out


def analysis_audits(make_net=resnet50_nhwc, image=224, batch=LARS_BATCH,
                    device="cuda", sites=BN_RELU_SITES):
    """Phase 23 (b): the AMP LARS ResNet-50 step of BASELINE config 5
    walked (its eager warm-up, as phase 17) and captured, then
    ``perf_audit``, ``numerics_audit`` and ``memory_audit`` over its
    CostReport: each audit's numbers are the report's, the hand kernels
    appear under their own names, the casts give ``convert_share > 0``,
    the ridge is the H100's bf16 one, the memory peak within
    ``ANALYSIS_PEAK_TOL`` of ``torch.cuda.max_memory_allocated`` around
    the capture; ``diff_audit`` of each artifact against itself clean
    and against a copy with one metric grown past the tolerance a drift
    naming the step and metric."""
    import copy as _copy
    import torch
    from mxnet_tpu_torch import amp, analysis, profiling
    from mxnet_tpu_torch.analysis import memory, numerics, perf
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.profiling import roofline, store
    cuda = device == "cuda"
    profiling.reset()
    profiling.enable()
    try:
        net = make_net()
        net.initialize(device=device,
                       generator=torch.Generator().manual_seed(0))
        step = make_lars_step(net)
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((batch, image, image, 3), generator=gen,
                        device=device)
        y = torch.randint(0, net.output._units, (batch,), generator=gen,
                          device=device).float()
        registry.reset_launches()
        with amp.scope("bfloat16"):
            t0 = time.perf_counter()
            step(x, y)                       # eager, walked
            if cuda:
                torch.cuda.synchronize()
            walk_s = time.perf_counter() - t0
            warm = {k: registry.launches(k) for k in registry.list_kernels()}
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(x, y)                       # captured
            if cuda:
                torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            capture_peak = torch.cuda.max_memory_allocated() if cuda \
                else None
        t0 = time.perf_counter()
        audits = {"perf": analysis.perf_audit(),
                  "numerics": analysis.numerics_audit(),
                  "memory": analysis.memory_audit()}
        audit_s = time.perf_counter() - t0
        reps = {rep["label"]: (rep, c) for _k, rep, c in store.audited()}
    finally:
        profiling.disable()
    label = ANALYSIS_STEP_LABEL
    check(label in reps, "no CostReport for %s: %s" % (label, sorted(reps)))
    rep, _counters = reps[label]
    p = audits["perf"]["executables"][label]
    n = audits["numerics"]["executables"][label]
    m = audits["memory"]["executables"][label]
    check(p["metrics"]["flops"] == int(rep["totals"]["flops"])
          and p["metrics"]["bytes"] == int(rep["totals"]["bytes_accessed"])
          and n["metrics"]["bytes_total"] == p["metrics"]["bytes"],
          "the audits' flops/bytes differ from the CostReport's: %s vs %s"
          % (p["metrics"], rep["totals"]))
    check(all(m["metrics"][k] == rep["memory"][k] for k in (
              "argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes", "peak_hbm_bytes")),
          "memory_audit differs from the CostReport: %s vs %s"
          % (m["metrics"], rep["memory"]))
    prov = {e["op_name"]: e for e in rep["provenance"] if e.get("kernel")}
    if sites:
        for k in ANALYSIS_KERNELS:
            check(p["kernels"].get(k, 0) == prov.get(k, {}).get("bytes")
                  and p["kernels"].get(k, 0) > 0,
                  "%s: %r bytes in the perf audit, provenance %r"
                  % (k, p["kernels"].get(k), prov.get(k)))
    check(n["metrics"]["convert_share"] > 0,
          "no AMP casts in the numerics audit: %s" % n["metrics"])
    ridge = roofline.device_peaks(dtype="bfloat16")
    if cuda:
        check(audits["perf"]["peaks_assumed"] is False
              and abs(p["metrics"]["ridge_intensity"]
                      - ridge[0] / ridge[1]) < 1e-2,
              "the step's ridge %s is not the H100's bf16 %.3f"
              % (p["metrics"]["ridge_intensity"], ridge[0] / ridge[1]))
        rel = abs(m["metrics"]["peak_hbm_bytes"] - capture_peak) \
            / capture_peak
        check(rel <= ANALYSIS_PEAK_TOL,
              "memory_audit peak %d is %.3f from the capture's "
              "max_memory_allocated %d (limit %g)"
              % (m["metrics"]["peak_hbm_bytes"], rel, capture_peak,
                 ANALYSIS_PEAK_TOL))
    else:
        rel = None
    grown = {}
    for name, mod, metric in (("perf", perf, "unfused_elementwise_share"),
                              ("numerics", numerics, "convert_share"),
                              ("memory", memory, "peak_hbm_bytes")):
        art = audits[name]
        check(mod.diff_audit(art, art) == [],
              "%s diff_audit of an artifact against itself: %s"
              % (name, [d.format() for d in mod.diff_audit(art, art)]))
        big = _copy.deepcopy(art)
        mets = big["executables"][label]["metrics"]
        mets[metric] = mets[metric] * 1.5 if metric == "peak_hbm_bytes" \
            else mets[metric] + 0.05
        diags = mod.diff_audit(art, big)
        word = "peak HBM" if metric == "peak_hbm_bytes" else metric
        check(len(diags) == 1 and diags[0].rule == "%s-drift" % name
              and diags[0].node == label and word in diags[0].message,
              "%s diff_audit of a grown %s: %s"
              % (name, metric, [d.format() for d in diags]))
        grown[name] = diags[0].rule
    top = {name: [(a["kind"], a["share"]) for a in art["advisories"][:3]]
           for name, art in audits.items()}
    out = {"batch": batch, "walk_s": walk_s, "capture_s": capture_s,
           "audit_s": audit_s, "label": label,
           "perf_metrics": p["metrics"], "kernels": p["kernels"],
           "numerics_metrics": n["metrics"],
           "memory_metrics": m["metrics"],
           "capture_max_memory_allocated": capture_peak,
           "peak_rel_to_capture": rel,
           "ridge_bf16": audits["perf"]["ridge_intensity"],
           "ridge_fp32": audits["perf"]["ridge_intensity_fp32"],
           "top_advisories": top, "drift_rules": grown,
           "warm_launches": warm}
    for name, art in audits.items():
        for a in art["advisories"][:3]:
            print("analysis (b) %s advisory: %s (share %.4f): %s"
                  % (name, a["kind"], a["share"], a["message"]))
    del step, net, x, y
    profiling.reset()
    return out


def analysis_phase(root=ANALYSIS_ROOT, device="cuda", gate_kwargs=None,
                   audit_kwargs=None):
    """Phase 23: (c)'s lint started on the host, (a) the gate and (b)
    the audits on the card, then (c)'s results; returns the numbers and
    each kernel's launches over the phase.  ``gate_kwargs`` and
    ``audit_kwargs`` go to :func:`analysis_gate` and
    :func:`analysis_audits` (a narrow net on the CPU rehearses it)."""
    import torch
    from mxnet_tpu_torch.kernels import registry
    t_phase = time.perf_counter()
    card = gpu_line() if device == "cuda" else None
    shutil.rmtree(root, ignore_errors=True)
    procs, t_lint = analysis_lint_start(root)
    launches = {k: 0 for k in registry.list_kernels()}
    try:
        gate = analysis_gate(root, device=device, **(gate_kwargs or {}))
        for k in launches:
            launches[k] += registry.launches(k)
        launches["bn_relu_apply"] = gate["bn_relu_apply_launches"]
        print("analysis (a) graph check at the bind (ResNet-50 v1 NHWC "
              "fp32 exported, b%d): %s" % (gate["batch"], json.dumps(
                  dict(gate, card=card))))
        if device == "cuda":
            release_cuda()
        audits = analysis_audits(device=device, **(audit_kwargs or {}))
        for k, v in audits["warm_launches"].items():
            launches[k] += v
        print("analysis (b) audits of the walked AMP LARS step: %s"
              % json.dumps(dict(audits, card=card)))
        if device == "cuda":
            release_cuda()
        lint = analysis_lint_finish(procs, t_lint, root)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
    print("analysis (c) the port lints itself: %s"
          % json.dumps(dict(lint, card=card)))
    out = {"gate": gate, "audits": audits, "lint": lint,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print("analysis phase: %.1f s" % out["phase_s"])
    return out


# ---------------------------------------------------------------------
# phase 24: meshes and in-graph collectives (mxnet_tpu_torch.parallel)
# ---------------------------------------------------------------------

MESH_ROOT = os.path.join(REPO_ROOT, "build", "mesh-smoke")
MESH_BATCH = 32                 # (a) ResNet-50 images a rank
MESH_STEPS = 4                  # (a) eager, captured, two replays
MESH_BERT_BATCH = 8             # (b) sequences of BERT_SEQ
MESH_BERT_STEPS = 3             # (b) eager, captured, replayed
# (a) at one rank, against the same step without a mesh: norm-wise, as
# the capture holds (cuDNN deterministic; a world of one sums one
# operand, so the two steps do the same arithmetic)
MESH_HOLD_LIMIT = 1e-6
# (a) at four ranks, against the step without a mesh on the global
# batch (rank 0 alone), each quantity at the larger of its fixed limit
# and MESH_DP_FLOOR_FACTOR x its own distance in that step run on the
# permuted batch.  One step from the same weights: the loss at 1e-5
# (fixed), the update and the momenta at 2e-2 (the training oracle's), the
# BatchNorm running means and variances at 1e-4 (the training oracle's)
# -- after one step they read global-batch BatchNorm directly: a rank's
# own 32 images move them by sampling error, a correct step only by
# fp32 order.  Four steps: the losses step by step (1e-5), the weights
# without the running statistics and the momenta (2e-2), the running
# statistics (1e-4), each floor the largest over MESH_DP_PERMUTATIONS
# permuted batches; four steps at lr 0.05 carry fp32 order into every
# quantity, so one of these is held only where a planted fault
# (MESH_DP_CONTROLS, :func:`planted_fault`) moves it past its limit,
# and printed otherwise.  After the four steps every rank's weights,
# running statistics and momenta are bitwise rank 0's (the all-reduce
# gives every rank the same sums).  The real step passes every held
# check; each control fails at least one
MESH_DP_LIMIT = 2e-2
MESH_DP_FLOOR_FACTOR = 4.0
MESH_DP_LOSS_LIMIT = 1e-5
MESH_DP_STAT_LIMIT = ORACLE_LIMITS["running_stat_rel_err"]
MESH_DP_CONTROLS = ("batchnorm_per_rank", "bucket_unsummed")
MESH_DP_ONE_STEP = ("loss", "updates", "momenta", "running_mean",
                    "running_var")
MESH_DP_TRAJECTORY = ("weights", "momenta", "running_mean", "running_var")
# permuted batches of the reference's trajectory: its floor is the
# largest distance among them (a loss is one number, and 4x one draw of
# its noise fails a draw of the same noise one time in six)
MESH_DP_PERMUTATIONS = 4
# (b) bucketed_holds' rule: max(1e-5, 4 x the floor of two runs
# without a mesh); the key third of each qkv bias printed, not held
MESH_BERT_LIMIT = 1e-5
MESH_BERT_FLOOR_FACTOR = 4.0
# (c): pipeline outputs and ring/MoE against their plain math in fp32;
# the pipeline's gradients carry the flash backward's fp32 atomics
MESH_PLAIN_LIMIT = 1e-5
MESH_PIPE_GRAD_LIMIT = 1e-4
MESH_PIPE_MICRO = 4             # sequences of BERT_SEQ a microbatch
MESH_PIPE_MICROBATCHES = {1: 2, 4: 8}
MESH_RING = {1: (BERT_BATCH // 4 * BERT_HEADS, BERT_SEQ, 64),
             4: (BERT_HEADS, 16384, 64)}
MESH_MOE = dict(num_experts=8, d_model=768, d_hidden=3072)
MESH_MOE_TOKENS = 8192
MESH_KERNELS = ("bn_relu_apply", "bn_relu_bwd", "flash_attention_fwd",
                "flash_attention_bwd", "layernorm_fwd", "lamb_phase1")


def mesh_profile(fn, ranks, allreduce_bytes=None, iters=2):
    """Where ``fn()``'s device time goes over ``iters`` calls: wall ms a
    call, device busy ms, the NCCL kernels' ms and share, and the bus
    rate of the all-reduce kernels over ``allreduce_bytes`` a call
    (``2 (n - 1) / n`` times the bytes, NCCL's bus-bandwidth
    convention; 0 at one rank, where the algorithm rate is given)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    nccl_ms = sum(e.self_device_time_total for e in nccl) / 1e3 / iters
    ar_ms = sum(e.self_device_time_total for e in nccl
                if "allreduce" in e.key.lower()) / 1e3 / iters
    out = {"ms_per_call": 1e3 * wall, "device_busy_ms": busy,
           "collective_ms": nccl_ms,
           "collective_share": nccl_ms / busy if busy else 0.0,
           "nccl_kernels": sorted({e.key[:48] for e in nccl})}
    if allreduce_bytes:
        sec = ar_ms / 1e3
        out["allreduce_ms"] = ar_ms
        out["allreduce_alg_gb_s"] = allreduce_bytes / sec / 1e9 \
            if sec else None
        out["allreduce_bus_gb_s"] = allreduce_bytes * 2 * (ranks - 1) \
            / ranks / sec / 1e9 if sec else None
    return out


def _single_device(ranks, device=None):
    """The mesh a reference step runs on: None in a world of one (the
    step without a mesh), else rank 0 alone (every rank makes it)."""
    from mxnet_tpu_torch.parallel import make_mesh
    return None if ranks == 1 else make_mesh({"dp": 1}, devices=[0],
                                             device=device)


def _full(t, sharding):
    """The whole value of ``t``, this rank's shard under ``sharding``
    (gathered over the mesh; ``t`` itself when replicated)."""
    import torch
    from mxnet_tpu_torch.parallel import collectives
    if sharding is None or sharding.is_replicated:
        return t.detach()
    spec = tuple(sharding.spec)
    dim = next(d for d, a in enumerate(spec) if a is not None)
    with torch.no_grad():
        return collectives._gather(t.detach(), sharding.mesh, spec[dim], dim)


@contextlib.contextmanager
def planted_fault(kind):
    """A data-parallel fault patched into ``TrainStep`` for the scope,
    one of MESH_DP_CONTROLS: ``"batchnorm_per_rank"`` hands no
    BatchNorm site the step's batch axis, so each rank normalizes by its
    own slice's statistics; ``"bucket_unsummed"`` leaves the smallest
    fp32 gradient bucket out of the all-reduce, so its gradients are
    this rank's alone.  (a)'s controls: a rule that passes them has no
    teeth."""
    import torch
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel.data_parallel import TrainStep
    if kind == "batchnorm_per_rank":
        name = "_batch_synced"

        def patched(self):
            return contextlib.nullcontext()
    elif kind == "bucket_unsummed":
        name = "_all_reduce_grads"
        reduce_grads = TrainStep._all_reduce_grads

        def patched(self, grads, loss):
            real = collectives.all_reduce_
            sizes = []

            def sizing(t, *args, **kwargs):
                # the bucket layout: the step's own bucketing, every
                # reduce an identity (the gradients are written back
                # unchanged)
                sizes.append(t.numel() if t.dtype == torch.float32
                             else float("inf"))
                return t

            calls = [0]

            def skipping(t, *args, **kwargs):
                calls[0] += 1
                if calls[0] - 1 == skip:
                    return t
                return real(t, *args, **kwargs)

            collectives.all_reduce_ = sizing
            try:
                reduce_grads(self, grads, loss)
            finally:
                collectives.all_reduce_ = real
            skip = sizes.index(min(sizes))
            collectives.all_reduce_ = skipping
            try:
                return reduce_grads(self, grads, loss)
            finally:
                collectives.all_reduce_ = real
    else:
        raise ValueError("planted_fault: unknown fault %r" % kind)
    original = getattr(TrainStep, name)
    setattr(TrainStep, name, patched)
    try:
        yield
    finally:
        setattr(TrainStep, name, original)


def mesh_dp_run(make_net, step_mesh, xb, yb, steps=MESH_STEPS,
                device="cuda", first=False, counting=False):
    """``steps`` calls of ``TrainStep(mesh=step_mesh)`` (SGD, TRAIN_SGD)
    on ``(xb, yb)`` from ``make_net()`` initialized from seed 0:
    ``(out, step)``, ``out`` the losses and, after the last step (and
    with ``first`` after step 1 under ``"first"``), the updates of every
    parameter, the weights without the BatchNorm running statistics,
    the running means, the running variances and the momenta; the wall
    seconds of the replays after the capture (the collective counts
    zeroed before them).  With ``counting`` the kernels' launch counts are
    zeroed just before the first step."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import TrainStep, collectives
    net = make_net()
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(0))
    xb, yb = torch.as_tensor(xb).to(device), torch.as_tensor(yb).to(device)
    with autograd.pause():
        net(xb[:1])                     # sizes deferred parameters
    params = list(net.collect_params().items())
    w0 = [p.data()._data.detach().clone() for _k, p in params]
    tr = gluon.Trainer(net.collect_params(), "sgd", TRAIN_SGD)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                     mesh=step_mesh)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def state(losses):
        data = [(k, p.data()._data.detach()) for k, p in params]
        return {"losses": [float(v) for v in losses],
                "updates": [t - w for (_k, t), w in zip(data, w0)],
                "weights": [t.clone() for (k, t), (_k, p) in zip(data,
                                                                 params)
                            if p.grad_req != "null"],
                "running_mean": [t.clone() for k, t in data
                                 if k.endswith("running_mean")],
                "running_var": [t.clone() for k, t in data
                                if k.endswith("running_var")],
                "momenta": [tr._updater.states[i].detach().clone()
                            for i in sorted(tr._updater.states)]}

    if counting:
        registry.reset_launches()
    losses, t0, after_first = [], time.perf_counter(), None
    for k in range(steps):
        if k == 2:
            sync()
            collectives.reset_counts()
            t0 = time.perf_counter()
        losses.append(step(xb, yb))
        if first and k == 0:
            after_first = state(losses)
    sync()
    out = dict(state(losses), wall_s=time.perf_counter() - t0)
    if after_first is not None:
        out["first"] = after_first
    return out, step


def mesh_dp_replicas(state, ranks):
    """How many ranks hold another state than rank 0 after a data-
    parallel run (:func:`mesh_dp_run`'s ``state``: every weight, running
    statistic and momentum): each rank's sha256 of their bytes, gathered
    by a host all-reduce of one row a rank.  A step whose every gradient
    and moment is summed over the ranks keeps the replicas bitwise
    equal."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch import distributed
    h = hashlib.sha256()
    for key in ("weights", "running_mean", "running_var", "momenta"):
        for t in state[key]:
            h.update(t.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
    rows = torch.zeros((ranks, 32), dtype=torch.int64)
    rows[dist.get_rank()] = torch.frombuffer(bytearray(h.digest()),
                                             dtype=torch.uint8).long()
    rows = distributed.host_allreduce(rows)
    return int(sum(not torch.equal(r, rows[0]) for r in rows[1:]))


def mesh_dp_distances(run, want, perms):
    """Each quantity of ``run`` (:func:`mesh_dp_run`'s) against
    ``want``'s, the step without a mesh on the global batch, beside the
    largest distance of that step run on each permuted batch of
    ``perms``: ``{quantity: [distance, floor]}``, the losses step by
    step, the rest norm-wise relative."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    out = {}
    for k, b in enumerate(want["losses"]):
        out["loss_step%d" % (k + 1)] = [
            rel(run["losses"][k], b),
            max(rel(p["losses"][k], b) for p in perms)]
    for key in ("updates", "weights", "momenta", "running_mean",
                "running_var"):
        out[key] = [_norm_rel(run[key], want[key]),
                    max(_norm_rel(p[key], want[key]) for p in perms)]
    return out


def mesh_dp_limit(quantity, floor):
    """(a)'s limit of ``quantity`` at its own permuted ``floor``."""
    fixed = MESH_DP_LOSS_LIMIT if quantity.startswith("loss") \
        else MESH_DP_STAT_LIMIT if quantity.startswith("running") \
        else MESH_DP_LIMIT
    return max(fixed, MESH_DP_FLOOR_FACTOR * floor)


def mesh_dp_rule(runs, refs):
    """(a)'s rule at dp > 1.  ``runs`` maps ``"real"`` and each control
    of MESH_DP_CONTROLS to ``{"one": its state after one step from the
    same weights, "four": after the four steps, "replicas": the ranks
    whose state then differs from rank 0's}``; ``refs`` maps ``"one"``
    and ``"four"`` to ``(want, [permuted, ...])``, the step without a
    mesh on the global batch and on permuted batches.  Returns
    ``{"one_step": {...}, "trajectory": {...}, "replicas": {...}}``,
    each ``{quantity: {"floor", "limit", "held", "real", <control>...}}``
    (distances): every one-step quantity of MESH_DP_ONE_STEP is held,
    the loss at its fixed 1e-5; a trajectory quantity is held where some
    control's distance passes its limit; the replicas are held equal."""
    table = {}
    for when, names in (("one", MESH_DP_ONE_STEP), ("four", None)):
        want, perms = refs[when]
        dists = {who: mesh_dp_distances(r[when], want, perms)
                 for who, r in runs.items()}
        if names is not None:
            for d in dists.values():
                d["loss"] = d.pop("loss_step1")
        rows = {}
        for q, (_d, floor) in dists["real"].items():
            if q not in (names or MESH_DP_TRAJECTORY) \
                    and not q.startswith("loss_step"):
                continue
            limit = MESH_DP_LOSS_LIMIT if q == "loss" \
                else mesh_dp_limit(q, floor)
            row = {"floor": floor, "limit": limit}
            row.update({who: d[q][0] for who, d in dists.items()})
            row["held"] = names is not None or any(
                row[c] > limit for c in runs if c != "real")
            rows[q] = row
        table["one_step" if names is not None else "trajectory"] = rows
    row = {"floor": 0, "limit": 0, "held": True}
    row.update({who: r["replicas"] for who, r in runs.items()})
    table["replicas"] = {"ranks_differing": row}
    return table


def mesh_dp_failures(table):
    """``{run: [held quantities it fails]}`` of :func:`mesh_dp_rule`'s
    table, for the real step and each control."""
    whos = [k for k in next(iter(table["one_step"].values()))
            if k not in ("floor", "limit", "held")]
    return {who: ["%s %s" % (when, q) for when, rows in table.items()
                  for q, row in rows.items()
                  if row["held"] and row[who] > row["limit"]]
            for who in whos}


def mesh_dp_resnet(ranks, rank, res=None):
    """(a) ResNet-50 v1 NHWC fp32 SGD, ``TrainStep(mesh=make_mesh({"dp":
    ranks}))`` at MESH_BATCH a rank, captured; held against the same
    step without a mesh on the global batch (on rank 0).  At one rank
    the two are the same arithmetic (MESH_HOLD_LIMIT); at more,
    :func:`mesh_dp_rule`, shown to have teeth by the two planted faults
    of MESH_DP_CONTROLS, each run through the same steps, each of which
    must fail a held check."""
    import torch
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import collectives, make_mesh
    mesh = make_mesh({"dp": ranks})
    gen = torch.Generator().manual_seed(0)
    n = MESH_BATCH * ranks
    x = torch.randn((n, 224, 224, 3), generator=gen)
    y = torch.randint(0, 1000, (n,), generator=gen).float()

    def run(step_mesh, xb, yb, **kw):
        return mesh_dp_run(resnet50_nhwc, step_mesh, xb, yb, **kw)[0]

    sl = slice(rank * MESH_BATCH, (rank + 1) * MESH_BATCH)
    got, step = mesh_dp_run(resnet50_nhwc, mesh, x[sl], y[sl],
                            counting=True)
    got["calls"] = collectives.counts()
    got["launches"] = {k: registry.launches(k)
                       for k in ("bn_relu_apply", "bn_relu_bwd")}
    sites = len(got["running_mean"])    # a BatchNorm site a running mean
    walk = step.cost_report()["categories"]["collective"]["instructions"]
    capture = step.capture_stats()
    xg, yg = x[sl].cuda(), y[sl].cuda()
    profile = mesh_profile(
        lambda: step(xg, yg), ranks,
        got["calls"]["all_reduce"]["bytes"] / (MESH_STEPS - 2))
    buckets = step._buckets
    del step, xg, yg
    replays = MESH_STEPS - 2
    per_replay = sum(v["calls"] for v in got["calls"].values()) / replays
    res = {} if res is None else res
    res.update({"ranks": ranks, "batch_a_rank": MESH_BATCH,
                "steps": MESH_STEPS,
                "losses": got["losses"],
                "collectives_a_replay": per_replay,
                "collectives_walked": walk,
                "gradient_buckets": buckets, "batchnorm_sites": sites,
                "calls": got["calls"], "launches": got["launches"],
                "graphs": capture["graphs"], "replays": capture["replays"],
                "profile": profile,
                "img_per_s": MESH_BATCH * ranks * replays / got["wall_s"],
                "ms_per_step": 1e3 * got["wall_s"] / replays})
    check(per_replay > 0, "mesh (a): no collective in a replay")
    check(per_replay == walk == buckets + 2 * sites,
          "mesh (a): %s collectives a replay, %s walked, %d buckets + 2 x "
          "%d BatchNorm sites" % (per_replay, walk, buckets, sites))
    for k, v in got["launches"].items():
        check(v == BN_RELU_SITES * MESH_STEPS, "mesh (a): %s launches %d "
              "!= %d x %d" % (k, v, BN_RELU_SITES, MESH_STEPS))
    ref_mesh = _single_device(ranks)
    if ranks == 1:
        want = run(ref_mesh, x, y)
        res["ms_per_step_without_mesh"] = 1e3 * want["wall_s"] / replays
        res["losses_without_mesh"] = want["losses"]
        res["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
            got["losses"], want["losses"]))
        for key in ("weights", "momenta", "running_mean", "running_var"):
            res["%s_rel_err" % key] = _norm_rel(got[key], want[key])
        res["limit"] = MESH_HOLD_LIMIT
        print("mesh (a) against the step without a mesh: %s" % json.dumps(
            {k: res[k] for k in (
                "losses", "losses_without_mesh", "loss_rel_err",
                "weights_rel_err", "momenta_rel_err", "running_mean_rel_err",
                "running_var_rel_err", "limit")}), flush=True)
        for key in ("loss", "weights", "momenta", "running_mean",
                    "running_var"):
            check(res["%s_rel_err" % key] <= MESH_HOLD_LIMIT,
                  "mesh (a): %s off by %.3g" % (key,
                                                res["%s_rel_err" % key]))
        return res
    # every rank runs the collective steps first -- one step from the
    # same weights, then each planted fault through the four steps --
    # and rank 0 its references after them
    runs = {"real": {"one": run(mesh, x[sl], y[sl], steps=1),
                     "four": got, "replicas": mesh_dp_replicas(got, ranks)}}
    for kind in MESH_DP_CONTROLS:
        with planted_fault(kind):
            four = run(mesh, x[sl], y[sl], first=True)
        runs[kind] = {"one": four.pop("first"), "four": four,
                      "replicas": mesh_dp_replicas(four, ranks)}
        if rank != 0:
            del runs[kind]
    if rank != 0:
        return res
    perm1 = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    perms = [torch.randperm(n, generator=gen)] + [
        torch.randperm(n, generator=torch.Generator().manual_seed(100 + k))
        for k in range(MESH_DP_PERMUTATIONS - 1)]
    refs = {"one": (run(ref_mesh, x, y, steps=1),
                    [run(ref_mesh, x[perm1], y[perm1], steps=1)])}
    want = run(ref_mesh, x, y)
    refs["four"] = (want, [run(ref_mesh, x[p], y[p]) for p in perms])
    table = mesh_dp_rule(runs, refs)
    fails = mesh_dp_failures(table)
    res.update({"ms_per_step_without_mesh": 1e3 * want["wall_s"] / replays,
                "losses_without_mesh": want["losses"],
                "losses_permuted": [p["losses"] for p in refs["four"][1]],
                "controls": {c: runs[c]["four"]["losses"]
                             for c in MESH_DP_CONTROLS},
                "rule": table, "failed_checks": fails})
    del runs, refs, want
    for when, rows in table.items():
        what = "ranks whose weights, running statistics and momenta " \
            "differ from rank 0's after the four steps" \
            if when == "replicas" else "distance from the step without " \
            "a mesh"
        print("mesh (a) %s (%s, of the real step and of each planted "
              "fault; floor; limit; held): %s"
              % (when.replace("_", " "), what, json.dumps(rows)), flush=True)
    print("mesh (a) held checks failed: %s" % json.dumps(fails), flush=True)
    check(not fails["real"], "mesh (a): the dp step fails %s"
          % ", ".join(fails["real"]))
    for kind in MESH_DP_CONTROLS:
        check(fails[kind], "mesh (a): the planted fault %s passes every "
              "held check: the rule has no teeth there" % kind)
    return res


def _qkv_split(init, units):
    """``{structural name: value}`` of a tensor-parallel BERT from the
    plain BERT's ``init``: each fused qkv tensor's thirds."""
    out = {}
    for name, t in init.items():
        if "qkv_" in name:
            kind = name.rpartition("_")[2]
            base = name[:-len("qkv_" + kind)]
            for i, part in enumerate(("query", "key", "value")):
                out["%s%s_%s" % (base, part, kind)] = \
                    t[i * units:(i + 1) * units]
        else:
            out[name] = t
    return out


def mesh_tp_bert(ranks, rank, res=None):
    """(b) BERT-base, ``tp_mesh=make_mesh({"tp": ranks})`` and
    ``shard_tp``, LAMB over MESH_BERT_BATCH x BERT_SEQ, captured; held
    at bucketed_holds' rule against the same model unsharded (tp mode,
    its q/k/v separate tensors, so LAMB's per-tensor trust ratios are
    the same ones) on rank 0.  Both start from the plain BERT's seeded
    weights, each qkv tensor cut in thirds."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import TrainStep, collectives, make_mesh
    mesh = make_mesh({"tp": ranks})
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, BERT_VOCAB, (MESH_BERT_BATCH, BERT_SEQ),
                        generator=gen).float().cuda()
    labels = torch.randint(0, BERT_VOCAB, ids.shape,
                           generator=gen).float().cuda()
    plain = bert_base_net(dropout=0.0)
    plain.initialize(device="cuda", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        plain(ids[:1])
    init = _qkv_split({k: p.data()._data.detach().clone() for k, p in
                       plain._collect_params_with_prefix().items()}, 768)
    del plain

    def tp_net(shard):
        net = bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                        dropout=0.0, tp_mesh=mesh)
        net.initialize(device="cuda")
        with autograd.pause():
            net(ids[:1])
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(init[k])
        return net.shard_tp() if shard else net

    def run(net, step_mesh, counting=False):
        tr = gluon.Trainer(net.collect_params(), "lamb", dict(BERT_LAMB))
        step = TrainStep(net, make_mlm_loss(BERT_VOCAB), tr, mesh=step_mesh)
        params = net._collect_params_with_prefix()
        w0 = {k: _full(p._data, p._sharding).clone()
              for k, p in params.items()}
        if counting:
            registry.reset_launches()
            collectives.reset_counts()
        t0 = time.perf_counter()
        losses = [step(ids, labels) for _ in range(MESH_BERT_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = collectives.counts()        # the steps' own
        index = {id(p): i for i, p in enumerate(tr._params)}
        states = []
        for k, p in params.items():
            st = tr._updater.states.get(index[id(p)])
            if st is not None:
                # copies: the profile below runs more steps in place
                states += [_full(t, p._sharding).clone() for t in st]
        out = {"losses": [float(v) for v in losses],
               "update": {k: _full(p._data, p._sharding) - w0[k]
                          for k, p in params.items()},
               "states": states, "wall_s": wall,
               "capture": step.capture_stats()}
        if counting:
            out["launches"] = {k: registry.launches(k) for k in (
                "flash_attention_fwd", "flash_attention_bwd",
                "layernorm_fwd", "lamb_phase1")}
            out["calls"] = calls
            out["profile"] = mesh_profile(lambda: step(ids, labels), ranks)
        return out

    got = run(tp_net(True), mesh, counting=True)
    release_cuda()
    launches = got["launches"]
    res = {} if res is None else res
    res.update({"ranks": ranks, "batch": MESH_BERT_BATCH, "seq": BERT_SEQ,
                "heads_a_rank": BERT_HEADS // ranks, "losses": got["losses"],
                "launches": launches, "calls": got["calls"],
                "graphs": got["capture"]["graphs"],
                "replays": got["capture"]["replays"],
                "profile": got["profile"],
                "tokens_per_s": MESH_BERT_BATCH * BERT_SEQ * MESH_BERT_STEPS
                / got["wall_s"]})
    want_launches = {"flash_attention_fwd": BERT_LAYERS * MESH_BERT_STEPS,
                     "flash_attention_bwd": BERT_LAYERS * MESH_BERT_STEPS,
                     "layernorm_fwd": (2 * BERT_LAYERS + 2)
                     * MESH_BERT_STEPS,
                     "lamb_phase1": MESH_BERT_STEPS}
    check(launches == want_launches, "mesh (b): launches %s != %s"
          % (launches, want_launches))
    ref_mesh = _single_device(ranks)
    if rank == 0:
        want = run(tp_net(False), ref_mesh)
        again = run(tp_net(False), ref_mesh)

        def errors(a, b):
            # the key bias apart: its exact gradient is 0 (softmax
            # ignores a shift of a row), so LAMB normalizes noise
            names = sorted(k for k in b["update"]
                           if not k.endswith("key_bias"))
            keys = sorted(k for k in b["update"] if k.endswith("key_bias"))
            return {"loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                        a["losses"], b["losses"])),
                    "update_rel_err": _norm_rel(
                        [a["update"][k] for k in names],
                        [b["update"][k] for k in names]),
                    "states_rel_err": _norm_rel(a["states"], b["states"]),
                    "key_bias_update_rel_err": _norm_rel(
                        [a["update"][k] for k in keys],
                        [b["update"][k] for k in keys])}
        res.update(errors(got, want))
        res["floor"] = errors(again, want)
        res["limits"] = {k: max(MESH_BERT_LIMIT,
                                MESH_BERT_FLOOR_FACTOR * res["floor"][k])
                         for k in ("loss_rel_err", "update_rel_err",
                                   "states_rel_err")}
        print("mesh (b) against the model unsharded: %s" % json.dumps(
            {k: res[k] for k in ("loss_rel_err", "update_rel_err",
                                 "states_rel_err", "key_bias_update_rel_err",
                                 "floor", "limits")}), flush=True)
        for k, limit in res["limits"].items():
            check(res[k] <= limit, "mesh (b): %s %.3g > %.3g"
                  % (k, res[k], limit))
    return res


def _bert_layer(p, i, x, heads=BERT_HEADS):
    """Layer ``i`` of a stage of BERT-base layers (post-LN, the
    encoder cell's math) through the port's ops: the flash kernels and
    the LayerNorm kernel on the card."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import ops
    b, s, d = x.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, s, heads, hd).permute(0, 2, 1, 3) \
            .reshape(b * heads, s, hd)
    q, k, v = F.linear(x, p["qkv_w"][i], p["qkv_b"][i]).split(d, dim=-1)
    ctx = ops.flash_attention(split(q), split(k), split(v))
    ctx = ctx.reshape(b, heads, s, hd).permute(0, 2, 1, 3).reshape(b, s, d)
    x = ops.LayerNorm(x + F.linear(ctx, p["out_w"][i], p["out_b"][i]),
                      p["ln1_g"][i], p["ln1_b"][i])
    h = F.gelu(F.linear(x, p["ffn1_w"][i], p["ffn1_b"][i]))
    return ops.LayerNorm(x + F.linear(h, p["ffn2_w"][i], p["ffn2_b"][i]),
                         p["ln2_g"][i], p["ln2_b"][i])


def _bert_layers(gen, n, d=768, hidden=3072):
    """``n`` layers' weights, stacked on a leading layer axis (CPU)."""
    import torch

    def w(*shape, scale=0.02):
        return torch.randn(shape, generator=gen) * scale
    return {"qkv_w": w(n, 3 * d, d), "qkv_b": w(n, 3 * d),
            "out_w": w(n, d, d), "out_b": w(n, d),
            "ln1_g": 1 + w(n, d, scale=0.1), "ln1_b": w(n, d),
            "ffn1_w": w(n, hidden, d), "ffn1_b": w(n, hidden),
            "ffn2_w": w(n, d, hidden), "ffn2_b": w(n, d),
            "ln2_g": 1 + w(n, d, scale=0.1), "ln2_b": w(n, d)}


def mesh_pipeline(ranks, rank, res=None):
    """(c) ``pipeline_apply`` over ``{"pp": ranks}``: BERT-base's 12
    layers, 12 / ranks a stage, microbatches of MESH_PIPE_MICRO x
    BERT_SEQ, forward and backward of sum(out ** 2), against the layers
    applied in sequence (each microbatch's backward in turn)."""
    import torch
    from mxnet_tpu_torch.parallel import (collectives, make_mesh,
                                          pipeline_apply,
                                          shard_stacked_params,
                                          stack_stage_params)
    mesh = make_mesh({"pp": ranks})
    L = BERT_LAYERS // ranks
    M = MESH_PIPE_MICROBATCHES[ranks]
    gen = torch.Generator().manual_seed(7)
    layers = _bert_layers(gen, BERT_LAYERS)
    xs = torch.randn((M, MESH_PIPE_MICRO, BERT_SEQ, 768), generator=gen) \
        .cuda()
    stages = [{k: v[s * L:(s + 1) * L] for k, v in layers.items()}
              for s in range(ranks)]
    placed = shard_stacked_params(
        {k: v.cuda() for k, v in stack_stage_params(stages).items()}, mesh)
    for leaf in placed.values():
        leaf.requires_grad_(True)

    def stage_fn(p, x):
        for i in range(L):
            x = _bert_layer(p, i, x)
        return x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_apply(stage_fn, placed, xs, mesh)
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the reference: every layer in sequence, on this rank
    full = {k: v.cuda().requires_grad_(True) for k, v in layers.items()}
    want = []
    for m in range(M):
        y = xs[m]
        for i in range(BERT_LAYERS):
            y = _bert_layer(full, i, y)
        (y ** 2).sum().backward()
        want.append(y.detach())
    want = torch.stack(want)
    mine = slice(rank * L, (rank + 1) * L)
    errs = torch.tensor([
        _norm_rel([out.detach()], [want]),
        _norm_rel([placed[k].grad[0] for k in sorted(placed)],
                  [full[k].grad[mine] for k in sorted(placed)])],
        device="cuda", dtype=torch.float64)
    collectives.all_reduce_(errs, mesh, "pp", op="max")
    def fwd_bwd():
        out = pipeline_apply(stage_fn, placed, xs, mesh)
        (out ** 2).sum().backward()
    res = {} if res is None else res
    res.update({"ranks": ranks, "layers_a_stage": L, "microbatches": M,
                "microbatch": [MESH_PIPE_MICRO, BERT_SEQ],
                "out_rel_err": float(errs[0]), "grad_rel_err": float(errs[1]),
                "fwd_bwd_ms": 1e3 * wall,
                "bubble": (ranks - 1) / (M + ranks - 1),
                "profile": mesh_profile(fwd_bwd, ranks)})
    check(res["out_rel_err"] <= MESH_PLAIN_LIMIT,
          "mesh (c) pipeline: outputs off by %.3g" % res["out_rel_err"])
    check(res["grad_rel_err"] <= MESH_PIPE_GRAD_LIMIT,
          "mesh (c) pipeline: gradients off by %.3g" % res["grad_rel_err"])
    return res


def _attention_rows(q, k, v, row0, causal):
    """Plain fp32 attention of the query rows ``q`` (global rows from
    ``row0``) over all of ``k``/``v``, in query chunks."""
    import torch
    outs = []
    scale = 1.0 / q.shape[-1] ** 0.5
    cols = torch.arange(k.shape[1], device=q.device)
    for c in range(0, q.shape[1], 1024):
        qc = q[:, c:c + 1024]
        s = torch.bmm(qc, k.transpose(1, 2)) * scale
        if causal:
            rows = row0 + c + torch.arange(qc.shape[1], device=q.device)
            s = s.masked_fill(rows[:, None] < cols[None, :], float("-inf"))
        outs.append(torch.bmm(torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=1)


def mesh_ring(ranks, rank, res=None):
    """(c) ``ring_attention`` over ``{"sp": ranks}`` at BERT-base's
    heads, against plain attention of this rank's rows."""
    import torch
    from mxnet_tpu_torch.parallel import (collectives, make_mesh,
                                          ring_attention)
    mesh = make_mesh({"sp": ranks})
    bh, seq, d = MESH_RING[ranks]
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((bh, seq, d), generator=gen).cuda()
               for _ in range(3))
    n = seq // ranks
    sl = slice(rank * n, (rank + 1) * n)
    res = {} if res is None else res
    res.update({"ranks": ranks, "bh": bh, "seq": seq, "d": d})
    for causal in ((False, True) if ranks == 1 else (True,)):
        got = ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh,
                             causal=causal)
        want = _attention_rows(q[:, sl], k, v, rank * n, causal)
        err = torch.tensor([_norm_rel([got], [want])], device="cuda",
                           dtype=torch.float64)
        collectives.all_reduce_(err, mesh, "sp", op="max")
        res["rel_err_causal" if causal else "rel_err"] = float(err)
    res["profile"] = mesh_profile(
        lambda: ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh,
                               causal=True), ranks)
    for key in ("rel_err", "rel_err_causal"):
        if key in res:
            check(res[key] <= MESH_PLAIN_LIMIT, "mesh (c) ring: %s %.3g"
                  % (key, res[key]))
    return res


def mesh_moe(ranks, rank, res=None):
    """(c) ``MixtureOfExperts`` (8 experts, 768/3,072) over ``{"ep":
    ranks}``: tokens replicated at one rank, split over ``ep`` at
    more, against the layer's unsharded forward on all tokens."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.parallel import (MixtureOfExperts, collectives,
                                          make_mesh, shard_batch)
    mesh = make_mesh({"ep": ranks})
    moe = MixtureOfExperts(mesh=mesh, **MESH_MOE)
    moe.initialize(device="cuda", generator=torch.Generator().manual_seed(9))
    x = torch.randn((MESH_MOE_TOKENS, 768),
                    generator=torch.Generator().manual_seed(10)).cuda()
    with autograd.pause():
        want = moe(x)
        moe.shard(mesh)
        n = MESH_MOE_TOKENS // ranks
        mine = slice(rank * n, (rank + 1) * n)
        if ranks == 1:
            got = moe(x)
        else:
            got = moe(shard_batch(x[mine], mesh, axis_name="ep"))
            got = getattr(got, "_data", got)
            want = want[mine]
    err = torch.tensor([_norm_rel([got], [want])], device="cuda",
                       dtype=torch.float64)
    collectives.all_reduce_(err, mesh, "ep", op="max")
    with autograd.pause():
        xin = x if ranks == 1 else shard_batch(x[mine], mesh, axis_name="ep")
        prof = mesh_profile(lambda: moe(xin), ranks)
    res = {} if res is None else res
    res.update({"ranks": ranks, "tokens": MESH_MOE_TOKENS,
                "tokens_split": ranks > 1, "rel_err": float(err),
                "profile": prof})
    check(res["rel_err"] <= MESH_PLAIN_LIMIT, "mesh (c) MoE: off by %.3g"
          % res["rel_err"])
    return res


def mesh_checkpoint(ranks, rank, root):
    """(c) A ``TensorParallelMLP`` (768 -> 3,072 -> 768) placed over
    ``{"tp": ranks}``, saved, restored with ``restore(sharding=)`` at
    ``tp = min(ranks, 2)`` and whole: every shard bitwise."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import (NamedSharding, TensorParallelMLP,
                                          make_mesh)
    mesh = make_mesh({"tp": ranks})
    mlp = TensorParallelMLP(3072, 768, mesh=mesh)
    mlp.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(11))
    with autograd.pause():
        mlp(torch.zeros((1, 768)).cuda())
    full = {k: p.data()._data.detach().clone()
            for k, p in mlp._collect_params_with_prefix().items()}
    mlp.shard(mesh)
    specs = {k: p._sharding.spec
             for k, p in mlp._collect_params_with_prefix().items()}
    t0 = time.perf_counter()
    CheckpointManager(root).save_training(1, mlp)
    save_s = time.perf_counter() - t0
    tp = min(ranks, 2)
    back = make_mesh({"dp": ranks // tp, "tp": tp})
    t0 = time.perf_counter()
    ckpt = CheckpointManager(root).restore(
        sharding=lambda item, key, shape: NamedSharding(back, specs[key]))
    restore_s = time.perf_counter() - t0
    whole = CheckpointManager(root).restore()
    ok = all(torch.equal(
        ckpt.items["params"][k]._data,
        full[k][NamedSharding(back, specs[k]).local_slices(full[k].shape)])
        and torch.equal(whole.items["params"][k]._data.cuda(), full[k])
        for k in full)
    res = {"saved_at_tp": ranks, "restored_at_tp": tp, "whole": True,
           "bitwise": bool(ok), "save_s": save_s, "restore_s": restore_s,
           "bytes": sum(t.numel() * t.element_size() for t in full.values())}
    check(ok, "mesh (c) checkpoint: a restored shard differs")
    return res


def run_world(code, ranks, timeout, env=None, grace=30, echo=None,
              log=None):
    """Run ``python -c code`` as a world of ``ranks`` processes
    (``python -m mxnet_tpu_torch.launch -n ranks``) and return its
    output's lines.  Each line of the launcher's output (``[rank] ...``)
    is passed to ``echo`` (by default printed, flushed) as it arrives
    and appended to the file ``log``, so a world cut at a bound has
    shown each rank's last line.  At ``timeout`` seconds the world is
    stopped -- SIGINT to the launcher, which tears its workers down,
    then a kill of the launcher and its workers after ``grace``
    seconds -- and :class:`SmokeFailure` names each rank's last line.
    Before that each worker is sent SIGUSR1, on which a worker that
    called :func:`dump_stacks_on_signal` prints its threads' Python
    stacks (one that did not ends there).  A world that exits nonzero
    fails with its tail."""
    import signal
    echo = echo or (lambda line: print(line, end="", flush=True))
    lines, last = [], {}
    sink = open(log, "a") if log else None
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(ranks),
         sys.executable, "-c", code], cwd=REPO_ROOT,
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, errors="replace")

    def relay():
        for line in proc.stdout:
            echo(line)
            lines.append(line)
            if sink is not None:
                sink.write(line)
                sink.flush()
            if line.startswith("[") and "] " in line:
                last[line[1:line.index("]")]] = line.rstrip("\n")
    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    cut, named = False, last
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        cut = True
        named = dict(last)      # before the stacks, each rank's own
        for pid in _children(proc):
            try:
                os.kill(pid, signal.SIGUSR1)
            except ProcessLookupError:
                pass
        time.sleep(3)           # the dumps reach the relay
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            _kill_with_children(proc)
    reader.join(timeout=grace)
    if sink is not None:
        sink.close()
    lasts = "\n".join("  rank %s: %s" % (r, named[r])
                      for r in sorted(named, key=lambda r: (len(r), r)))
    check(not cut, "world of %d ran past its %d s bound and was stopped; "
          "each rank's last line:\n%s" % (ranks, timeout, lasts or
                                          "  (none)"))
    check(proc.returncode == 0, "world of %d exited %d; each rank's last "
          "line:\n%s\nits last output:\n%s" % (
              ranks, proc.returncode, lasts or "  (none)",
              "".join(lines[-60:])))
    return lines


def _children(proc):
    """The pids of ``proc``'s children (the launcher's workers)."""
    try:
        with open("/proc/%d/task/%d/children" % (proc.pid, proc.pid)) as f:
            return [int(k) for k in f.read().split()]
    except OSError:
        return []


def dump_stacks_on_signal():
    """On SIGUSR1, print every thread's Python stack to stderr (a
    world's worker: :func:`run_world` sends it at the bound)."""
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1, all_threads=True)


def _kill_with_children(proc):
    """SIGKILL ``proc`` and the process groups of its children (the
    launcher starts each worker in a session of its own)."""
    import signal
    for pid in _children(proc):
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    proc.kill()
    proc.wait()


# ---------------------------------------------------------------------
# the NCCL probe of a world of four cards (chip_paths.py nccl4)
# ---------------------------------------------------------------------

NCCL_PROBE_LOG = os.path.join(REPO_ROOT, "build", "nccl4.log")
NCCL_PROBE_ELEMS = 1 << 22         # 16 MiB of fp32 a collective
_PROBE_KEPT = []                   # the probe's graph, alive to exit


def _machine_lines():
    """What NCCL's transports depend on here: the cards' links, the size
    of ``/dev/shm`` and the network interfaces (each only read)."""
    import socket
    out = []
    try:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True,
                              timeout=60).stdout
        out += ["topo: " + line for line in topo.rstrip().splitlines()]
    except (OSError, subprocess.SubprocessError) as e:
        out.append("topo: nvidia-smi topo -m failed: %s" % e)
    try:
        st = os.statvfs("/dev/shm")
        out.append("/dev/shm: %.1f GiB, %.1f GiB free"
                   % (st.f_blocks * st.f_frsize / 2 ** 30,
                      st.f_bavail * st.f_frsize / 2 ** 30))
    except OSError as e:
        out.append("/dev/shm: %s" % e)
    out.append("interfaces: %s" % ", ".join(
        name for _i, name in socket.if_nameindex()))
    return out


def nccl_probe_worker(ranks):
    """One rank of the probe world: each step of NCCL across the cards
    in turn, a line a step (``nccl4 rank r: <step>``), each result
    checked: ``distributed_init``, ``torch.cuda.set_device``, an eager
    all-reduce on the world's NCCL group and one on a two-rank subgroup,
    all-gather, broadcast, a send/recv pair, then one all-reduce
    captured through ``_capture.GraphOwner`` (its eager warm-up first)
    and replayed twice; the process then exits with that graph still
    referenced, as a script's captured step is (the world's teardown
    frees it before it destroys the process groups)."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _capture
    from mxnet_tpu_torch.parallel import collectives, make_mesh
    dump_stacks_on_signal()
    rank = int(os.environ.get("MXNET_TPU_PROC_ID", "0"))
    t0 = time.perf_counter()

    def say(step, **facts):
        print("nccl4 rank %d: %s at %.2f s%s" % (
            rank, step, time.perf_counter() - t0,
            " " + json.dumps(facts) if facts else ""), flush=True)
    say("start", cards=torch.cuda.device_count(),
        nccl=str(torch.cuda.nccl.version()),
        torch=torch.__version__,
        settings={k: v for k, v in sorted(os.environ.items())
                  if k.startswith(("NCCL_", "TORCH_NCCL_"))})
    mx.distributed_init()
    check(dist.get_world_size() == ranks, "nccl4: a world of %d, not %d"
          % (dist.get_world_size(), ranks))
    say("distributed_init", backend=str(dist.get_backend_config()),
        cuda_initialized=torch.cuda.is_initialized())
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    say("set_device", device=str(dev))
    n = NCCL_PROBE_ELEMS

    def timed(step, fn, want):
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t)
        check(torch.equal(got, want), "nccl4 rank %d: %s gave %s, not %s"
              % (rank, step, got.flatten()[:4].tolist(),
                 want.flatten()[:4].tolist()))
        say(step, ms=round(ms, 3))

    def full(v, m=n):
        return torch.full((m,), float(v), device=dev)

    def all_reduce(group=None):
        t = full(rank + 1)
        dist.all_reduce(t, group=group)
        return t
    timed("all_reduce world", all_reduce, full(ranks * (ranks + 1) // 2))
    pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(ranks // 2)]
    i = rank // 2
    timed("all_reduce pair %d,%d" % (2 * i, 2 * i + 1),
          lambda: all_reduce(pairs[i]), full(4 * i + 3))

    def gather():
        out = torch.empty(ranks * n, device=dev)
        dist.all_gather_into_tensor(out, full(rank + 1))
        return out
    timed("all_gather", gather, torch.arange(
        1, ranks + 1, device=dev, dtype=torch.float32).repeat_interleave(n))

    def bcast():
        t = full(rank + 1)
        dist.broadcast(t, src=ranks - 1)
        return t
    timed("broadcast", bcast, full(ranks))

    def send_recv():
        # ranks 2i and 2i+1 swap one tensor each way
        peer = rank ^ 1
        t, r = full(rank + 1), torch.empty(n, device=dev)
        for op in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                          dist.P2POp(dist.irecv, r, peer)]):
            op.wait()
        return r
    timed("send/recv with rank %d" % (rank ^ 1), send_recv, full((rank ^ 1)
                                                                + 1))
    # the port's all-reduce over a mesh of the world, as a captured
    # step issues it
    mesh = make_mesh({"dp": ranks})
    owner = _capture.GraphOwner("nccl4", dev)
    src, buf = full(rank + 1), torch.empty(n, device=dev)

    def body():
        buf.copy_(src)
        return collectives.all_reduce_(buf, mesh, "dp")
    owner.warm(body)
    torch.cuda.synchronize(dev)
    say("captured all_reduce: warm-up")
    graph, out = owner.capture(body, "all_reduce")
    say("captured all_reduce: captured")
    want = full(ranks * (ranks + 1) // 2)
    for k in (1, 2):
        buf.zero_()
        timed("captured all_reduce: replay %d" % k,
              lambda: (graph.replay(), out)[1], want)
    _PROBE_KEPT.append(graph)
    dist.barrier()
    say("done")
    return 0


def nccl_probe_phase(ranks=4, timeout=180):
    """``chip_paths.py nccl4``: a world of ``ranks`` on one card each
    (``launch -n ranks``), bounded at ``timeout`` s, through
    :func:`nccl_probe_worker` with ``NCCL_DEBUG=INFO`` (which names the
    bootstrap interface and each channel's transport); a collective
    left waiting aborts its rank after 60 s (NCCL's watchdog).  The
    whole output goes to ``build/nccl4.log``.  Raises with fewer
    than ``ranks`` cards."""
    import torch
    check(torch.cuda.device_count() >= ranks,
          "nccl4: %d ranks need %d cards, %d visible"
          % (ranks, ranks, torch.cuda.device_count()))
    log = NCCL_PROBE_LOG
    os.makedirs(os.path.dirname(log), exist_ok=True)
    machine = ["nccl4 machine: " + line for line in _machine_lines()]
    with open(log, "w") as f:
        f.write("".join(line + "\n" for line in machine))
    env = {"NCCL_DEBUG": os.environ.get("NCCL_DEBUG", "INFO"),
           "MXNET_TPU_DIST_BARRIER_TIMEOUT_MS": "60000",
           "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1"}
    t0 = time.perf_counter()
    lines = run_world(
        "import sys; sys.path.insert(0, %r); import chip_smoke; "
        "sys.exit(chip_smoke.nccl_probe_worker(%d))" % (REPO_ROOT, ranks),
        ranks, timeout, env=env, log=log)
    done = sum(1 for line in lines if ": done at " in line)
    check(done == ranks, "nccl4: %d of %d ranks finished" % (done, ranks))
    # what NCCL chose, from its INFO lines: the bootstrap interface, the
    # network plugin and each channel's transport
    import collections
    import re
    seen = collections.Counter()
    for line in lines:
        for pat in (r"Bootstrap: Using (\S+)", r"Using network (\S+)",
                    r" via (\S+)", r"(NVLS multicast support is \w+)"):
            m = re.search(pat, line)
            if m:
                seen[m.group(0).strip()] += 1
    for line in machine:
        print(line, flush=True)
    print("nccl4 transports (NCCL INFO lines, over all ranks): %s"
          % json.dumps(dict(seen.most_common())), flush=True)
    print("nccl4: %d ranks through every step in %.1f s"
          % (ranks, time.perf_counter() - t0), flush=True)
    return {"ranks": ranks, "s": time.perf_counter() - t0,
            "transports": dict(seen)}


def mesh_worker(out_dir, ranks=1, hold_ms=None):
    """Phase 24's child, one rank of a world of ``ranks`` started by
    ``python -m mxnet_tpu_torch.launch -n ranks``: (a) and (b) under the
    host-read check, then (c); rank 0 prints the lines and writes
    ``mesh.json`` under ``out_dir``.  Every rank prints the part it
    enters, and the ranks meet at an attributed barrier after each part
    (bounded by ``hold_ms``, by default the world's barrier bound)."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, _capture
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import make_mesh
    dump_stacks_on_signal()
    t_world = float(os.environ.get("CHIP_SMOKE_WORLD_T0", time.time()))

    def since():
        """Seconds since the parent started the world."""
        return time.time() - t_world

    mx.distributed_init()
    make_mesh({"dp": ranks})            # the world, NCCL on the cards
    rank = dist.get_rank()
    check(dist.get_world_size() == ranks, "mesh: a world of %d, not %d"
          % (dist.get_world_size(), ranks))
    # whether joining the world and making a mesh made a CUDA context
    # (on card 0) before this rank chose its card
    print("mesh rank %d: world joined at %.1f s, CUDA initialized %s" % (
        rank, since(), torch.cuda.is_initialized()), flush=True)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _build.build_all()
    card = gpu_line()
    out = {"card": card, "ranks": ranks, "launches": {}}
    t0 = time.perf_counter()
    parts = (("a", "ResNet-50 v1 NHWC fp32 SGD 0.05/0.9, TrainStep over "
                   "dp=%d" % ranks, mesh_dp_resnet, True),
             ("b", "BERT-base LAMB, tp=%d, 8 x 512, dropout 0" % ranks,
              mesh_tp_bert, True),
             ("pp", "pipeline_apply, pp=%d over 12 layers" % ranks,
              mesh_pipeline, False),
             ("sp", "ring_attention, sp=%d" % ranks, mesh_ring, False),
             ("ep", "MixtureOfExperts, ep=%d" % ranks, mesh_moe, False))
    failed = []
    for key, what, fn, checked in parts:
        # every rank says where it is: a hang shows which part held it
        print("mesh rank %d: part %s at %.1f s" % (rank, key, since()),
              flush=True)
        registry.reset_launches()
        t1 = time.perf_counter()
        res = {}
        try:
            with _capture.checking_syncs() if checked \
                    else contextlib.nullcontext():
                fn(ranks, rank, res)
        except SmokeFailure as e:
            # a check failed after the part's collectives: the world
            # goes on to the next part (its numbers printed), and the
            # phase fails at the end
            print("mesh (%s) FAILED on rank %d: %s" % (key, rank, e),
                  flush=True)
            failed.append("(%s) %s" % (key, e))
            res["failed"] = str(e)
        except BaseException:
            # the peers are told at the part's barrier (or lose rank 0's
            # store) and the launcher tears the world down
            import traceback
            traceback.print_exc()
            mx.distributed.post_abort("mesh part %s" % key,
                                      "rank %d raised" % rank)
            mx.distributed.failfast_exit(1)
        res["s"] = time.perf_counter() - t1
        out[key] = res
        out["launches"][key] = {k: registry.launches(k)
                                for k in MESH_KERNELS}
        if rank == 0:
            print("mesh (%s) %s: %s" % (key, what, json.dumps(
                dict(res, card=card))), flush=True)
        release_cuda()
        # the ranks start each part together: rank 0's single-device
        # references end a part, and the next part's collectives must
        # not wait for it on the cards; a rank left waiting on a dead or
        # stuck peer raises BarrierTimeout naming it
        mx.distributed.barrier("mesh part %s" % key, timeout_ms=hold_ms)
    print("mesh rank %d: part ckpt at %.1f s" % (rank, since()), flush=True)
    try:
        res = mesh_checkpoint(ranks, rank, os.path.join(out_dir, "ckpt"))
    except SmokeFailure as e:
        failed.append("(ckpt) %s" % e)
        res = {"failed": str(e)}
    out["ckpt"] = res
    if rank == 0:
        print("mesh (ckpt) saved at tp=%d, restored onto a mesh: %s"
              % (ranks, json.dumps(res)), flush=True)
    out["phase_s"] = time.perf_counter() - t0
    if rank == 0:
        with open(os.path.join(out_dir, "mesh.json"), "w") as f:
            json.dump(out, f)
    mx.distributed.barrier("mesh done", timeout_ms=hold_ms)
    print("mesh rank %d: done at %.1f s" % (rank, since()), flush=True)
    if failed:
        print("mesh rank %d: FAILED: %s" % (rank, "; ".join(failed)),
              flush=True)
        return 1
    return 0


# the four-card world's bounds: the world is stopped at MESH4_WORLD_S; a
# collective left waiting aborts its rank at MESH4_COLLECTIVE_MS (NCCL's
# watchdog) and a rank left at a part's barrier raises at MESH4_HOLD_MS,
# both inside the world's bound
MESH4_WORLD_S = 420
MESH4_COLLECTIVE_MS = 300000
MESH4_HOLD_MS = 300000


def mesh4_phase():
    """Phase 24 at four ranks, one card each (``chip_paths.py mesh4``;
    raises with fewer than four cards; run ``nccl4`` first on a new
    machine): the world is stopped at MESH4_WORLD_S (420 s), a waiting
    collective aborts at MESH4_COLLECTIVE_MS (300 s), a rank left at a
    part's barrier raises at MESH4_HOLD_MS (300 s)."""
    return mesh_phase(ranks=4, timeout=MESH4_WORLD_S)


def mesh_phase(ranks=1, root=MESH_ROOT, timeout=600):
    """Phase 24: one child world of ``ranks`` (``python -m
    mxnet_tpu_torch.launch -n ranks``, one card a rank, NCCL), so this
    process never joins a world, run by :func:`run_world` (its lines
    relayed as they come, the world stopped at ``timeout`` s); returns
    its results with each kernel's launches by part."""
    import torch
    check(torch.cuda.device_count() >= ranks,
          "mesh: %d ranks need %d cards, %d visible"
          % (ranks, ranks, torch.cuda.device_count()))
    if ranks > 1:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        for i, line in enumerate(cards):
            print("mesh card %d: %s" % (i, line), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    hold = MESH4_HOLD_MS if ranks > 1 else None
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "sys.exit(chip_smoke.mesh_worker(%r, %d, %r))"
            % (REPO_ROOT, root, ranks, hold))
    env = {"CHIP_SMOKE_WORLD_T0": repr(time.time())}
    if ranks > 1:
        env = {**env,
               "MXNET_TPU_DIST_BARRIER_TIMEOUT_MS": str(MESH4_COLLECTIVE_MS),
               "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
               "NCCL_DEBUG": os.environ.get("NCCL_DEBUG", "WARN")}
    t0 = time.perf_counter()
    try:
        run_world(code, ranks, timeout, env=env)
        with open(os.path.join(root, "mesh.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["wall_s"] = time.perf_counter() - t0
    print("mesh phase (%d rank%s): %.1f s" % (ranks, "s" * (ranks > 1),
                                              res["wall_s"]))
    return res


# ---------------------------------------------------------------------
# the host worker: host work that reads no tensor of the card (the
# ImageNet records' write), in one CPU-only process beside the card
# ---------------------------------------------------------------------

# a job of the worker must come back within this many seconds of its
# start (its submission, or the end of the job before it: the worker
# runs one at a time, in order)
HOST_JOB_S = 600


def _host_worker_main(conn, cpus, threads):
    """The worker process: on ``cpus`` with ``threads`` torch threads,
    no card visible, it runs each job ``(name, fn, kwargs)`` it receives
    and sends back ``(name, busy seconds, "ok", fn(**kwargs))`` or
    ``(name, busy seconds, "error", the traceback)``, until None."""
    import traceback
    os.sched_setaffinity(0, cpus)
    os.nice(10)             # where it shares a cpu, the card's phases first
    import torch
    torch.set_num_threads(threads)
    while True:
        job = conn.recv()
        if job is None:
            return
        name, fn, kwargs = job
        t0 = time.perf_counter()
        try:
            out = ("ok", fn(**kwargs))
        except BaseException:
            out = ("error", traceback.format_exc())
        conn.send((name, time.perf_counter() - t0) + out)


def host_worker_cpus():
    """The worker's cpus: the upper half of this process's (at least
    one); the lower half stays free of it for the host-bound phases
    (decode, serving, the input producer)."""
    cpus = sorted(os.sched_getaffinity(0))
    return cpus[len(cpus) - max(1, len(cpus) // 2):]


class HostWorker:
    """One ``spawn``ed CPU-only process (``CUDA_VISIBLE_DEVICES=""``),
    pinned to ``cpus`` with ``threads`` torch threads, that runs jobs --
    a function (by reference) and its keyword arguments, small in and
    out -- one after another in the order they are submitted, while the
    caller goes on with the card.  ``submit`` returns at once;
    ``result`` waits for a job's value.  A job that raised, a worker that
    died and a job not back within ``job_s`` of its start raise
    :class:`SmokeFailure` naming the job."""

    def __init__(self, cpus, threads, job_s=HOST_JOB_S):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self.proc = ctx.Process(target=_host_worker_main,
                                    args=(child, list(cpus), threads),
                                    name="host-worker", daemon=True)
            self.proc.start()
        finally:
            if saved is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        child.close()
        self.cpus, self.threads, self.job_s = list(cpus), threads, job_s
        self.busy_s, self.waited_s = {}, 0.0
        self._submitted = {}            # name -> when, in order
        self._back = {}                 # name -> (when, status, value)

    def submit(self, name, fn, kwargs):
        """Queue ``fn(**kwargs)`` as job ``name``."""
        check(name not in self._submitted,
              "host worker: a second job named %s" % name)
        self._submitted[name] = time.perf_counter()
        self._conn.send((name, fn, kwargs))

    def _receive(self, timeout):
        """Take one job's result if it comes within ``timeout``."""
        if self._conn.poll(timeout):
            name, busy, status, value = self._conn.recv()
            self.busy_s[name] = round(busy, 1)
            self._back[name] = (time.perf_counter(), status, value)

    def result(self, name):
        """Job ``name``'s value, waiting for it (and for the jobs before
        it) within each one's bound."""
        check(name in self._submitted, "host worker: no job named %s"
              % name)
        t0 = time.perf_counter()
        order, start = list(self._submitted), None
        try:
            for job in order[:order.index(name) + 1]:
                start = self._submitted[job] if start is None \
                    else max(self._submitted[job], start)
                while job not in self._back:
                    left = start + self.job_s - time.perf_counter()
                    if left <= 0:
                        raise SmokeFailure(
                            "host worker: %s not back within %d s of its "
                            "start" % (job, self.job_s))
                    try:
                        self._receive(min(left, 1.0))
                    except (EOFError, OSError) as e:
                        raise SmokeFailure(
                            "host worker: lost before %s came back (%s; "
                            "exit code %s)" % (job, type(e).__name__,
                                               self.proc.exitcode))
                    if job not in self._back and not self.proc.is_alive():
                        self._receive(0)        # a last result in flight
                        if job not in self._back:
                            raise SmokeFailure(
                                "host worker: lost before %s came back "
                                "(exit code %s)" % (job, self.proc.exitcode))
                start = self._back[job][0]
        finally:
            self.waited_s += time.perf_counter() - t0
        _at, status, value = self._back[name]
        if status != "ok":
            raise SmokeFailure("host worker: %s raised:\n%s" % (name, value))
        return value

    def stats(self):
        """The worker's busy seconds by job and in all, and the main
        process's seconds waiting on it."""
        return {"busy": dict(self.busy_s),
                "busy_total": round(sum(self.busy_s.values()), 1),
                "main_waited": round(self.waited_s, 1),
                "cpus": [self.cpus[0], self.cpus[-1]],
                "threads": self.threads}

    def close(self):
        """Stop the worker: None to end its loop when every job is back
        (a kill after 10 s), a kill at once when one is not."""
        if all(name in self._back for name in self._submitted):
            try:
                self._conn.send(None)
            except OSError:
                pass
            self.proc.join(10)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)
        self._conn.close()


PHASE_S = {}                    # seconds of each phase of the run
_PHASE_T0 = [None]


def phase_done(name):
    """Close the phase that began at the previous call (or at the run's
    start): print and keep its seconds.  Outside a whole run (a path
    alone, a rehearsal) it does nothing."""
    if _PHASE_T0[0] is None:
        return
    now = time.perf_counter()
    PHASE_S[name] = round(now - _PHASE_T0[0], 1)
    _PHASE_T0[0] = now
    print("phase %s: %.1f s" % (name, PHASE_S[name]), flush=True)


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
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    _PHASE_T0[0] = run_t0 = time.perf_counter()
    # the ImageNet records are host work that reads no tensor of the
    # card: a CPU-only worker writes them from the start, beside the
    # build and the first phases
    cpus = host_worker_cpus()
    worker = HostWorker(cpus, len(cpus))
    print("host worker: pid %d on cpus %d-%d with %d torch threads; the "
          "main process on all %d with %d (os.cpu_count() %s)"
          % (worker.proc.pid, cpus[0], cpus[-1], len(cpus),
             len(os.sched_getaffinity(0)), torch.get_num_threads(),
             os.cpu_count()), flush=True)
    os.makedirs(INPUT_ROOT, exist_ok=True)
    records = tempfile.mkdtemp(prefix="imagenet-input-", dir=INPUT_ROOT)
    worker.submit("imagenet records", write_input_records,
                  {"root": records})
    try:
        return whole_run(
            run_t0, worker,
            lambda: (records, worker.result("imagenet records")))
    finally:
        worker.close()
        shutil.rmtree(records, ignore_errors=True)


def whole_run(run_t0, worker, written):
    """Every phase, the records written by ``worker`` (``written`` waits
    for them)."""
    import torch
    from mxnet_tpu_torch import _capture
    # every capture and replay of phases 1-15 under
    # torch.cuda.set_sync_debug_mode("error"): a host read left inside a
    # captured region fails the run
    with _capture.checking_syncs():
        entries = drive(written)
    # phase 16 captures a servable while another replays and reads its
    # logits on the host and a trainer runs: the process-wide check is
    # for runs that do one thing at a time, so it runs outside it
    release_cuda()
    print("hot-swap phases: outside the sync check (three threads use "
          "the card at once)")
    hot = hotswap_phase()
    phase_done("hotswap")
    release_cuda()
    gen = generative_swap_phase()
    phase_done("generative_swap")
    # phase 17: the ops plane observing ResNet-50 training (its
    # supervised worker and obs server are other processes and threads)
    release_cuda()
    ops = ops_plane_phase()
    phase_done("ops_plane")
    # phase 18: two ranks train through dist_sync under the supervisor
    # (other processes on this card), watched by a fleet monitor here
    release_cuda()
    dist = dist_phase()
    phase_done("dist")
    # phase 19: the symbolic API and the recurrent nets, one thing at a
    # time again, so under the host-read check
    release_cuda()
    with _capture.checking_syncs():
        symbolic = symbolic_phase()
    phase_done("symbolic")
    # phase 20: the deployment path, one thing at a time, under the
    # host-read check
    release_cuda()
    with _capture.checking_syncs():
        deploy = deploy_phase()
    phase_done("deploy")
    # phase 21: sparse storage and the contrib op families; its sparse
    # part and the calibration read ids and statistics on the host (the
    # JAX package's design), so it enters the host-read check itself
    release_cuda()
    contrib = contrib_phase()
    phase_done("contrib")
    # phase 22: the NumPy front end and the engine and runtime helpers,
    # one thing at a time, under the host-read check
    release_cuda()
    with _capture.checking_syncs():
        numpy_ = numpy_phase()
    phase_done("numpy")
    # phase 23: the static half of analysis/ -- its lint runs on the host
    # beside the gate and the audits, one thing at a time on the card
    release_cuda()
    with _capture.checking_syncs():
        analysis_ = analysis_phase()
    phase_done("analysis")
    # phase 24: meshes and in-graph collectives -- a child world of one
    # rank on NCCL (this process joins no world); the child enters the
    # host-read check itself for its captured steps
    release_cuda()
    mesh = mesh_phase()
    phase_done("mesh")
    # phase 25: the networks as pure functions, one thing at a time,
    # under the host-read check
    release_cuda()
    with _capture.checking_syncs():
        surface = surface_phase()
    phase_done("surface")
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
        entry["launches_symbolic"] = {
            path: counts[name]
            for path, counts in symbolic["launches"].items()}
        entry["launches_deploy"] = {
            route: counts[name]
            for route, counts in deploy["launches"].items()}
        entry["launches_contrib"] = {
            part: counts[name]
            for part, counts in contrib["launches"].items()}
        entry["launches_numpy"] = numpy_["launches"][name]
        entry["launches_analysis"] = analysis_["launches"][name]
        if name in MESH_KERNELS:
            entry["launches_mesh"] = {
                part: counts[name]
                for part, counts in mesh["launches"].items()}
        if name in SURFACE_KERNELS:
            entry["launches_surface"] = {
                part: counts[name]
                for part, counts in surface["launches"].items()}
    PHASE_S["host_worker"] = worker.stats()
    print("phase seconds: %s" % json.dumps(
        dict(PHASE_S, whole=round(time.perf_counter() - run_t0, 1))))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive(written=None):
    """Phases 1-15; returns the per-kernel entries of the JSON line.
    ``written`` is the ImageNet input phase's (its records written in
    the host worker)."""
    import torch
    from mxnet_tpu_torch import _build
    print(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    print("built %s in %.1f s" % (", ".join(sorted(libs)),
                                  time.perf_counter() - t0))
    phase_done("build")
    decode, scale = main_path()
    phase_done("decode")
    net, step, (x, y), train = train_main_path()
    phase_done("train")
    ckpt_root = checkpoint_phase(net, step, x, y)
    phase_done("checkpoint")
    bd = train_step_breakdown(step, x, y, train["ms_per_step"])
    capture_report("ResNet-50 fp32 SGD TrainStep", step.capture_stats(),
                   {"ms_per_step": train["ms_per_step"],
                    "img_per_s": train["img_per_s"]},
                   bd["device_idle_share"], 1)
    del step, x, y
    phase_done("train_breakdown")
    train_oracle(net)
    del net
    torch.cuda.empty_cache()
    phase_done("train_oracle")
    capture_holds()
    torch.cuda.empty_cache()
    phase_done("capture_holds")
    bucketed_holds()
    torch.cuda.empty_cache()
    phase_done("bucketed_holds")
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
    phase_done("bert")
    bert_oracle(net)
    del net
    torch.cuda.empty_cache()
    phase_done("bert_oracle")
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
    phase_done("amp_lars")
    amp_lars_oracle(net)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("amp_lars_oracle")
    bert_bf16 = bert_bf16_phase()
    phase_done("bert_bf16:hold")
    pretrain = bert_pretrain_phase()
    phase_done("pretrain:oracle")
    mnist_stats = mnist_main_path()
    phase_done("mnist")
    mnist_feed_path(mnist_stats)
    phase_done("mnist_feed")
    mnist_oracle()
    phase_done("mnist_oracle")
    dense = densenet_phase()
    release_cuda()
    phase_done("densenet:routes")
    imagenet = imagenet_input_phase(written=written)
    release_cuda()
    phase_done("imagenet_input:jpeg")
    attn = kernel_phase(scale)
    bn = bn_relu_kernel_phase()
    flash = flash_kernel_phase(BERT_BATCH * BERT_HEADS, BERT_SEQ, 64)
    ln = layernorm_kernel_phase(BERT_BATCH * BERT_SEQ, 768)
    lamb = lamb_kernel_phase(sizes)
    lars_k = lars_kernel_phase(lars_sizes, lars_skips)
    bf16_k = bert_bf16_kernel_phase()
    pretrain_k = bert_pretrain_kernel_phase()
    torch.cuda.empty_cache()
    phase_done("kernels")
    serve = serve_phase(ckpt_root)
    phase_done("serve")
    decode_ckpt = decode_checkpoint_phase()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    phase_done("decode_checkpoint")
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


# ---------------------------------------------------------------------
# phase 25: the surface -- the networks as pure functions
# (HybridBlock.functionalize), the context's memory calls, hbm_plan(fn=)
# ---------------------------------------------------------------------

SURFACE_BATCH = 32                  # (a), (b): ResNet-50 images
SURFACE_BERT = (8, 128)             # (c): sequences x tokens
SURFACE_REPLAYS = 3                 # (b)
# (a): the functional gradients against the copy's recorded backward,
# norm-wise over all parameters: the same kernels on the same inputs
# (cuDNN deterministic), so only the order autograd sums a gradient's
# contributions in may differ
SURFACE_GRAD_LIMIT = 1e-5
# (d): the predicted peak at b64 against the measured one; the line
# through b32 and b128 misses by what the allocator rounds and what
# cuDNN's workspace adds at each batch
SURFACE_HBM_LIMIT = 0.25
SURFACE_KERNELS = ("bn_relu_apply", "bn_relu_bwd", "flash_attention_fwd",
                   "flash_attention_bwd", "layernorm_fwd")


def _surface_counts():
    from mxnet_tpu_torch.kernels import registry
    return {k: registry.launches(k) for k in SURFACE_KERNELS}


def _bitwise(got, want):
    """Whether two tensors, or two sequences of tensors, are equal bit
    for bit."""
    import torch
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    return len(got) == len(want) and all(
        a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))


def surface_resnet(make_net=resnet50_nhwc, batch=SURFACE_BATCH, image=224,
                   sites=BN_RELU_SITES, device="cuda"):
    """(a) and (b): ResNet-50 through ``functionalize`` against the net
    itself and a copy trained eagerly; returns the numbers, the eval
    ``pure_fn`` with its parameter values and input, and the launches
    of each part."""
    import torch
    from mxnet_tpu_torch import _capture, autograd, gluon
    from mxnet_tpu_torch.kernels import registry
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(25)
    x = torch.randn((batch, image, image, 3), generator=gen, device=device)
    y = torch.randint(0, net.output._units, (batch,), generator=gen,
                      device=device).float()
    net.hybridize()
    with torch.no_grad():
        net(x)                          # sizes the deferred parameters
        eager = net(x)                  # the key's eager call
        net(x)                          # captures
        replay = net(x)
    launches = {}
    pure, names, pmap = net.functionalize(training=False)
    pvals = {n: pmap[n]._data.detach() for n in names}
    registry.reset_launches()
    with torch.no_grad():
        out = pure(pvals, [x])[0][0]
    launches["eval"] = _surface_counts()
    check(_bitwise(out, eager) and _bitwise(out, replay),
          "surface (a): the eval pure_fn is not bitwise net(x)")
    cuda = device == "cuda"     # the CPU runs the plain versions
    check(not cuda or launches["eval"]["bn_relu_apply"] == sites,
          "surface (a): eval bn_relu_apply %d != %d"
          % (launches["eval"]["bn_relu_apply"], sites))

    # a copy trained eagerly: one recorded forward and backward
    ref = make_net()
    ref.initialize(device=device, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref(x[:1])
    mine = net._collect_params_with_prefix()
    theirs = ref._collect_params_with_prefix()
    for k, p in mine.items():
        theirs[k].set_data(p._data.detach().clone())
    before = {k: p._data.detach().clone() for k, p in mine.items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        rloss = loss_fn(ref(x), y).sum()
    rloss.backward()
    train, names, pmap = net.functionalize(training=True)
    structural = {p.name: k for k, p in mine.items()}
    tvals = {n: pmap[n]._data.detach().clone().requires_grad_(
        pmap[n].grad_req != "null") for n in names}
    wrt = [n for n in names if tvals[n].requires_grad]
    registry.reset_launches()
    outs, aux = train(tvals, [x])
    loss = loss_fn(outs[0], y).sum()
    grads = torch.autograd.grad(loss, [tvals[n] for n in wrt])
    launches["train"] = _surface_counts()
    grad_err, worst, worst_name = rel_errors(
        {structural[n]: g for n, g in zip(wrt, grads)},
        {structural[n]: theirs[structural[n]]._data.grad for n in wrt})
    stats = {structural[n]: v for n, v in aux.items()}
    check(sorted(stats) == sorted(k for k in theirs if k.endswith(
        ("running_mean", "running_var"))),
          "surface (a): aux names %d, running statistics %d"
          % (len(stats), sum(1 for k in theirs if k.endswith(
              ("running_mean", "running_var")))))
    aux_ok = all(torch.equal(v, theirs[k]._data) for k, v in stats.items())
    unchanged = all(torch.equal(p._data, before[k])
                    for k, p in mine.items())
    check(aux_ok, "surface (a): aux differs from the copy's running "
          "statistics")
    loss, rloss = float(loss.detach()), float(rloss.detach())
    check(loss == rloss, "surface (a): loss %r != the copy's %r"
          % (loss, rloss))
    check(grad_err <= SURFACE_GRAD_LIMIT, "surface (a): gradients %.3g "
          "from the copy's (worst %.3g at %s)" % (grad_err, worst,
                                                    worst_name))
    check(unchanged, "surface (a): a training pure_fn wrote a parameter")
    check(not cuda or launches["train"]["bn_relu_apply"] == sites
          and launches["train"]["bn_relu_bwd"] == sites,
          "surface (a): training launches %s != %d each"
          % (launches["train"], sites))
    del ref, theirs, grads, outs, tvals

    # (b) the eval pure_fn captured into one graph and replayed
    owner = _capture.GraphOwner("surface pure_fn", x.device)

    def fn(xb):
        with torch.no_grad():
            return pure(pvals, [xb])[0][0]

    registry.reset_launches()
    calls = [owner.run("eval", fn, [x], watched=list(pvals.values()))
             for _ in range(1 + SURFACE_REPLAYS)]
    launches["captured"] = _surface_counts()
    stats_b = owner.stats()
    check(not cuda or (stats_b["graphs"], stats_b["replays"])
          == (1, SURFACE_REPLAYS),
          "surface (b): %d graphs, %d replays" % (stats_b["graphs"],
                                                 stats_b["replays"]))
    check(all(_bitwise(c, out) for c in calls),
          "surface (b): a replay is not bitwise the eager pure_fn")
    check(not cuda or launches["captured"]["bn_relu_apply"]
          == sites * (1 + SURFACE_REPLAYS),
          "surface (b): bn_relu_apply %d != %d x %d"
          % (launches["captured"]["bn_relu_apply"], sites,
             1 + SURFACE_REPLAYS))
    nums = {"batch": batch, "eval_bitwise": True, "aux_bitwise": aux_ok,
            "loss": loss, "grad_rel_err": grad_err,
            "grad_rel_err_worst": worst, "worst_at": worst_name,
            "params_unchanged": unchanged, "graphs": stats_b["graphs"],
            "replays": stats_b["replays"],
            "capture_s": stats_b["capture_s"]}
    return nums, (pure, pvals, x), launches


def surface_bert(make_net=bert_base_net, vocab=BERT_VOCAB,
                 layers=BERT_LAYERS, shape=SURFACE_BERT, device="cuda"):
    """(c): BERT-base through ``functionalize``: eval bitwise the net,
    then one training call and its gradients."""
    import torch
    from mxnet_tpu_torch.kernels import registry
    net = make_net()
    net.initialize(device=device, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(25)
    ids = torch.randint(0, vocab, shape, generator=gen, device=device).float()
    net.hybridize()
    with torch.no_grad():
        net(ids)                        # sizes the deferred parameters
        eager = net(ids)
        net(ids)
        replay = net(ids)
    launches = {}
    pure, names, pmap = net.functionalize(training=False)
    pvals = {n: pmap[n]._data.detach() for n in names}
    registry.reset_launches()
    with torch.no_grad():
        outs, aux = pure(pvals, [ids])
    launches["eval"] = _surface_counts()
    check(_bitwise(outs, eager) and _bitwise(outs, replay),
          "surface (c): the eval pure_fn is not bitwise net(ids)")
    cuda = device == "cuda"     # the CPU runs the plain versions
    check(not cuda or launches["eval"]["flash_attention_fwd"] == layers
          and launches["eval"]["layernorm_fwd"] == 2 * layers + 2,
          "surface (c): eval launches %s" % launches["eval"])
    train, names, pmap = net.functionalize(training=True)
    tvals = {n: pmap[n]._data.detach().clone().requires_grad_(
        pmap[n].grad_req != "null") for n in names}
    wrt = [n for n in names if tvals[n].requires_grad]
    rng = torch.Generator(device=device).manual_seed(7)
    registry.reset_launches()
    outs, aux = train(tvals, [ids], rng)
    # the MLM logits' loss: the pooler, the NSP head and the token-type
    # table take no gradient from it
    grads = torch.autograd.grad(outs[0].float().square().mean(),
                                [tvals[n] for n in wrt], allow_unused=True)
    launches["train"] = _surface_counts()
    reached = [g for g in grads if g is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in reached)
    check(finite and reached, "surface (c): no gradient or a non-finite "
          "one")
    check(not cuda or launches["train"]["flash_attention_fwd"] == layers
          and launches["train"]["flash_attention_bwd"] == layers,
          "surface (c): training launches %s" % launches["train"])
    return {"shape": list(shape), "eval_bitwise": True,
            "grads_finite": finite, "params": len(wrt),
            "params_reached": len(reached)}, launches


def surface_memory(eval_fn, batch=SURFACE_BATCH, device="cuda"):
    """(d): the context's memory calls and ``hbm_plan(fn=, args=)``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.analysis import memory
    pure, pvals, x = eval_fn
    ctx = mx.gpu(0)
    used, limit = ctx.memory_info()
    want = (torch.cuda.memory_allocated(0),
            torch.cuda.get_device_properties(0).total_memory)
    check((used, limit) == want, "surface (d): memory_info %s != %s"
          % ((used, limit), want))
    big = torch.empty(1 << 30, dtype=torch.uint8, device=device)
    del big
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(0)
    ctx.empty_cache()
    after = torch.cuda.memory_reserved(0)
    check(after < reserved, "surface (d): empty_cache left %d of %d "
          "reserved bytes" % (after, reserved))

    def fn(xb):
        with torch.no_grad():
            return pure(pvals, [xb])[0][0]

    plan = memory.hbm_plan("surface:resnet50_eval", fn=fn, args=(x,),
                           buckets=(2 * batch,), probe_factor=4)
    predicted = plan["buckets"][0]["predicted_peak_hbm_bytes"]
    x2 = x[torch.arange(2 * batch, device=x.device) % batch]
    measured = memory._measured_peak(fn, (x2,))
    miss = abs(predicted - measured) / measured
    check(miss <= SURFACE_HBM_LIMIT, "surface (d): hbm_plan predicted %d "
          "bytes at b%d, measured %d (%.3f off)"
          % (predicted, 2 * batch, measured, miss))
    return {"memory_info": [used, limit], "reserved_before": reserved,
            "reserved_after": after, "plan_measured": plan["measured"],
            "per_item_bytes": plan["per_item_bytes"],
            "predicted_b%d" % (2 * batch): predicted,
            "measured_b%d" % (2 * batch): measured, "miss": miss}


def surface_phase(device="cuda", resnet_kwargs=None, bert_kwargs=None):
    """Phase 25: (a) and (b) on ResNet-50, (c) on BERT-base, (d) the
    memory calls, cuDNN deterministic; returns the numbers and each
    kernel's launches by part."""
    import torch
    t_phase = time.perf_counter()
    card = gpu_line() if device == "cuda" else None
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resnet, eval_fn, launches = surface_resnet(
            device=device, **(resnet_kwargs or {}))
        print("surface (a)+(b) ResNet-50 v1 NHWC fp32 through "
              "functionalize: %s" % json.dumps(dict(resnet, card=card)),
              flush=True)
        mem = surface_memory(eval_fn, device=device) \
            if device == "cuda" else None
        print("surface (d) memory_info, empty_cache, hbm_plan(fn=): %s"
              % json.dumps(dict(mem or {}, card=card)), flush=True)
        del eval_fn
        if device == "cuda":
            release_cuda()
        bert, bert_launches = surface_bert(device=device,
                                           **(bert_kwargs or {}))
        print("surface (c) BERT-base through functionalize: %s"
              % json.dumps(dict(bert, card=card)), flush=True)
    finally:
        torch.backends.cudnn.deterministic = prev
    launches = {"resnet_" + k: v for k, v in launches.items()}
    launches.update({"bert_" + k: v for k, v in bert_launches.items()})
    out = {"resnet": resnet, "bert": bert, "memory": mem,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    print("surface launches by part: %s" % json.dumps(launches))
    print("surface phase: %.1f s" % out["phase_s"])
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAIL: %s" % e, file=sys.stderr)
        sys.exit(1)
