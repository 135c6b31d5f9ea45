"""Run chosen paths of the ``chip_smoke.py`` of the current directory on
one card: the way to compare a checkout with another on the same card
without the whole smoke run.

    cd <checkout> && python3 <repo>/chip_paths.py decode mnist
    cd <checkout> && python3 <repo>/chip_paths.py pretrain
    cd <checkout> && python3 <repo>/chip_paths.py densenet
    cd <checkout> && python3 <repo>/chip_paths.py input mnistfeed
    cd <checkout> && python3 <repo>/chip_paths.py hotswap
    cd <checkout> && python3 <repo>/chip_paths.py ops
    cd <checkout> && python3 <repo>/chip_paths.py dist
    cd <checkout> && python3 <repo>/chip_paths.py symbolic
    cd <checkout> && python3 <repo>/chip_paths.py bertbf16
    cd <checkout> && python3 <repo>/chip_paths.py layernorm
    cd <checkout> && python3 <repo>/chip_paths.py deploy
    cd <checkout> && python3 <repo>/chip_paths.py contrib
    cd <checkout> && python3 <repo>/chip_paths.py numpy
    cd <checkout> && python3 <repo>/chip_paths.py mesh
    cd <checkout> && python3 <repo>/chip_paths.py surface
    cd <checkout> && python3 <repo>/chip_paths.py mesh4
    cd <checkout> && python3 <repo>/chip_paths.py nccl4 mesh4

``decode`` is ``chip_smoke.main_path`` (GPT-2 small decode serving),
``mnist`` is ``mnist_main_path`` (the imperative LeNet loop, then 100
hybridized batches), ``pretrain`` is ``bert_pretrain_phase`` (BERT
pretraining as users run it, with its oracle), ``densenet`` is
``densenet_phase`` (DenseNet-121 NHWC trained by a captured
``TrainStep`` and by the imperative loop, its oracle, the fused kernels
at its site shapes, the model-zoo sweep and the ``mx.nd`` kernel
routes), ``input`` is ``imagenet_input_phase`` (ResNet-50 bf16 LARS
trained from a ``.rec`` through ``ImageRecordIter(ctx=)`` and the device
feed, with the loader's parts) and ``mnistfeed`` is ``mnist_feed_path``
(the MNIST loop through ``DataLoader(ctx=mx.gpu(0))``) and ``hotswap``
is ``hotswap_phase`` then ``generative_swap_phase`` (the always-on
train -> serve loop: ResNet-50 trained and hot-swapped into live
serving, and a mid-decode swap of the GPT-2-small-width decoder) and
``ops`` is ``ops_plane_phase`` (the ops plane observing ResNet-50
training: profiled AMP LARS steps, ``mx.profiler``, the observed
always-on trainer and the supervised crash-restart) and ``dist`` is
``dist_phase`` (two ranks training ResNet-50 through ``dist_sync`` under
the supervisor, one killed and the world relaunched, watched by a
fleet monitor) and ``symbolic`` is ``symbolic_phase`` (phase 19:
``Module.fit`` of ``examples/module_mnist.py``, the bucketing LSTM
language model through ``BucketingModule`` and the Gluon word language
model, with their card-against-CPU oracles) and ``bertbf16`` is
``bert_bf16_phase`` (BERT-base bf16 Adam at ``bench_bert_base``'s two
shapes, each with its step breakdown, then its oracle and the
captured-against-eager hold) and ``layernorm`` is
``layernorm_phase`` (the LayerNorm kernel's checks, times, bound
shares and routes) and ``deploy`` is ``deploy_phase`` (phase 20:
ResNet-50 exported and run back through ``SymbolBlock``, ``Module``,
``mx.Predictor``, the ``.mxa`` archive, the registry's ``symbol=`` and
``onnx=`` sources and the C predict runtime) and ``contrib`` is
``contrib_phase`` (phase 21: the Avazu-scale sparse logistic regression
through ``row_sparse_pull`` and row-sparse AdaGrad, int8 ResNet-50 by
``quantize_model`` through ``Module`` and ``SymbolBlock``, and the
linalg, interleaved-attention, detection and control-flow ops at user
widths against the CPU) and ``numpy`` is ``numpy_phase`` (phase 22:
BERT-base trained from ``mx.np`` arrays under ``npx.set_np()``, through
``mx.nd`` and inside ``mx.engine.bulk``; every ``mx.np``/``npx`` name at
user widths against the CPU; ``check_consistency`` and
``runtime.Features()`` on the card; the host cost of an eager op) and
``surface`` is ``surface_phase`` (phase 25: ResNet-50 and BERT-base
as pure functions through ``HybridBlock.functionalize`` against the
nets, a copy's recorded backward and a captured graph of the eval
function; ``memory_info``, ``empty_cache`` and ``hbm_plan(fn=)``) and
``mesh`` is ``mesh_phase`` (phase 24: a child world of one rank on NCCL,
``launch -n 1``: ResNet-50 ``TrainStep(mesh=)`` over dp, BERT-base
``tp_mesh``/``shard_tp`` with LAMB, the pipeline, ring attention, MoE
and a ``restore(sharding=)`` round trip) and ``mesh4`` the same paths at
four ranks, one card each (``launch -n 4``; it raises with fewer than
four cards visible), against the single-device steps -- (a) with two
planted faults as its controls (``chip_smoke.planted_fault``: BatchNorm
statistics left per rank, and the smallest gradient bucket left out of
the all-reduce), each of which must fail a check the real dp=4 step
passes (``chip_smoke.mesh_dp_rule``); its world is
stopped at ``MESH4_WORLD_S`` (420 s), a waiting collective aborts its
rank at ``MESH4_COLLECTIVE_MS`` (300 s, NCCL's watchdog) and a rank
left at a part's barrier raises at ``MESH4_HOLD_MS`` (300 s).  ``nccl4``
is ``nccl_probe_phase``, the first thing to run on a new four-card
machine: a world of four (``launch -n 4``, ~1 min, stopped at 180 s)
in which every rank prints a line a step -- ``distributed_init``,
``set_device``, an eager all-reduce on the world's NCCL group and on a
two-rank subgroup, all-gather, broadcast, a send/recv pair, one
all-reduce captured through ``GraphOwner`` and replayed twice, then an
exit with that graph still referenced -- under
``NCCL_DEBUG=INFO`` (the bootstrap interface and each channel's
transport), with the cards' links, ``/dev/shm`` and the interfaces
first; its whole output goes to ``build/nccl4.log``.  ``nccl4``
alone builds no kernel.  The
checkout's own ``chip_smoke`` and package are imported, its kernels
built, and each path prints its lines as in the smoke run, under the
same host-read check of every capture -- except ``hotswap``, which runs
outside it as the smoke run does (its threads read results on the host
while another captures), and ``contrib``, which enters it itself for
its inference and op families.  Exits 1 when a path's check fails, 2 without a
card or on an unknown path.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

PATHS = {"decode": "main_path", "mnist": "mnist_main_path",
         "pretrain": "bert_pretrain_phase", "densenet": "densenet_phase",
         "input": "imagenet_input_phase", "mnistfeed": "mnist_feed_path",
         "hotswap": ("hotswap_phase", "generative_swap_phase"),
         "ops": "ops_plane_phase", "dist": "dist_phase",
         "symbolic": "symbolic_phase", "bertbf16": "bert_bf16_phase",
         "layernorm": "layernorm_phase", "deploy": "deploy_phase",
         "contrib": "contrib_phase", "numpy": "numpy_phase",
         "analysis": "analysis_phase", "mesh": "mesh_phase",
         "surface": "surface_phase",
         "mesh4": "mesh4_phase", "nccl4": "nccl_probe_phase"}
# outside checking_syncs() (contrib enters it for its checked parts, the
# mesh paths' child worlds for their captured steps)
UNCHECKED = {"hotswap", "ops", "dist", "contrib", "mesh", "mesh4", "nccl4"}
# paths that run no hand kernel
NO_BUILD = {"nccl4"}


def main(argv):
    names = argv or ["decode", "mnist"]
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        print("chip_paths: unknown path %s; choose from %s"
              % (", ".join(unknown), ", ".join(PATHS)), file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("chip_paths: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch import _build, _capture
    print(cs.gpu_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not set(names) <= NO_BUILD:
        t0 = time.perf_counter()
        _build.build_all()
        print("built in %.1f s" % (time.perf_counter() - t0), flush=True)
    for name in names:
        t0 = time.perf_counter()
        fns = PATHS[name] if isinstance(PATHS[name], tuple) \
            else (PATHS[name],)
        scope = contextlib.nullcontext() if name in UNCHECKED \
            else _capture.checking_syncs()
        try:
            with scope:
                for fn in fns:
                    getattr(cs, fn)()
                    torch.cuda.empty_cache()
        except cs.SmokeFailure as e:
            print("chip_paths: %s FAILED: %s" % (name, e))
            return 1
        print("chip_paths: %s ok in %.1f s"
              % (name, time.perf_counter() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
