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
fleet monitor).  The
checkout's own ``chip_smoke`` and package are imported, its kernels
built, and each path prints its lines as in the smoke run, under the
same host-read check of every capture -- except ``hotswap``, which runs
outside it as the smoke run does (its threads read results on the host
while another captures).  Exits 1 when a path's check fails, 2 without a
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
         "ops": "ops_plane_phase", "dist": "dist_phase"}
UNCHECKED = {"hotswap", "ops", "dist"}  # outside checking_syncs()


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
