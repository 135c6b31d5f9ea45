"""``mxnet_tpu_torch`` -- the PyTorch/CUDA port of ``mxnet_tpu``.

The port runs on an NVIDIA Hopper GPU.  Each TPU kernel of the JAX
package becomes a kernel written by hand for Hopper (``csrc/``, built
on first use by :mod:`._build`) beside its plain PyTorch version, which
runs when the tensors lie on the CPU.  Entry points run on CUDA unless
the caller passes ``device="cpu"``, and raise without CUDA otherwise.

It imports neither JAX nor anything of ``mxnet_tpu``.  Ported so far:

- the generative serving path (:mod:`.serving`) with the
  ``paged_attention`` kernel;
- the ResNet training path: :mod:`.gluon` (blocks, layers, losses,
  ``Trainer``, the ResNet model zoo), :mod:`.optimizer`,
  :mod:`.parallel` (``TrainStep``), with the fused BatchNorm+ReLU
  forward and backward kernels at every channels-last BatchNorm+relu
  site;
- the BERT pretraining path: the transformer layers and
  ``model_zoo.bert``, the LAMB optimizer and ``TrainStep``'s bucketed
  LAMB update, with the flash-attention forward and backward, LayerNorm
  and LAMB phase-1 kernels;
- large-batch ResNet training under mixed precision: :mod:`.amp` (bf16
  and fp16 casts at the op namespace, dynamic loss scaling), the LARS
  optimizer with ``TrainStep``'s bucketed LARS update (the ``lars_flat``
  kernel) and ``TrainStep.run_steps``;
- the imperative API: :mod:`.ndarray` (``mx.nd``: ``NDArray`` over a
  tensor, the tensor and random ops), contexts, the NDArray entry points
  of :mod:`.autograd`, ``gluon.data`` and :mod:`.metric`, so a script
  written for MXNet runs with ``import mxnet_tpu_torch as mx`` and
  ``mx.gpu()``;
- checkpoints and the fixed-shape serving tier: ``mx.nd.save``/``load``
  and ``Block.save_parameters`` in MXNet's ``.params`` format,
  ``Trainer.save_states``, :mod:`.checkpoint` (``CheckpointManager``)
  and ``serving.ModelRegistry.register(block=, checkpoint=)`` over a
  dynamic batcher and a pool of padded batch buckets;
- the whole optimizer module (every optimizer of the JAX package's
  registry, ``mx.lr_scheduler``, multi-precision fp16, the ``mx.nd``
  update ops) and BERT pretraining under bf16 AMP with Adam, with the
  runtime half of the numerics sentinel (:mod:`.analysis.numerics`);
- BERT pretraining as users run it -- padded batches with a
  ``valid_mask``, NSP beside masked LM -- through the imperative loop
  and ``Trainer``'s default single-process :mod:`.kvstore`, with the
  everyday Gluon members of the JAX package (``Parameter`` and
  ``ParameterDict`` members, ``gluon.Constant``, ``Block.summary``, the
  initializers, ``autograd.set_recording``);
- the ImageNet input path: :mod:`.recordio` (with its native engine,
  :mod:`._native`), :mod:`.image` (decode, augmenters, ``ImageIter``),
  :mod:`.io` (the legacy iterators and ``ImageRecordIter``) and
  :mod:`.dataio` (``DeviceFeed``, which lands batches on the card
  through a pinned ring behind the consumer's compute, and
  ``DeviceTransform``), with ``DataLoader(ctx=)`` and
  ``TrainStep(DeviceBatch)``;
- the always-on train -> serve loop (``serving.loop``:
  ``ContinuousTrainer``, ``RegistryWatcher``, ``GenerativeWatcher``) and
  the ops-plane core it stands on: :mod:`.sync` (named locks with a
  lock-order sanitizer and deadlock watchdog), :mod:`.telemetry`,
  :mod:`.chaos` (fail points and scenarios), :mod:`.obs` (tracing and
  the status board) and :mod:`.preemption`;
- the single-process ops plane: :mod:`.profiling` (cost reports walked
  from each shape-keyed program's eager warm-up, the roofline, the
  ``mxprof`` CLI), :mod:`.profiler` (``torch.profiler`` behind the
  reference's control surface), the goodput ledger, the crash-safe
  flight recorder and the introspection server (:mod:`.obs`), the leak
  sentinel (:mod:`.analysis.memory`), :mod:`.supervisor` and the
  ``mxtelemetry`` CLI;
- multi-process data-parallel training: :mod:`.distributed` (a
  ``TCPStore`` and a gloo process group, attributed barriers, liveness
  leases, host collectives; ``mx.distributed_init``), the ``dist_*``
  kvstores, :mod:`.horovod`, sharded multi-process checkpoints, the
  multi-process ``ContinuousTrainer``, :mod:`.launch` (``python -m
  mxnet_tpu_torch.launch``), and the fleet plane watching the workers
  (``obs.fleet.FleetMonitor``, ``obs.alerts``, ``mxtelemetry fleet``);
- the symbolic front end and recurrent nets: :mod:`.symbol` (``mx.sym``:
  graphs over the op table, shape inference, ``-symbol.json``),
  :mod:`.executor` (one CUDA graph a mode), :mod:`.module` (``mx.mod``:
  ``Module``, ``BucketingModule``), :mod:`.model` and :mod:`.callback`
  (checkpoints, ``Speedometer``), :mod:`.name` and ``mx.AttrScope``,
  and ``gluon.rnn`` over the fused ``RNN`` op;
- deployment: ``HybridBlock.export``/``optimize_for`` and
  ``gluon.SymbolBlock``, :mod:`.onnx` (``mx.onnx``: export, import,
  metadata), :mod:`.predictor` (``mx.Predictor``, ``export_compiled``,
  ``mx.CompiledPredictor``, ``NativePredictor`` over the C predict ABI)
  and ``ModelRegistry.register(symbol=, onnx=)``;
- sparse storage and the contrib op families: ``mx.nd.sparse`` (CSR and
  row-sparse arrays) with row-sparse kvstore pulls and optimizer
  updates, the ``linalg_*`` ops, ``mx.nd.contrib``'s control flow
  (``foreach``, ``while_loop``, ``cond``) and its box, ROI, int8 and
  interleaved-matmul ops, :mod:`.contrib` (``quantization``: calibrate
  and rewrite a graph to int8) and ``gluon.contrib.nn``;
- the NumPy front end and the engine and runtime helpers: :mod:`.numpy`
  (``mx.np``: ``mx.np.ndarray`` views, NumPy's names and dtypes) and
  :mod:`.numpy_extension` (``mx.npx``: the layer ops, ``set_np()``,
  under which Gluon blocks return ``mx.np.ndarray``), :mod:`.engine`
  (``set_bulk_size``/``bulk``, kept as controls: the port defers no
  eager op), :mod:`.runtime` (``Features``, ``env_vars``),
  :mod:`.visualization` (``mx.viz``) and :mod:`.test_utils`;
- meshes and in-graph collectives: :mod:`.parallel` (``make_mesh`` over
  a world of one process per card, explicit NCCL collectives on a mesh
  axis, ``TrainStep(mesh=)`` with global-batch BatchNorm statistics,
  Megatron tensor parallelism with ``bert_base(tp_mesh=)``, the GPipe
  ``pipeline_apply``, ``ring_attention``, ``MixtureOfExperts``),
  checkpoints restored onto a mesh, sharded input landing and the
  sharding sanitizer (:mod:`.analysis.sharding`).

``import mxnet_tpu_torch as mx`` binds ``mx.parallel``, ``mx.serving``,
``mx.kv``/``mx.kvstore``, ``mx.recordio``, ``mx.io``, ``mx.image``,
``mx.dataio``, ``mx.sync``, ``mx.telemetry``, ``mx.obs``, ``mx.chaos``,
``mx.preemption``, ``mx.profiler``, ``mx.profiling``,
``mx.distributed_init``, ``mx.horovod``, ``mx.sym``/``mx.symbol``,
``mx.mod``, ``mx.model``, ``mx.callback``, ``mx.name``, ``mx.Executor``,
``mx.AttrScope``, ``mx.onnx``, ``mx.predictor``, ``mx.Predictor``,
``mx.CompiledPredictor``, ``mx.contrib`` (``quantization``),
``mx.engine``, ``mx.runtime``, ``mx.env``, ``mx.np``, ``mx.npx``,
``mx.viz``/``mx.visualization`` and ``mx.test_utils`` as the JAX
package's
``__init__`` does (``mxnet_tpu_torch.supervisor`` is imported
by name, as the JAX package's is).

Kernels and their plain versions are registered in :mod:`.kernels`.
"""
from . import sync, telemetry, obs, chaos
from . import amp, autograd, checkpoint, gluon, metric, optimizer, random
from . import dataio, image, io, recordio
from . import initializer
from . import initializer as init
from . import kvstore
from . import kvstore as kv
from . import parallel, preemption, serving
from . import profiler, profiling
from . import ndarray as nd
from . import horovod
from .base import MXNetError
from .distributed import distributed_init
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, resolve_device)
from .ndarray import NDArray
from .optimizer import lr_scheduler
from . import attribute, callback, executor, model, name
from . import module as mod
from . import symbol
from . import symbol as sym
from . import onnx, predictor
from .attribute import AttrScope
from .executor import Executor
from .predictor import CompiledPredictor, Predictor
from . import contrib
from . import engine, env, runtime, test_utils
from . import numpy as np
from . import numpy_extension as npx
from . import visualization as viz
visualization = viz

# MXNET_TPU_TRANSFER_GUARD=disallow: a host synchronisation on the card
# inside the step raises (analysis.sharding.install_transfer_guard)
from .analysis.sharding import install_transfer_guard as _install_guard
_install_guard()

__version__ = "0.1.0"

__all__ = ["AttrScope", "CompiledPredictor", "Context", "Executor",
           "MXNetError", "NDArray", "Predictor", "amp", "attribute",
           "autograd", "callback", "chaos", "checkpoint", "contrib", "cpu",
           "cpu_pinned", "current_context", "dataio", "distributed_init",
           "engine", "env", "executor", "gluon", "horovod", "gpu", "image",
           "init", "initializer", "io", "kv", "kvstore", "lr_scheduler",
           "metric", "mod", "model", "name", "nd", "np", "npx", "num_gpus",
           "obs", "onnx", "optimizer", "parallel", "predictor",
           "preemption", "random", "recordio", "resolve_device", "runtime",
           "serving", "sym", "symbol", "sync", "telemetry", "test_utils",
           "visualization", "viz"]
