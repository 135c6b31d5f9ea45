"""Parallelism (counterpart of ``mxnet_tpu.parallel``): meshes over a
world of one process per card, explicit collectives on a mesh axis,
data-parallel training steps, tensor, pipeline, sequence and expert
parallelism."""
from .mesh import (Mesh, NamedSharding, PartitionSpec, default_mesh,
                   global_mesh, local_devices, make_mesh, put_replicated,
                   stage_process_local)
from .data_parallel import (TrainStep, replicate_block, shard_batch,
                            split_and_load)
from .sequence import ring_attention, ring_attention_sharded
from .tensor_parallel import (ColumnParallelDense, RowParallelDense,
                              TensorParallelMLP, shard_block_tp)
from .pipeline import (pipeline_apply, shard_stacked_params,
                       stack_stage_params)
from .moe import MixtureOfExperts, moe_load_balancing_loss
from . import collectives

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "default_mesh",
           "global_mesh", "local_devices", "make_mesh", "put_replicated",
           "stage_process_local", "TrainStep", "replicate_block",
           "shard_batch", "split_and_load", "ring_attention",
           "ring_attention_sharded", "ColumnParallelDense",
           "RowParallelDense", "TensorParallelMLP", "shard_block_tp",
           "pipeline_apply", "shard_stacked_params",
           "stack_stage_params", "MixtureOfExperts",
           "moe_load_balancing_loss", "collectives"]
