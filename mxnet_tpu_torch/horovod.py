"""Horovod-style data-parallel API (counterpart of
``mxnet_tpu/horovod.py``; reference: the ``mxnet+horovod`` integration's
``hvd.init/rank/size/DistributedTrainer/broadcast_parameters``).

There is no MPI ring to manage: processes join the world of
:mod:`mxnet_tpu_torch.distributed` (one call), and the reductions are
its host collectives.  The API shape is kept so reference training
scripts port by changing the import.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .distributed import distributed_init
from .gluon.trainer import Trainer
from .ndarray import NDArray

__all__ = ["init", "rank", "size", "local_rank", "allreduce",
           "grouped_allreduce", "broadcast_parameters",
           "DistributedTrainer"]

_initialized = False


def init():
    """``hvd.init()``: join the multi-process world (from the launcher's
    environment; a no-op when single-process)."""
    global _initialized
    distributed_init()
    _initialized = True


def rank():
    from .distributed import world
    return world()[1]


def size():
    from .distributed import world
    return world()[0]


def local_rank():
    return 0  # one process per launch slot, as the JAX package counts


def allreduce(tensor, average=True, name=None):
    """Sum (or mean) an array across workers, as an NDArray on the
    input's device."""
    from .distributed import host_allreduce
    return NDArray(host_allreduce(tensor, average=average))


def grouped_allreduce(tensors, average=True, name=None):
    """``hvd.grouped_allreduce``: reduce a LIST of arrays in ONE
    flattened collective per dtype (``host_allreduce_bucketed``)."""
    from .distributed import host_allreduce_bucketed
    return [NDArray(v) for v in host_allreduce_bucketed(tensors,
                                                        average=average)]


def broadcast_parameters(params, root_rank=0):
    """Make every worker start from root's weights (reference:
    ``hvd.broadcast_parameters``): ONE bucketed collective for the
    whole parameter set, written into each parameter in place."""
    from .distributed import host_broadcast_bucketed, world
    if world()[0] == 1:
        return
    items = list(params.items() if hasattr(params, "items") else params)
    tensors = [getattr(p, "_data", p) for _name, p in items]
    out = host_broadcast_bucketed(tensors, root=root_rank)
    with torch.no_grad():
        for t, v in zip(tensors, out):
            t.copy_(v)


class DistributedTrainer(Trainer):
    """``hvd.DistributedTrainer``: a Gluon Trainer whose gradients
    average across the process world before each update."""

    def __init__(self, params, optimizer, optimizer_params=None, **kwargs):
        super().__init__(params, optimizer, optimizer_params,
                         kvstore=None, **kwargs)
        from .distributed import world
        if not _initialized and world()[0] > 1:
            raise MXNetError("call horovod.init() first")

    def step(self, batch_size, ignore_stale_grad=False):
        from .distributed import world
        if world()[0] > 1:
            grads = [p._data.grad for _i, p in self._live()]
            reduced = grouped_allreduce(grads, average=True)
            with torch.no_grad():
                for g, r in zip(grads, reduced):
                    g.copy_(r._data)
        super().step(batch_size, ignore_stale_grad)
