"""Dtype-group flatten/concat bucketing (counterpart of
``mxnet_tpu/bucketing.py``, on torch tensors).

The bucketed optimizer update (:mod:`mxnet_tpu_torch.kernels.
optimizer_update`) groups a parameter list by dtype, preserving input
order, flattens each group into one 1-D buffer, and splits results back
to the original shapes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

__all__ = ["dtype_groups", "flatten_group", "split_group"]


def dtype_groups(arrays: Sequence[Any]) -> List[Tuple[Any, List[int]]]:
    """Group ``arrays`` by dtype, preserving first-seen order:
    ``[(dtype, [index, ...]), ...]``, indices into the input in their
    original order."""
    order: List[Any] = []
    groups: Dict[Any, List[int]] = {}
    for i, a in enumerate(arrays):
        dt = a.dtype
        if dt not in groups:
            groups[dt] = []
            order.append(dt)
        groups[dt].append(i)
    return [(dt, groups[dt]) for dt in order]


def flatten_group(arrays: Sequence[torch.Tensor], idxs: Sequence[int],
                  xp=torch) -> torch.Tensor:
    """One contiguous 1-D buffer holding ``arrays[i]`` flattened for every
    ``i`` in ``idxs``, concatenated in order by ``xp`` (``torch`` for
    tensors, ``numpy`` for arrays).  A single-element group skips the
    concat (a view when the tensor is contiguous)."""
    flat = [arrays[i].reshape(-1) for i in idxs]
    return xp.concatenate(flat) if len(flat) > 1 else flat[0]


def split_group(buf: torch.Tensor,
                shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """Views of a flat buffer made by :func:`flatten_group`, one of each
    of ``shapes``."""
    out = []
    off = 0
    for shape in shapes:
        n = math.prod(int(d) for d in shape)
        out.append(buf[off:off + n].reshape(shape))
        off += n
    return out
