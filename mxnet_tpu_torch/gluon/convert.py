"""Carry a net's weights across from the JAX package (or any source of
``{name: numpy array}``).

:func:`params_from_numpy` sets a port net's parameters, running
statistics included, from the arrays of a net of the same architecture.
Names are matched relative to each net's own prefix: block counters are
global in each package, so the same net is ``resnetv10_...`` in one
process and ``resnetv11_...`` in another.  Arrays named structurally
(``"0.weight"``, as ``_collect_params_with_prefix`` and MXNet's
``save_parameters`` name them) are matched by structure, which also
holds for a net whose children were made outside its ``name_scope``.
A name outside the net's prefix is matched whole.
Both packages keep convolution weights OHWI for NHWC (OIHW for NCHW),
so nothing is permuted.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["params_from_numpy"]


def _relative(name, prefix):
    """``name`` less ``prefix``; a name outside the prefix (a child
    given an explicit prefix of its own, as MobileNetV2's ``pred_``
    convolution) is matched whole."""
    return name[len(prefix):] if name.startswith(prefix) else name


def params_from_numpy(net, arrays, prefix=None):
    """Set every parameter of ``net`` from ``arrays`` (``{name:
    ndarray}``).  ``prefix`` is the source net's prefix; by default the
    names' text up to their first ``_`` (an automatic top-level prefix
    such as ``resnetv10_``).  Raises on a missing or extra name and on a
    shape mismatch; a deferred parameter takes the array's shape.
    Structural names (each with a ``.``, or exactly the net's own
    structural names, as a recurrent layer's ``l0_i2h_weight``) are
    matched by structure.  A parameter placed on a mesh
    (:mod:`mxnet_tpu_torch.parallel`) takes this rank's shard of its
    full array, under its ``PartitionSpec``."""
    structural = net._collect_params_with_prefix()
    if arrays and (all("." in name for name in arrays)
                   or set(arrays) == set(structural)):
        # structural names; a block's own parameters have no "." (a
        # recurrent layer's l0_i2h_weight ... at the top level)
        _set_all(structural, {k: np.asarray(a) for k, a in arrays.items()})
        return
    if prefix is None:
        firsts = {name.split("_", 1)[0] + "_" for name in arrays}
        if len(firsts) != 1:
            raise MXNetError("arrays have no common top-level prefix (%s); "
                             "pass prefix=" % ", ".join(sorted(firsts)))
        prefix = firsts.pop()
    src = {_relative(name, prefix): np.asarray(a)
           for name, a in arrays.items()}
    dst = {_relative(p.name, net.prefix): p
           for p in net.collect_params().values()}
    _set_all(dst, src)


def _set_all(dst, src):
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise MXNetError("params_from_numpy: missing %s, extra %s"
                         % (missing, extra))
    for name, p in dst.items():
        a = src[name]
        if p.shape is not None and all(p.shape) \
                and tuple(p.shape) != a.shape:
            raise MXNetError("params_from_numpy: %s is %s in the net, %s "
                             "in the arrays" % (name, p.shape, a.shape))
        p.set_data(torch.tensor(a))
