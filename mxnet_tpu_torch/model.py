"""Checkpoint conventions of the symbolic API (counterpart of
``mxnet_tpu/model.py``; reference ``python/mxnet/model.py``).

``prefix-symbol.json`` holds the graph and ``prefix-%04d.params`` one
dict keyed ``arg:<name>`` / ``aux:<name>`` in the ``.params`` format of
``mx.nd.save``, so checkpoints cross between the packages file for
file.  Both files commit atomically (:func:`~.checkpoint.core.commit`).
Loaded arrays come back on the host, as every restored checkpoint of
the port does; binding copies them to the executor's device.
"""
from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym
from .context import cpu

__all__ = ["BatchEndParam", "load_checkpoint", "load_params",
           "save_checkpoint"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write the graph and the parameters of ``epoch``; returns the
    ``.params`` file's name."""
    from .checkpoint.core import commit
    if symbol is not None:
        commit("%s-symbol.json" % prefix, symbol.save)
    save_dict = {"arg:%s" % k: v for k, v in (arg_params or {}).items()}
    save_dict.update({"aux:%s" % k: v for k, v in (aux_params or {}).items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    commit(param_name, lambda tmp: nd.save(tmp, save_dict))
    return param_name


def load_params(prefix, epoch):
    """The ``arg:`` and ``aux:`` dicts of a checkpoint, on the host; a
    bare key (a Gluon file) counts as an argument."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
