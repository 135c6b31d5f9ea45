"""HybridBlock -> ``-symbol.json`` + ``-NNNN.params`` (counterpart of
``mxnet_tpu/symbol/export.py``; reference ``gluon/block.py ::
HybridBlock.export``).

The block's forward is traced with ``F = mx.sym`` (each parameter a
variable, :meth:`~mxnet_tpu_torch.gluon.Parameter.var`) into a graph
over the port's op table, byte for byte the JAX package's JSON.  The
parameters are saved under the reference's ``arg:``/``aux:`` prefixes
(``aux:`` for a parameter that takes no gradient, as the JAX package
decides), so ``SymbolBlock.imports``, ``mx.model.load_checkpoint`` and
third-party loaders read them.
"""
from __future__ import annotations

from ..ndarray import ndarray as _nd_mod
from .symbol import Group, var

__all__ = ["export_block", "symbolic_forward"]


def symbolic_forward(block, *input_syms):
    """Run a block's forward in symbol mode."""
    return block(*input_syms)


def export_block(block, path, epoch=0, input_names=("data",)):
    """Write ``path-symbol.json`` and ``path-%04d.params`` of ``block``;
    returns the two file names."""
    out = symbolic_forward(block, *[var(n) for n in input_names])
    if isinstance(out, (list, tuple)):
        out = Group(list(out))
    sym_file = "%s-symbol.json" % path
    out.save(sym_file)
    arg = {}
    for p in block._all_params():
        if p._data is None:
            continue
        prefix = "aux:" if p._grad_req == "null" else "arg:"
        arg[prefix + p.name] = p.data()
    params_file = "%s-%04d.params" % (path, epoch)
    _nd_mod.save(params_file, arg)
    return sym_file, params_file
