"""Network visualization over the port's ``mx.sym`` graphs (counterpart
of ``mxnet_tpu/visualization.py``; reference
``python/mxnet/visualization.py :: print_summary, plot_network``)."""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["plot_network", "print_summary"]


def _node_shapes(symbol, shape):
    """Per-node output shapes and variable shapes from one inference
    pass over the whole graph."""
    var_shapes, out_by_node = {}, {}
    if not shape:
        return var_shapes, out_by_node
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
    names = symbol.list_arguments() + symbol.list_auxiliary_states()
    var_shapes = {n: s for n, s in
                  zip(names, list(arg_shapes) + list(aux_shapes)) if s}
    internals = symbol.get_internals()
    _, out_shapes, _ = internals.infer_shape_partial(**shape)
    for (node, idx), s in zip(internals._outputs, out_shapes):
        if idx == 0 and s is not None:
            out_by_node[id(node)] = tuple(s)
    return var_shapes, out_by_node


def print_summary(symbol, shape=None, line_length=120):
    """Print a layer table: op, name, output shape, parameter count,
    inputs (reference: ``mx.viz.print_summary``); returns the total.
    ``shape`` maps input names to shapes so output shapes can be
    inferred.  Parameter counts cover learnable variables only (inputs,
    labels and auxiliary states such as BatchNorm's running statistics
    are left out, as ``collect_params`` does)."""
    nodes = symbol._topo()
    var_shapes, out_by_node = _node_shapes(symbol, shape)
    aux = set(symbol.list_auxiliary_states())

    def n_params(node):
        if node.op is not None:
            return 0
        if shape and node.name in shape:
            return 0                      # graph inputs
        if node.name in aux or node.name.endswith("_label"):
            return 0                      # auxiliary states, labels
        s = var_shapes.get(node.name)
        return int(np.prod(s)) if s else 0

    header = ("%-28s %-20s %-20s %-12s %s"
              % ("Layer (type)", "Name", "Output Shape", "Params",
                 "Previous"))
    print("=" * line_length)
    print(header)
    print("=" * line_length)
    total = 0
    for node in nodes:
        kind = node.op or "Variable"
        prev = ",".join(src.name for src, _ in node.inputs)[:40]
        os_ = var_shapes.get(node.name) if node.op is None \
            else out_by_node.get(id(node))
        p = n_params(node)
        total += p
        print("%-28s %-20s %-20s %-12d %s"
              % (kind[:28], node.name[:20],
                 str(tuple(os_)) if os_ else "?", p, prev))
    print("=" * line_length)
    print("Total params: {:,}".format(total))
    return total


def plot_network(symbol, title="plot", shape=None, save_format="pdf",
                 node_attrs=None):
    """Graphviz rendering of the graph (reference: ``plot_network``).
    Needs the ``graphviz`` package and raises :class:`MXNetError`
    without it; ``shape`` adds output-shape labels, ``node_attrs``
    merges into every node's attributes."""
    try:
        import graphviz
    except ImportError as e:
        raise MXNetError(
            "plot_network requires the graphviz package (not available "
            "in this environment); use print_summary instead") from e
    var_shapes, out_by_node = _node_shapes(symbol, shape)
    attrs = dict(node_attrs or {})
    dot = graphviz.Digraph(name=title, format=save_format)
    nodes = symbol._topo()
    for node in nodes:
        s = var_shapes.get(node.name) if node.op is None \
            else out_by_node.get(id(node))
        suffix = "\n%s" % (tuple(s),) if s else ""
        if node.op is None:
            dot.node(node.name, node.name + suffix, shape="oval",
                     fillcolor="#8dd3c7", style="filled", **attrs)
        else:
            dot.node(node.name,
                     "%s\n%s%s" % (node.op, node.name, suffix),
                     shape="box", fillcolor="#fb8072", style="filled",
                     **attrs)
    for node in nodes:
        for src, _ in node.inputs:
            dot.edge(src.name, node.name)
    return dot
