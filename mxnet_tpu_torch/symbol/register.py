"""The ``mx.sym.*`` function surface (counterpart of
``mxnet_tpu/symbol/register.py``): one function per op name and alias
of the port's op table, as ``mx.nd``'s, which makes a graph node in
place of running the op.  A function takes the op's tensor arguments
as symbols, positionally or by name (``*data`` for a variadic op), its
parameters by name, and ``name=``/``attr=``.  The node's attributes
keep the JAX package's order, so a graph's ``-symbol.json`` is byte for
byte the JAX package's."""
from __future__ import annotations

from ..ops import table
from .symbol import _make_node


def _make_function(spec, pyname):
    def fn(*args, name=None, attr=None, **kwargs):
        if spec.variadic:
            inputs = list(args)
        else:
            inputs = list(args)
            for a in spec.args[len(args):]:
                if a in kwargs:
                    inputs.append(kwargs.pop(a))
            inputs = [a for a in inputs if a is not None]
        # the JAX package's attribute order: keywords the op does not
        # declare, as given, then its parameters in declared order
        params = {k: v for k, v in kwargs.items() if k not in spec.params}
        params.update((k, kwargs[k]) for k in spec.params if k in kwargs)
        return _make_node(spec.name, inputs, params, name=name)

    fn.__name__ = fn.__qualname__ = pyname
    fn.__doc__ = spec.fn.__doc__
    fn.__module__ = "mxnet_tpu_torch.symbol"
    fn.__signature__ = table.call_signature(spec, ("name", "attr"), False)
    return fn


def populate(namespace):
    """One function per op name and alias (those that are identifiers)
    into ``namespace``, leaving the names it already has."""
    for name in table.names():
        if name.isidentifier():
            namespace.setdefault(name, _make_function(table.lookup(name),
                                                      name))
    return namespace
