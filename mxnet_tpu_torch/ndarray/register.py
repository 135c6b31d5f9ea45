"""The ``mx.nd.*`` function surface (counterpart of
``mxnet_tpu/ndarray/register.py``): one function per op name and alias
of the op table.  A generated function takes the op's tensor arguments
positionally or by name (``*data`` for a variadic op), then its
parameters by name, or positionally in the order of the op's
signature, and ``out=``; an op that makes a tensor from none also takes
``ctx=``."""
from __future__ import annotations

from ..ops import table
from .ndarray import invoke


def _make_function(spec, pyname):
    nargs = len(spec.args)

    def fn(*args, out=None, name=None, **kwargs):
        if spec.variadic:
            tensors = list(args)
        else:
            tensors = list(args[:nargs]) + [None] * (nargs - len(args))
            for i, a in enumerate(spec.args):
                if a in kwargs:
                    tensors[i] = kwargs.pop(a)
            kwargs.update(zip(spec.params, args[nargs:]))
        return invoke(spec, tensors, kwargs, out=out)

    fn.__name__ = fn.__qualname__ = pyname
    fn.__doc__ = spec.fn.__doc__
    fn.__module__ = "mxnet_tpu_torch.ndarray"
    fn.__signature__ = table.call_signature(
        spec, ("out", "name") + (("ctx",) if spec.creates else ()), True)
    return fn


def populate(namespace):
    """One function per op name and alias into ``namespace``."""
    for name in table.names():
        namespace[name] = _make_function(table.lookup(name), name)
    return namespace
