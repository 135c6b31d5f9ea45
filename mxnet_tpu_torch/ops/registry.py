"""The op table as the JAX package's self-describing registry
(counterpart of ``mxnet_tpu/ops/registry.py``).

:data:`OP_REGISTRY`, :func:`get_op`, :func:`list_ops` and
:func:`register` are views over :mod:`.table`, not a second table: an
:class:`Op` is one table entry under the JAX ``Op``'s fields, its typed
:class:`OpParam` list read from the function's signature.  An op
:func:`register` enters runs through ``mx.nd.invoke(get_op(name), ...)``
and in a symbol graph's node, as the JAX package's does.
"""
from __future__ import annotations

import difflib
import inspect
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..base import MXNetError, build_param_doc
from . import table

__all__ = ["Op", "OpParam", "register", "get_op", "list_ops", "OP_REGISTRY"]


@dataclass
class OpParam:
    """One typed parameter of an op."""
    name: str
    default: Any = None
    has_default: bool = True
    doc: str = ""

    @property
    def type_str(self) -> str:
        if self.default is None:
            return "any"
        return type(self.default).__name__


class Op:
    """An op with the JAX ``Op``'s fields: ``fcompute(*tensors,
    **params)`` is its function on tensors and ``spec`` its entry of the
    op table.  :func:`get_op` and :func:`register` give the table's ops;
    built from the fields, an op stands outside the table and runs
    through ``mx.nd.invoke(op, ...)``.  ``params`` is by default read
    from ``fcompute``'s keyword parameters with a default."""

    def __init__(self, name, fcompute, arg_names, variadic=False,
                 params=None, doc="", aliases=(), num_diff_outputs=None,
                 stateful_rng=False):
        if params is None:
            names = tuple(
                p.name for p in inspect.signature(fcompute).parameters
                .values() if p.default is not inspect.Parameter.empty
                and p.name not in arg_names)
        else:
            names = tuple(p.name for p in params)
        self.spec = table.OpSpec(name, fcompute, tuple(arg_names), variadic,
                                 tuple(aliases), names, False,
                                 num_diff_outputs, stateful_rng)
        self._params = None if params is None else list(params)
        self._doc = doc or None

    @classmethod
    def of(cls, spec: table.OpSpec) -> "Op":
        """The op of a table entry."""
        op = cls.__new__(cls)
        op.spec, op._params, op._doc = spec, None, None
        return op

    name = property(lambda self: self.spec.name)
    fcompute = property(lambda self: self.spec.fn)
    arg_names = property(lambda self: self.spec.args)
    variadic = property(lambda self: self.spec.variadic)
    aliases = property(lambda self: self.spec.aliases)
    num_diff_outputs = property(lambda self: self.spec.num_diff_outputs)
    stateful_rng = property(lambda self: self.spec.stateful_rng)

    @property
    def params(self) -> List[OpParam]:
        """The typed parameters, with the function's defaults."""
        if self._params is not None:
            return list(self._params)
        sig = inspect.signature(self.spec.fn).parameters
        empty = inspect.Parameter.empty
        out = []
        for n in self.spec.params:
            d = sig[n].default
            out.append(OpParam(n, None if d is empty else d, d is not empty))
        return out

    @property
    def doc(self) -> str:
        if self._doc is not None:
            return self._doc
        doc = inspect.getdoc(self.spec.fn) or ""
        params = self.params
        return doc + "\n\n" + build_param_doc(params) if params else doc

    def param_defaults(self) -> Dict[str, Any]:
        return {p.name: p.default for p in self.params if p.has_default}

    def __eq__(self, other):
        return isinstance(other, Op) and other.spec is self.spec

    def __hash__(self):
        return id(self.spec)

    def __repr__(self):
        return "Op(%s)" % self.name


class _Registry(Mapping):
    """``{name or alias: Op}`` over the op table."""

    def __getitem__(self, name):
        try:
            return Op.of(table.lookup(name))
        except MXNetError:
            raise KeyError(name) from None

    def __iter__(self):
        return iter(table.names())

    def __len__(self):
        return len(table.names())


OP_REGISTRY = _Registry()


def register(name: str, args: Sequence[str] = ("data",),
             variadic: bool = False, aliases: Sequence[str] = (),
             num_diff_outputs: Optional[int] = None,
             stateful_rng: bool = False) -> Callable[[Callable], Op]:
    """Decorator entering a function on tensors into the op table as op
    ``name``; returns the :class:`Op`, as the JAX package's does.  Its
    keyword parameters with a default are the op's parameters."""
    def deco(fn: Callable) -> Op:
        table.register(name, args, variadic, aliases, num_diff_outputs,
                       stateful_rng)(fn)
        return get_op(name)
    return deco


def get_op(name: str) -> Op:
    try:
        return Op.of(table.lookup(name))
    except MXNetError:
        close = difflib.get_close_matches(str(name), table.names(), n=3,
                                          cutoff=0.6)
        hint = "; did you mean %s?" % " or ".join(repr(c) for c in close) \
            if close else " (see mxnet_tpu_torch.ops.list_ops())"
        raise MXNetError("unknown operator %r%s" % (name, hint)) from None


def list_ops() -> List[str]:
    """Every op name and alias, sorted."""
    return table.names()
