"""The op table behind ``mx.nd.*`` (counterpart of
``mxnet_tpu/ops/registry.py``).

Each entry names a plain function on tensors of the port's op
namespace, its tensor arguments (``args``, or ``*data`` when
``variadic``), its keyword parameters (read from the function's
signature) and its aliases.  ``mx.nd`` generates one function per name
and alias from it (:mod:`mxnet_tpu_torch.ndarray.register`), and
:func:`mxnet_tpu_torch.ndarray.invoke` runs an entry's ``fn``.  Importing
:mod:`mxnet_tpu_torch.ops` wraps the ``fn`` of every entry on the AMP
lists with the casts, once, so ``mx.nd`` and ``F`` cast at one place.

Ops that make a tensor from nothing (``_zeros``, the samplers) take a
``device`` keyword, which ``invoke`` fills from the caller's ``ctx`` or
the current context; it is not one of the op's parameters.

Dtypes follow the JAX package with 64-bit types off: ``float64`` is
``float32`` and ``int64`` is ``int32`` (:func:`torch_dtype`,
:func:`canonical`).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["OpSpec", "TABLE", "call_signature", "canonical", "lookup",
           "names", "register", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float32,
    "int32": torch.int32, "int64": torch.int32, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def torch_dtype(dtype):
    """A ``torch.dtype`` from a name, a numpy dtype or a torch dtype,
    with float64 -> float32 and int64 -> int32."""
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    name = str(dtype) if isinstance(dtype, str) else \
        getattr(dtype, "__name__", None) or str(dtype)
    try:
        return _DTYPES[str(np.dtype(name)) if name != "bfloat16" else name]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def canonical(t):
    """``t`` with a 64-bit dtype narrowed to 32 bits."""
    narrow = _NARROW.get(t.dtype)
    return t if narrow is None else t.to(narrow)


@dataclass
class OpSpec:
    """One op: its function, tensor arguments, parameters, aliases."""
    name: str
    fn: Callable
    args: Tuple[str, ...]
    variadic: bool = False
    aliases: Tuple[str, ...] = ()
    params: Tuple[str, ...] = field(default=())
    creates: bool = False     # takes ``device``: makes a tensor from none
    # the JAX registry's flags, kept for ``ops.registry.Op``: the leading
    # outputs that are differentiable (None: all), and whether the op
    # draws random numbers (from the device's generator here; the JAX
    # package threads a key to such an op)
    num_diff_outputs: Optional[int] = None
    stateful_rng: bool = False

    def __repr__(self):
        return "OpSpec(%s)" % self.name


TABLE: Dict[str, OpSpec] = {}
_BY_NAME: Dict[str, OpSpec] = {}


def register(name, args=("data",), variadic=False, aliases=(),
             num_diff_outputs=None, stateful_rng=False):
    """Decorator entering ``fn`` into the table as op ``name``."""
    def deco(fn):
        sig = inspect.signature(fn)
        params = tuple(p.name for p in sig.parameters.values()
                       if p.kind is inspect.Parameter.KEYWORD_ONLY
                       or (p.default is not inspect.Parameter.empty
                           and p.name not in args))
        creates = "device" in params
        spec = OpSpec(name, fn, tuple(args), variadic, tuple(aliases),
                      tuple(p for p in params if p != "device"), creates,
                      num_diff_outputs, stateful_rng)
        for n in (name,) + spec.aliases:
            if n in _BY_NAME:
                raise MXNetError("duplicate op name %r" % n)
            _BY_NAME[n] = spec
        # keyed by op name (one entry a registration), not by shape
        TABLE[name] = spec  # mxlint: disable=unbounded-shape-cache
        return fn
    return deco


def lookup(name):
    """The spec of an op name or alias."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise MXNetError("unknown op %r" % (name,)) from None


def names():
    """Every op name and alias in the table."""
    return sorted(_BY_NAME)


def call_signature(spec, trailing, positional_params):
    """The signature of a generated ``mx.nd``/``mx.sym`` function of
    ``spec``: its tensor arguments (``*data`` when variadic), its
    parameters with the defaults of ``spec.fn`` (positional after the
    tensors where ``positional_params``), then the keyword-only
    ``trailing`` names, each defaulting to None."""
    Param = inspect.Parameter
    defaults = {n: p.default for n, p in
                inspect.signature(spec.fn).parameters.items()}
    if spec.variadic:
        out = [Param("data", Param.VAR_POSITIONAL)]
    else:
        out = [Param(a, Param.POSITIONAL_OR_KEYWORD, default=None)
               for a in spec.args]
    kind = Param.POSITIONAL_OR_KEYWORD \
        if positional_params and not spec.variadic else Param.KEYWORD_ONLY
    for n in spec.params:
        d = defaults.get(n, Param.empty)
        out.append(Param(n, kind, default=None if d is Param.empty else d))
    out += [Param(n, Param.KEYWORD_ONLY, default=None) for n in trailing]
    return inspect.Signature(out)
