"""Static graph checker: validate a ``Symbol`` before anything is
allocated (counterpart of ``mxnet_tpu/analysis/graph_check.py``).

The reference's nnvm passes (InferShape/InferType, graph validation in
``GraphExecutor::Init``) abort the *bind*; this pass runs the same
class of checks standalone -- over ``Symbol._topo()`` -- and reports
every problem at once as :class:`~.core.Diagnostic`s instead of raising
on the first.  The JAX package's oracle is ``jax.eval_shape``; the
port's is its own shape inference (``symbol.symbol``): each op of the
port's op table runs on tensors of PyTorch's ``meta`` device, which
hold no data, so the check allocates nothing on the card and launches
nothing.

Structural rules (no shape info needed):

- ``unknown-op``          op name missing from the op table (with a
                          did-you-mean drawn from the table)
- ``dangling-input``      op node with unfilled required tensor slots
- ``duplicate-input``     two distinct variable nodes sharing a name

Shape/dtype rules (need input shapes, given or via ``__shape__`` attrs):

- ``shape-contradiction`` the op rejects a node's meta inputs whose
                          shapes are all known
- ``unknown-shape``       a variable's shape cannot be deduced (warning)
- ``dtype-promotion``     a node mixes input dtypes, triggering implicit
                          promotion (warning; an fp32 upcast hiding an
                          intended bf16 path costs the tensor cores)

``Executor(check=True)``, ``Symbol.bind/simple_bind(check=True)`` and
``MXNET_TPU_GRAPH_CHECK=1`` run :func:`assert_graph_ok` before the bind
allocates anything.
"""
from __future__ import annotations

import difflib
from typing import Dict, List, Optional

import torch

from ..base import MXNetError
from .core import Diagnostic, ERROR, WARNING, rule

__all__ = ["check_symbol", "GraphCheckError", "assert_graph_ok"]


class GraphCheckError(MXNetError):
    """Raised by :func:`assert_graph_ok`; carries the diagnostics."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        msg = "graph check failed:\n" + "\n".join(
            d.format() for d in self.diagnostics)
        super().__init__(msg)


def _spec(opname):
    from ..ops import table
    try:
        return table.lookup(opname)
    except MXNetError:
        return None


# ----------------------------------------------------------------------
# structural rules
# ----------------------------------------------------------------------

@rule("unknown-op", "graph",
      "An op node names an operator missing from the op table; binding "
      "would fail at dispatch time.")
def _check_unknown_op(sym, ctx):
    from ..ops import table
    for node in sym._topo():
        if node.op is not None and _spec(node.op) is None:
            close = difflib.get_close_matches(node.op, table.names(), 1)
            hint = "; did you mean %r?" % close[0] if close else ""
            yield Diagnostic("unknown-op",
                             "op %r is not in the op table%s"
                             % (node.op, hint), node=node.name)


@rule("dangling-input", "graph",
      "An op node has fewer inputs than its registered signature "
      "requires (a structurally-required tensor slot is unfilled).")
def _check_dangling_input(sym, ctx):
    from ..symbol.symbol import _node_params, _skip_auto_var
    for node in sym._topo():
        spec = _spec(node.op) if node.op is not None else None
        if spec is None or spec.variadic:
            continue
        params = _node_params(node, spec, False)
        required = [a for a in spec.args
                    if not _skip_auto_var(node.op, params, a)]
        if len(node.inputs) < len(required):
            missing = required[len(node.inputs):]
            yield Diagnostic(
                "dangling-input",
                "op %s(%s) is missing tensor input(s) %r"
                % (node.op, node.name, missing), node=node.name)


@rule("duplicate-input", "graph",
      "Two distinct variable nodes share one name, so a single feed "
      "entry silently binds both.")
def _check_duplicate_input(sym, ctx):
    seen: Dict[str, int] = {}
    for node in sym._topo():
        if node.op is not None:
            continue
        if node.name in seen:
            yield Diagnostic(
                "duplicate-input",
                "variable name %r is used by %d distinct input nodes; "
                "binding by name is ambiguous"
                % (node.name, seen[node.name] + 1), node=node.name)
        seen[node.name] = seen.get(node.name, 0) + 1


# ----------------------------------------------------------------------
# shape/dtype walk (forward on meta tensors, the error-collecting twin of
# symbol._infer_shapes_forward)
# ----------------------------------------------------------------------

def _shape_walk(sym, known):
    """Yield diagnostics; shares the per-op deduction rules with
    ``infer_shape`` so the checker and the binder can never disagree."""
    from ..symbol.symbol import (_ARG_DTYPES, _call_node, _meta,
                                 _node_params, _param_shape_rule,
                                 _parse_attr_value, _store)

    known = {k: tuple(v) for k, v in (known or {}).items()}
    specs = {}                       # (id(node), oi) -> meta tensor
    reported_unknown = set()
    meta = torch.device("meta")

    def report_unknown(name):
        if name not in reported_unknown:
            reported_unknown.add(name)
            yield Diagnostic(
                "unknown-shape",
                "shape of input %r cannot be deduced; pass it to the "
                "checker or annotate the variable" % name,
                node=name, severity=WARNING)

    for node in sym._topo():
        if node.op is None:
            if node.name in known:
                shape = known[node.name]
            elif "__shape__" in node.attrs:
                shape = tuple(_parse_attr_value(node.attrs["__shape__"]))
            else:
                continue
            if any(not isinstance(d, int) or d <= 0 for d in shape):
                # deferred-init shape (0 = unknown dim, e.g. a conv
                # weight before in_channels is seen): leave it to the
                # per-op deduction rule at the consumer
                continue
            specs[(id(node), 0)] = _meta(
                shape, str(node.attrs.get("__dtype__", "float32")))
            continue
        spec = _spec(node.op)
        if spec is None:
            continue                 # unknown-op already reported
        params = _node_params(node, spec, False)
        in_shapes = [specs.get((id(src), oi)) for src, oi in node.inputs]
        in_shapes = [tuple(s.shape) if s is not None else None
                     for s in in_shapes]
        args = []
        unresolved = False
        for i, (src, oi) in enumerate(node.inputs):
            s = specs.get((id(src), oi))
            if s is None and src.op is None:
                arg = spec.args[i] if i < len(spec.args) else ""
                shape = _param_shape_rule(node.op, params, arg, in_shapes)
                if shape is not None:
                    s = specs[(id(src), oi)] = _meta(
                        shape, _ARG_DTYPES.get((node.op, arg), "float32"))
            if s is None:
                if src.op is None:
                    yield from report_unknown(src.name)
                unresolved = True
            args.append(s)
        if unresolved:
            continue
        in_dtypes = {str(a.dtype).replace("torch.", "") for a in args}
        if len(in_dtypes) > 1:
            yield Diagnostic(
                "dtype-promotion",
                "op %s(%s) mixes input dtypes %s; the result is "
                "implicitly promoted" % (node.op, node.name,
                                         sorted(in_dtypes)),
                node=node.name, severity=WARNING)
        try:
            with torch.no_grad():
                out = _call_node(node, args, False, meta)
        except Exception as e:       # any op's refusal, named at its node
            yield Diagnostic(
                "shape-contradiction",
                "op %s(%s) rejects input shapes %s: %s"
                % (node.op, node.name,
                   [tuple(a.shape) for a in args], e),
                node=node.name)
            continue
        _store(specs, node, out)


@rule("shape-contradiction", "graph",
      "Forward shape propagation (the op on meta tensors) rejects a "
      "node whose input shapes are all known.")
def _check_shapes(sym, ctx):
    for d in _shape_walk(sym, (ctx or {}).get("shapes")):
        if d.rule == "shape-contradiction":
            yield d


@rule("unknown-shape", "graph",
      "A variable's shape is neither given nor deducible, leaving part "
      "of the graph unvalidated.", severity=WARNING)
def _check_unknown_shape(sym, ctx):
    for d in _shape_walk(sym, (ctx or {}).get("shapes")):
        if d.rule == "unknown-shape":
            yield d


@rule("dtype-promotion", "graph",
      "A node mixes input dtypes; implicit promotion can silently "
      "upcast a reduced-precision path to fp32.", severity=WARNING)
def _check_dtype_promotion(sym, ctx):
    for d in _shape_walk(sym, (ctx or {}).get("shapes")):
        if d.rule == "dtype-promotion":
            yield d


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

_STRUCTURAL = ("unknown-op", "dangling-input", "duplicate-input")


def check_symbol(sym, shapes: Optional[Dict[str, tuple]] = None,
                 structural_only: bool = False,
                 ignore=()) -> List[Diagnostic]:
    """Run every graph rule over ``sym``; returns all diagnostics.

    ``shapes`` maps input names to shapes (like ``infer_shape`` kwargs).
    ``structural_only`` skips the shape walk.  ``ignore`` drops the
    listed rule ids."""
    from .core import RULES
    diags: List[Diagnostic] = []
    for rid in _STRUCTURAL:
        if rid in ignore:
            continue
        diags.extend(RULES[rid].check(sym, None))
    if not structural_only:
        # one walk, routed by rule id (the per-rule wrappers exist for
        # --list-rules discoverability; one walk does the work of three)
        for d in _shape_walk(sym, shapes):
            if d.rule not in ignore:
                diags.append(d)
    return diags


def assert_graph_ok(sym, shapes=None, structural_only=False, ignore=()):
    """Raise :class:`GraphCheckError` when any error-severity diagnostic
    fires -- the opt-in bind gate used by ``Executor``."""
    diags = [d for d in check_symbol(sym, shapes, structural_only, ignore)
             if d.severity == ERROR]
    if diags:
        raise GraphCheckError(diags)
    return True
