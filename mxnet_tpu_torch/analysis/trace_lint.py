"""Capture-safety AST linter for the captured paths (counterpart of
``mxnet_tpu/analysis/trace_lint.py``: the same rules, ids and findings
on the same source, and torch's spellings besides).

On the H100 the compiled scope is a captured one: ``hybridize()``'s
cache, ``TrainStep``, the serving buckets and the decode engine run
their bodies once eagerly and then capture them into CUDA graphs
(``mxnet_tpu_torch/_capture.py``).  Python that is fine eagerly breaks
there:

- a host sync (``.asnumpy()``, ``.item()``, ``.cpu()``, ``.tolist()``,
  ``float(x)``, ``np.asarray(x)``, ``torch.cuda.synchronize()``) inside
  a capture raises (``cudaErrorStreamCaptureUnsupported``) or, under
  ``checking_syncs()``, is refused;
- Python ``if``/``while`` on a tensor's *value* reads it on the host at
  capture time and freezes that branch into the graph for every replay
  (branching on ``is None`` / ``isinstance`` / shapes is structural and
  fine -- a graph is captured per shape);

and everywhere in library code:

- mutable default arguments alias state across calls;
- bare ``except:`` swallows ``KeyboardInterrupt``/preemption SIGTERM
  handling.

The scopes linted as captured are :data:`TRACED_SCOPES` (the JAX
package's names and the port's ``_plain_call``, the method a hybridized
block's graph runs), the ``forward`` of a class deriving from a
``Hybrid*`` block, and the body of a ``with torch.cuda.graph(...)``
block, where every tensor is the card's.

Suppress a finding with ``# mxlint: disable=<rule>`` on its line.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

from .core import Diagnostic, filter_suppressed, rule

__all__ = ["lint_source", "lint_file", "lint_paths", "TRACED_SCOPES"]

# Method names whose bodies run in a capture.  ``hybrid_forward`` is the
# public contract; ``_forward_impl`` is the JAX package's engine-internal
# twin, kept so the same source gives the same findings; ``_plain_call``
# is the method a hybridized block's graph owner warms and captures
# (``gluon/block.py :: HybridBlock._call_keyed``).
TRACED_SCOPES = ("hybrid_forward", "_forward_impl", "_plain_call")
# a ``forward`` of a class whose base names one of these is captured too
_HYBRID_BASE_PREFIX = "Hybrid"

# attribute reads that touch only static metadata of a traced value
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "context", "name"}
# calls that inspect structure, not value
_STATIC_CALLS = {"isinstance", "len", "hasattr", "type", "getattr",
                 "enumerate", "zip", "range", "list", "tuple", "id"}
# method calls that force a device->host transfer of a traced value
_SYNC_METHODS = {"asnumpy", "asscalar", "item", "tolist", "wait_to_read",
                 "cpu", "numpy"}
# ``torch.cuda.synchronize()``/``torch.cuda.current_stream().synchronize()``:
# a sync whatever it is called on
_SYNC_CALLS = {"synchronize"}
# builtins that coerce a traced value to a Python scalar
_COERCIONS = {"float", "int", "bool", "complex"}
# numpy module aliases whose array constructors pull values to host
_NP_MODULES = {"np", "numpy", "onp"}
_NP_SYNC_FUNCS = {"asarray", "array", "asanyarray", "ascontiguousarray"}


def _traced_value_uses(expr, traced) -> List[ast.Name]:
    """Name nodes in ``expr`` that read a traced value's *data* (uses
    behind static metadata/structure accessors don't count)."""
    if expr is None:
        return []
    if isinstance(expr, ast.Name):
        return [expr] if expr.id in traced else []
    if isinstance(expr, ast.Attribute):
        if expr.attr in _STATIC_ATTRS:
            return []
        return _traced_value_uses(expr.value, traced)
    if isinstance(expr, ast.Call):
        f = expr.func
        fname = f.id if isinstance(f, ast.Name) else \
            (f.attr if isinstance(f, ast.Attribute) else None)
        if fname in _STATIC_CALLS:
            return []
        out = _traced_value_uses(f, traced)
        for a in expr.args:
            out += _traced_value_uses(a, traced)
        for k in expr.keywords:
            out += _traced_value_uses(k.value, traced)
        return out
    if isinstance(expr, ast.Compare):
        # identity checks (x is None / x is not y) are structural
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return []
    out = []
    for child in ast.iter_child_nodes(expr):
        out += _traced_value_uses(child, traced)
    return out


def _traced_names(fn: ast.FunctionDef) -> set:
    """Initial traced-value bindings of a traced scope: every tensor
    parameter (positional after self/F, kw-only, and **params)."""
    args = fn.args
    pos = [a.arg for a in args.posonlyargs + args.args]
    skip = 1 if pos and pos[0] == "self" else 0
    if fn.name == "hybrid_forward" and len(pos) > skip and \
            pos[skip] == "F":
        skip += 1
    names = set(pos[skip:])
    names.update(a.arg for a in args.kwonlyargs)
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


class _TracedScopeVisitor(ast.NodeVisitor):
    """Walks one traced scope, propagating taint through assignments."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.traced = _traced_names(fn)
        self.host_syncs: List[Diagnostic] = []
        self.branches: List[Diagnostic] = []

    def run(self):
        for stmt in self.fn.body:
            self.visit(stmt)
        return self

    # taint propagation: a name assigned from an expression that reads a
    # traced value becomes traced itself
    def visit_Assign(self, node):
        self.generic_visit(node)
        if _traced_value_uses(node.value, self.traced):
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        self.traced.add(n.id)

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        if _traced_value_uses(node.value, self.traced) and \
                isinstance(node.target, ast.Name):
            self.traced.add(node.target.id)

    def visit_FunctionDef(self, node):
        pass                          # nested defs get their own scope

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and \
                _traced_value_uses(f.value, self.traced):
            self._sync(node, ".%s() forces a device->host sync" % f.attr)
        elif isinstance(f, ast.Name) and f.id in _COERCIONS and \
                any(_traced_value_uses(a, self.traced) for a in node.args):
            self._sync(node, "%s() coerces a traced value on host" % f.id)
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and \
                f.value.id in _NP_MODULES and f.attr in _NP_SYNC_FUNCS and \
                any(_traced_value_uses(a, self.traced) for a in node.args):
            self._sync(node, "%s.%s() materializes a traced value as a "
                       "host numpy array" % (f.value.id, f.attr))
        elif isinstance(f, ast.Attribute) and f.attr in _SYNC_CALLS:
            self._sync(node, ".%s() waits for the card" % f.attr)

    def _sync(self, node, what):
        self.host_syncs.append(Diagnostic(
            "host-sync",
            "%s inside %s; inside a CUDA-graph capture this raises "
            "(or stalls the capture) -- keep the value on the device "
            "(F./mx.nd ops) or compute it outside the captured path"
            % (what, self.fn.name),
            line=node.lineno))

    def _branch(self, node, kw):
        uses = _traced_value_uses(node.test, self.traced)
        if uses:
            self.branches.append(Diagnostic(
                "tracer-branch",
                "`%s` on traced value(s) %s inside %s; the branch is "
                "read on the host and frozen into the captured graph "
                "-- use an F.where-style select instead"
                % (kw, sorted({u.id for u in uses}), self.fn.name),
                line=node.lineno))

    def visit_If(self, node):
        self._branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._branch(node, "while")
        self.generic_visit(node)

    def visit_Assert(self, node):
        # assert on a traced value is a bool coercion too
        uses = _traced_value_uses(node.test, self.traced)
        if uses:
            self.branches.append(Diagnostic(
                "tracer-branch",
                "`assert` on traced value(s) %s inside %s; use "
                "explicit shape checks or F.where"
                % (sorted({u.id for u in uses}), self.fn.name),
                line=node.lineno))
        self.generic_visit(node)


def _base_names(cls: ast.ClassDef):
    for b in cls.bases:
        if isinstance(b, ast.Name):
            yield b.id
        elif isinstance(b, ast.Attribute):
            yield b.attr


def _traced_scopes(tree) -> Iterable[ast.FunctionDef]:
    hybrid_forwards = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                n.startswith(_HYBRID_BASE_PREFIX)
                for n in _base_names(node)):
            hybrid_forwards.update(
                id(f) for f in node.body
                if isinstance(f, ast.FunctionDef) and f.name == "forward")
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and (
                node.name in TRACED_SCOPES or id(node) in hybrid_forwards):
            yield node


def _is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph``/``graph``)."""
    e = item.context_expr
    if not isinstance(e, ast.Call):
        return False
    f = e.func
    if isinstance(f, ast.Attribute) and f.attr == "graph":
        v = f.value
        return isinstance(v, ast.Attribute) and v.attr == "cuda" or \
            isinstance(v, ast.Name) and v.id == "cuda"
    return False


class _CaptureBlockVisitor(ast.NodeVisitor):
    """Host syncs in the body of a ``with torch.cuda.graph(...)`` block:
    every tensor there is the card's, so a sync method on any receiver
    counts."""

    def __init__(self):
        self.host_syncs: List[Diagnostic] = []

    def visit_With(self, node):
        if any(_is_graph_capture(i) for i in node.items):
            for stmt in node.body:
                for n in ast.walk(stmt):
                    if not isinstance(n, ast.Call):
                        continue
                    f = n.func
                    if isinstance(f, ast.Attribute) and (
                            f.attr in _SYNC_METHODS
                            or f.attr in _SYNC_CALLS):
                        self.host_syncs.append(Diagnostic(
                            "host-sync",
                            ".%s() inside a torch.cuda.graph capture "
                            "raises (the capture refuses a host read); "
                            "read the value after the capture or keep it "
                            "on the card" % f.attr, line=n.lineno))
        self.generic_visit(node)


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------

@rule("bare-except", "ast",
      "Bare `except:` catches KeyboardInterrupt and the preemption "
      "SIGTERM path; name the exception type.")
def _lint_bare_except(tree, path, ctx):
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield Diagnostic("bare-except",
                             "bare `except:`; catch a named exception "
                             "type", file=path, line=node.lineno)


@rule("mutable-default", "ast",
      "A mutable default argument (list/dict/set literal) is shared "
      "across every call of the function.")
def _lint_mutable_default(tree, path, ctx):
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + \
            [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
                yield Diagnostic(
                    "mutable-default",
                    "function %r has a mutable default argument; use "
                    "None and create it in the body" % node.name,
                    file=path, line=d.lineno)


@rule("host-sync", "ast",
      "A device->host transfer (.asnumpy()/.item()/.cpu()/float()/"
      "np.asarray/torch.cuda.synchronize()) on a traced value inside a "
      "captured scope: a CUDA-graph capture refuses it.")
def _lint_host_sync(tree, path, ctx):
    for fn in _traced_scopes(tree):
        for d in _TracedScopeVisitor(fn).run().host_syncs:
            d.file = path
            yield d
    cap = _CaptureBlockVisitor()
    cap.visit(tree)
    for d in cap.host_syncs:
        d.file = path
        yield d


@rule("tracer-branch", "ast",
      "Python if/while/assert on a traced value inside a captured "
      "scope; the branch taken at capture is frozen into the graph.")
def _lint_tracer_branch(tree, path, ctx):
    for fn in _traced_scopes(tree):
        for d in _TracedScopeVisitor(fn).run().branches:
            d.file = path
            yield d


# ----------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>",
                ignore=()) -> List[Diagnostic]:
    """Lint one source string; applies ``# mxlint: disable`` comments."""
    from .core import RULES
    try:
        tree = ast.parse(source, path)
    except SyntaxError as e:
        return [Diagnostic("syntax-error", str(e), file=path,
                           line=e.lineno or 1)]
    diags: List[Diagnostic] = []
    for r in RULES.values():
        if r.kind != "ast" or r.id in ignore:
            continue
        for d in r.check(tree, path, None):
            d.severity = r.severity
            diags.append(d)
    diags.sort(key=lambda d: (d.line or 0, d.rule))
    return filter_suppressed(diags, source.splitlines())


def lint_file(path, ignore=()) -> List[Diagnostic]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), ignore=ignore)


def lint_paths(paths, ignore=()) -> List[Diagnostic]:
    """Lint files and/or directories (recursing into ``**/*.py``)."""
    diags: List[Diagnostic] = []
    for path in paths:
        p = Path(path)
        if not p.exists():
            diags.append(Diagnostic("no-such-path",
                                    "path does not exist", file=str(p)))
            continue
        files = sorted(p.glob("**/*.py")) if p.is_dir() else [p]
        for f in files:
            diags.extend(lint_file(f, ignore=ignore))
    return diags
