"""Sharding sanitizer: the SPMD spec linter, the donation auditor and
the collective contracts of the captured steps (counterpart of
``mxnet_tpu/analysis/sharding.py``: its rule ids, findings and
artifact schema).

**Static layer** (AST, under the rule framework; runs in ``mxlint
--self``), the JAX package's rules on the same source give the same
findings:

- ``mesh-axis-unknown`` (project-wide): a ``PartitionSpec``/``P`` names
  an axis no ``Mesh``/``make_mesh`` call in the linted tree declares
  and that is not in the canonical ``parallel.mesh.AXIS_ROLES``
  vocabulary -- the port's parallel layers split by the spec's axis
  names, so an unknown one is a layer that never splits.  Axis names
  reaching ``P(...)`` through variables are resolved best-effort
  (string literals, parameter defaults, ``self._axis``-style attributes
  bound in ``__init__``).
- ``shard-map-spec-arity``: ``shard_map`` ``in_specs``/``out_specs``
  tuple arity vs the body's signature/returns (JAX source the linter
  is pointed at).
- ``undonated-train-state``: a ``jax.jit`` of a train-step-shaped
  function without ``donate_argnums``.
- ``donated-reuse``: an array passed at a donated position is read
  again after the jit call.
- ``implicit-reshard``: ``jax.device_put`` onto a ``NamedSharding``
  inside a loop with no sharding-equivalence guard.

**Compiled layer**: the port has no HLO.  Its in-graph collectives are
``torch.distributed`` calls (:mod:`mxnet_tpu_torch.parallel.
collectives`) that the profiling walk (:mod:`..profiling.aten`)
charges to its ``collective`` category, by kind, when a step's warm-up
is walked into its CostReport.  :func:`collective_contract` gathers
those per-report ``{kind: {count, bytes}}`` profiles into the JAX
package's ``mxshard.collectives.v1`` artifact; :func:`save_contract`/
:func:`diff_contract` and rule ``collective-drift`` (CLI ``mxlint
--collective-diff``) fail, naming the step and the kind, when a step
issues collectives its baseline does not bless.
``MXNET_TPU_SHARD_CHECK=1`` arms the walk (``mx.profiling``) without
asking for profiling.

``transfer_guard``/``MXNET_TPU_TRANSFER_GUARD`` map the JAX transfer
guard's modes onto ``torch.cuda.set_sync_debug_mode``: under
``"disallow"`` a host synchronisation on the card (a ``.item()``, a
copy from pageable host memory inside a step) raises instead of
stalling the step; ``"log"`` warns; ``"allow"`` turns the check off.
The ``*_explicit`` modes are the same levels (the port's explicit
staging copies from pinned memory never synchronise).
"""
from __future__ import annotations

import ast
import contextlib
import json
import os
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Diagnostic, WARNING, filter_suppressed, rule

__all__ = [
    "audit_sharding", "declared_axes",
    "collective_profile", "collective_contract", "save_contract",
    "load_contract", "diff_contract", "CONTRACT_SCHEMA",
    "transfer_guard", "install_transfer_guard", "shard_check_enabled",
]

# constructors that build a partition spec / mesh, by their usual names
_P_FUNCS = {"P", "PartitionSpec"}
_MESH_FUNCS = {"Mesh", "make_mesh"}
_SHARD_MAP_FUNCS = {"shard_map", "_shard_map"}
# module-level assignment targets that declare an axis vocabulary
_AXIS_DECL_RE = re.compile(r"(AXIS|AXES)")
# function names that read as a compiled train step
_STEP_NAME_RE = re.compile(r"(train|step)", re.I)
# positional parameter names that carry param/optimizer-state buffers
_STATE_PARAMS = {"pvals", "svals", "params", "param_vals", "state",
                 "states", "opt_state", "weights", "diff", "nondiff",
                 "train_state", "grads"}


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _param_str_defaults(fn) -> Dict[str, str]:
    """Parameter name -> string-literal default of one function def."""
    out = {}
    a = fn.args
    pos = list(a.posonlyargs) + list(a.args)
    for arg, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if _is_str_const(d):
            out[arg.arg] = d.value
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None and _is_str_const(d):
            out[arg.arg] = d.value
    return out


class _StrEnv:
    """Best-effort map from names/``self.X`` attributes to the string
    literals they are bound to, for resolving axis names that reach a
    ``PartitionSpec`` through a variable."""

    def __init__(self, tree):
        self.module: Dict[str, str] = {}
        self.cls_attrs: Dict[str, Dict[str, str]] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and _is_str_const(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module[t.id] = node.value.value
            elif isinstance(node, ast.ClassDef):
                self.cls_attrs[node.name] = self._attr_strings(node)

    @staticmethod
    def _attr_strings(cls) -> Dict[str, str]:
        out = {}
        for meth in ast.walk(cls):
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            defaults = _param_str_defaults(meth)
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                t = node.targets[0]
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                v = node.value
                if _is_str_const(v):
                    out[t.attr] = v.value
                elif isinstance(v, ast.Name) and v.id in defaults:
                    out[t.attr] = defaults[v.id]
        return out

    def resolve(self, expr, scopes: List[Dict[str, str]],
                cls: Optional[str]) -> Optional[str]:
        """The string ``expr`` denotes, or None when not resolvable."""
        if _is_str_const(expr):
            return expr.value
        if isinstance(expr, ast.Name):
            for env in reversed(scopes):
                if expr.id in env:
                    return env[expr.id]
            return self.module.get(expr.id)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls:
            return self.cls_attrs.get(cls, {}).get(expr.attr)
        return None


def _local_str_env(fn) -> Dict[str, str]:
    """Parameter defaults + simple string assignments of one scope."""
    env = _param_str_defaults(fn) if not isinstance(fn, ast.Lambda) else {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_str_const(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    env[t.id] = node.value.value
    return env


# ----------------------------------------------------------------------
# mesh-axis-unknown (project-wide: declarations span files)
# ----------------------------------------------------------------------

def _parse_tree(paths) -> Iterable[Tuple[str, ast.AST, List[str]]]:
    for path in paths:
        p = Path(path)
        if not p.exists():
            continue
        files = sorted(p.glob("**/*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                src = f.read_text()
                yield str(f), ast.parse(src, str(f)), src.splitlines()
            except (OSError, SyntaxError):
                continue


def _axes_of_tree(tree) -> Set[str]:
    axes: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name == "make_mesh" and node.args \
                    and isinstance(node.args[0], ast.Dict):
                axes.update(k.value for k in node.args[0].keys
                            if _is_str_const(k))
            elif name == "Mesh":
                cand = node.args[1] if len(node.args) >= 2 else None
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        cand = kw.value
                if isinstance(cand, (ast.Tuple, ast.List)):
                    axes.update(e.value for e in cand.elts
                                if _is_str_const(e))
                elif _is_str_const(cand):
                    axes.add(cand.value)
        elif isinstance(node, ast.Assign):
            # `AXIS_ROLES = {...}` / `KNOWN_AXES = (...)` declarations
            named = any(isinstance(t, ast.Name)
                        and _AXIS_DECL_RE.search(t.id)
                        for t in node.targets)
            if not named:
                continue
            v = node.value
            if isinstance(v, ast.Dict):
                axes.update(k.value for k in v.keys if _is_str_const(k))
            elif isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                axes.update(e.value for e in v.elts if _is_str_const(e))
    return axes


def declared_axes(paths) -> Set[str]:
    """Mesh axes the linted tree declares: ``make_mesh({...})`` dict
    keys, ``Mesh(..., (...))`` axis-name tuples, and module-level
    ``*_AXES``/``AXIS_ROLES`` vocabularies."""
    axes: Set[str] = set()
    for _path, tree, _src in _parse_tree(paths):
        axes.update(_axes_of_tree(tree))
    return axes


def _canonical_axes() -> Set[str]:
    """The framework's own axis vocabulary (``parallel.mesh``), so a
    single-file lint doesn't flag the conventional roles the package
    declares elsewhere."""
    try:
        from ..parallel.mesh import AXIS_ROLES
        return set(AXIS_ROLES)
    except Exception:
        return set()


class _SpecAxisVisitor(ast.NodeVisitor):
    """Collects axis-name strings used inside ``P``/``PartitionSpec``
    calls, resolved through the string environment."""

    def __init__(self, tree, path):
        self.path = path
        self.env = _StrEnv(tree)
        self.cls: Optional[str] = None
        self.scopes: List[Dict[str, str]] = []
        self.uses: List[Tuple[str, int]] = []     # (axis, lineno)

    def visit_ClassDef(self, node):
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def visit_FunctionDef(self, node):
        self.scopes.append(_local_str_env(node))
        self.generic_visit(node)
        self.scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node):
        if _call_name(node) in _P_FUNCS:
            for arg in node.args:
                elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                    else [arg]
                for e in elts:
                    if isinstance(e, ast.Starred):
                        continue
                    axis = self.env.resolve(e, self.scopes, self.cls)
                    if axis is not None:
                        self.uses.append((axis, e.lineno))
        self.generic_visit(node)


def audit_sharding(paths, ignore=(), report_files=None
                   ) -> List[Diagnostic]:
    """Project half of the pass: gather declared mesh axes over the
    whole linted tree, then flag every ``PartitionSpec`` axis outside
    that vocabulary.  ``report_files`` restricts *reporting* -- not the
    declaration scan -- for ``--changed`` runs (same contract as
    ``concurrency.audit_lock_order``)."""
    if "mesh-axis-unknown" in ignore:
        return []
    trees = list(_parse_tree(paths))
    known = _canonical_axes()
    for _path, tree, _src in trees:
        known.update(_axes_of_tree(tree))
    diags: List[Diagnostic] = []
    for path, tree, src_lines in trees:
        if report_files is not None and path not in report_files:
            continue
        v = _SpecAxisVisitor(tree, path)
        v.visit(tree)
        file_diags = []
        for axis, line in v.uses:
            if axis in known:
                continue
            hint = ""
            if known:
                import difflib
                close = difflib.get_close_matches(axis, sorted(known), 1)
                if close:
                    hint = "; did you mean %r?" % close[0]
            file_diags.append(Diagnostic(
                "mesh-axis-unknown",
                "PartitionSpec names mesh axis %r but no Mesh/"
                "make_mesh in the linted tree declares it (known: "
                "%s)%s -- an unknown axis silently replicates instead "
                "of sharding" % (axis, ", ".join(sorted(known)) or
                                 "<none>", hint),
                file=path, line=line))
        diags.extend(filter_suppressed(file_diags, src_lines))
    return diags


@rule("mesh-axis-unknown", "project",
      "A PartitionSpec names a mesh axis no Mesh/make_mesh call in the "
      "linted tree declares (and that is outside parallel.mesh."
      "AXIS_ROLES); XLA treats an unknown axis as replicated -- the "
      "shard silently never happens.")
def _rule_mesh_axis(paths, ctx):
    return audit_sharding(paths)


# ----------------------------------------------------------------------
# shard-map-spec-arity (per-file)
# ----------------------------------------------------------------------

def _positional_params(fn) -> Tuple[List[str], bool]:
    a = fn.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
    if names and names[0] == "self":
        names = names[1:]
    return names, a.vararg is not None


def _file_defs_and_assigns(tree):
    defs = {}
    assigns = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns[node.targets[0].id] = node.value
    return defs, assigns


def _resolve_body(expr, defs, assigns, depth=0):
    """``(positional_param_names, has_vararg, fn_node_or_None)`` of a
    shard_map body expression, following names and functools.partial."""
    if depth > 4 or expr is None:
        return None
    if isinstance(expr, ast.Lambda):
        names, vararg = _positional_params(expr)
        return names, vararg, None
    if isinstance(expr, (ast.FunctionDef, ast.AsyncFunctionDef)):
        names, vararg = _positional_params(expr)
        return names, vararg, expr
    if isinstance(expr, ast.Name):
        if expr.id in defs:
            return _resolve_body(defs[expr.id], defs, assigns, depth + 1)
        if expr.id in assigns:
            return _resolve_body(assigns[expr.id], defs, assigns,
                                 depth + 1)
        return None
    if isinstance(expr, ast.Call) and _call_name(expr) == "partial" \
            and expr.args:
        inner = _resolve_body(expr.args[0], defs, assigns, depth + 1)
        if inner is None:
            return None
        names, vararg, fn_node = inner
        consumed = len(expr.args) - 1
        kwnames = {kw.arg for kw in expr.keywords if kw.arg}
        remaining = [n for n in names[consumed:] if n not in kwnames]
        return remaining, vararg, fn_node
    return None


def _own_returns(fn) -> List[ast.expr]:
    """Return expressions at the body function's own level (nested defs
    excluded -- their returns belong to another computation)."""
    out = []
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Return) and n.value is not None:
            out.append(n.value)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _spec_arity(expr) -> Optional[int]:
    """Arity of a specs argument: only literal tuples/lists count (a
    single spec is a pytree prefix broadcast over every arg)."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        if any(isinstance(e, ast.Starred) for e in expr.elts):
            return None
        return len(expr.elts)
    return None


@rule("shard-map-spec-arity", "ast",
      "shard_map in_specs/out_specs tuple arity disagrees with the "
      "body's positional signature / returned tuple (including the "
      "parallel._shard_map compat wrapper and functools.partial "
      "bodies); jax raises a cryptic tree-mismatch at trace time.")
def _lint_shard_map_arity(tree, path, ctx):
    defs, assigns = _file_defs_and_assigns(tree)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node) in _SHARD_MAP_FUNCS and node.args):
            continue
        kwargs = {kw.arg: kw.value for kw in node.keywords if kw.arg}
        in_specs = kwargs.get(
            "in_specs", node.args[2] if len(node.args) > 2 else None)
        out_specs = kwargs.get(
            "out_specs", node.args[3] if len(node.args) > 3 else None)
        body = _resolve_body(node.args[0], defs, assigns)
        if body is None:
            continue
        names, vararg, fn_node = body
        n_in = _spec_arity(in_specs)
        if n_in is not None and not vararg and n_in != len(names):
            yield Diagnostic(
                "shard-map-spec-arity",
                "shard_map body takes %d positional arg(s) %s but "
                "in_specs has %d spec(s)" % (len(names), names, n_in),
                file=path, line=node.lineno)
        n_out = _spec_arity(out_specs)
        if n_out is not None and fn_node is not None:
            rets = _own_returns(fn_node)
            if rets and all(isinstance(r, ast.Tuple) for r in rets):
                lens = {len(r.elts) for r in rets}
                if len(lens) == 1 and lens != {n_out}:
                    yield Diagnostic(
                        "shard-map-spec-arity",
                        "shard_map body returns a %d-tuple but "
                        "out_specs has %d spec(s)"
                        % (lens.pop(), n_out),
                        file=path, line=node.lineno)


# ----------------------------------------------------------------------
# undonated-train-state (per-file)
# ----------------------------------------------------------------------

def _is_jit_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "jit" \
            and isinstance(f.value, ast.Name) and f.value.id == "jax":
        return True
    return isinstance(f, ast.Name) and f.id == "jit"


def _has_donation(call: ast.Call, enclosing_fn) -> bool:
    for kw in call.keywords:
        if kw.arg in ("donate_argnums", "donate_argnames"):
            return True
        if kw.arg is None and isinstance(kw.value, ast.Name) \
                and enclosing_fn is not None:
            # jax.jit(fn, **jit_kwargs) with a conditional
            # jit_kwargs["donate_argnums"] = ... in the enclosing scope
            # (the parallel.data_parallel idiom) counts as donated
            target = kw.value.id
            for n in ast.walk(enclosing_fn):
                if not isinstance(n, ast.Assign):
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == target \
                            and _is_str_const(t.slice) \
                            and t.slice.value in ("donate_argnums",
                                                  "donate_argnames"):
                        return True
    return False


@rule("undonated-train-state", "ast",
      "A jax.jit of a train-step-shaped function (name contains "
      "train/step, or positional params carry param/optimizer-state "
      "names) without donate_argnums: every dispatch keeps input AND "
      "output state buffers live, doubling peak HBM.  Donate the state "
      "argnums, or suppress with the reason the buffers must survive.")
def _lint_undonated_train_state(tree, path, ctx):
    defs, assigns = _file_defs_and_assigns(tree)

    class V(ast.NodeVisitor):
        def __init__(self):
            self.fn = None
            self.hits = []

        def visit_FunctionDef(self, node):
            prev, self.fn = self.fn, node
            self.generic_visit(node)
            self.fn = prev

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            if _is_jit_call(node) and node.args:
                self.hits.append((node, self.fn))
            self.generic_visit(node)

    v = V()
    v.visit(tree)
    for call, enclosing in v.hits:
        body = _resolve_body(call.args[0], defs, assigns)
        if body is None:
            continue
        names, _vararg, fn_node = body
        fn_name = fn_node.name if fn_node is not None else ""
        stateish = sorted(set(names) & _STATE_PARAMS)
        if not (_STEP_NAME_RE.search(fn_name) or stateish):
            continue
        if _has_donation(call, enclosing):
            continue
        why = ("is named %r" % fn_name) if _STEP_NAME_RE.search(fn_name) \
            else ("takes state buffers %s" % stateish)
        yield Diagnostic(
            "undonated-train-state",
            "jax.jit of a step function that %s has no donate_argnums; "
            "the un-donated input state stays live across the dispatch "
            "(2x peak HBM for params+optimizer state).  Donate the "
            "state argnums or suppress with the reason the buffers "
            "must outlive the call" % why,
            file=path, line=call.lineno)


# ----------------------------------------------------------------------
# donated-reuse (per-file, same-scope)
# ----------------------------------------------------------------------

def _donated_positions(call: ast.Call) -> Optional[List[int]]:
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return [v.value]
            if isinstance(v, (ast.Tuple, ast.List)):
                out = []
                for e in v.elts:
                    if not (isinstance(e, ast.Constant)
                            and isinstance(e.value, int)):
                        return None
                    out.append(e.value)
                return out
    return None


@rule("donated-reuse", "ast",
      "An array passed at a donated argnum is read again after the "
      "donating jit call; donation hands the buffer to XLA and the "
      "later read sees a deleted array (jax raises on some backends, "
      "silently aliases on others).  Use the returned array.")
def _lint_donated_reuse(tree, path, ctx):
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        body = scope.body if isinstance(scope, ast.Module) else scope.body
        # donating jits assigned to a name in THIS scope
        donated_fns = {}           # name -> positions
        for node in body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _is_jit_call(node.value) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                pos = _donated_positions(node.value)
                if pos:
                    donated_fns[node.targets[0].id] = pos
        if not donated_fns:
            continue
        # name events in statement order (nested defs excluded: they run
        # on their own schedule)
        events = []                # (lineno, name, is_store)
        calls = []                 # (lineno, [donated arg names])
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in donated_fns:
                donated = []
                for i in donated_fns[n.func.id]:
                    if i < len(n.args) and isinstance(n.args[i],
                                                      ast.Name):
                        donated.append(n.args[i].id)
                if donated:
                    calls.append((n.lineno, donated))
            if isinstance(n, ast.Name):
                events.append((n.lineno, n.id,
                               isinstance(n.ctx, ast.Store)))
            stack.extend(ast.iter_child_nodes(n))
        for call_line, names in calls:
            for name in names:
                stores_after = [ln for ln, nm, st in events
                                if nm == name and st and ln >= call_line]
                for ln, nm, st in sorted(events):
                    if nm != name or st or ln <= call_line:
                        continue
                    if any(s <= ln for s in stores_after):
                        break      # rebound before this read
                    yield Diagnostic(
                        "donated-reuse",
                        "%r was donated to the jit call on line %d and "
                        "is read again here; the buffer no longer "
                        "exists -- use the jit call's returned array"
                        % (name, call_line),
                        file=path, line=ln)
                    break          # one diagnostic per donated name


# ----------------------------------------------------------------------
# implicit-reshard (per-file)
# ----------------------------------------------------------------------

def _sharding_ish(expr, sharded_names: Set[str]) -> bool:
    """Heuristic: the expression denotes a NamedSharding."""
    if isinstance(expr, ast.Call):
        name = _call_name(expr) or ""
        return name == "NamedSharding" or "sharding" in name.lower()
    if isinstance(expr, ast.Name):
        return expr.id in sharded_names
    if isinstance(expr, ast.Attribute):
        return "sharding" in expr.attr.lower()
    return False


@rule("implicit-reshard", "ast",
      "jax.device_put onto a NamedSharding inside a for/while loop "
      "with no sharding-equivalence guard: an already-committed array "
      "resharded every iteration is hidden per-step collective/"
      "transfer traffic.  Place once outside the loop, or guard with "
      "`if not x.sharding.is_equivalent_to(want, ndim)`.")
def _lint_implicit_reshard(tree, path, ctx):
    class V(ast.NodeVisitor):
        def __init__(self):
            self.loops = 0
            self.guards = 0
            self.sharded_names: List[Set[str]] = [set()]
            self.hits = []

        def visit_FunctionDef(self, node):
            prev_loops, self.loops = self.loops, 0
            prev_guards, self.guards = self.guards, 0
            self.sharded_names.append(set())
            self.generic_visit(node)
            self.sharded_names.pop()
            self.loops, self.guards = prev_loops, prev_guards

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Assign(self, node):
            if isinstance(node.value, ast.Call) \
                    and _sharding_ish(node.value, set()):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.sharded_names[-1].add(t.id)
            self.generic_visit(node)

        def _loop(self, node):
            self.loops += 1
            self.generic_visit(node)
            self.loops -= 1

        visit_For = _loop
        visit_While = _loop
        visit_AsyncFor = _loop

        def visit_If(self, node):
            guarded = any(
                isinstance(n, ast.Attribute)
                and n.attr in ("is_equivalent_to", "sharding")
                for n in ast.walk(node.test))
            self.guards += 1 if guarded else 0
            self.generic_visit(node)
            self.guards -= 1 if guarded else 0

        def visit_Call(self, node):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "device_put" \
                    and self.loops and not self.guards \
                    and len(node.args) >= 2:
                names = set()
                for s in self.sharded_names:
                    names |= s
                if _sharding_ish(node.args[1], names):
                    self.hits.append(node)
            self.generic_visit(node)

    v = V()
    v.visit(tree)
    for node in v.hits:
        yield Diagnostic(
            "implicit-reshard",
            "device_put onto a NamedSharding inside a loop: a "
            "committed array is resharded every iteration (hidden "
            "collective/transfer per step).  Hoist the placement out "
            "of the loop or guard with sharding.is_equivalent_to",
            file=path, line=node.lineno)


# ----------------------------------------------------------------------
# Compiled layer: collective contracts over the walked steps
# ----------------------------------------------------------------------

CONTRACT_SCHEMA = "mxshard.collectives.v1"


def shard_check_enabled() -> bool:
    """Whether ``MXNET_TPU_SHARD_CHECK=1`` armed the walk of each
    step's warm-up for the collective auditor (it rides the
    ``mx.profiling`` capture surface)."""
    return os.environ.get("MXNET_TPU_SHARD_CHECK", "0") != "0"


def collective_profile(report) -> Dict[str, Dict[str, int]]:
    """Per-kind collective counts/bytes of one walked step:
    ``{"all-reduce": {"count": 2, "bytes": 4096}, ...}``, from a
    CostReport (its ``collectives``) or a finished
    :class:`~..profiling.aten.Walk`.  Kinds use the JAX package's HLO
    names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``, ``broadcast``); bytes are
    each call's payload."""
    if hasattr(report, "collectives") and callable(report.collectives):
        prof = report.collectives()
    else:
        prof = report.get("collectives") or {}
    return {k: {"count": int(v["count"]), "bytes": int(v["bytes"])}
            for k, v in sorted(prof.items())}


def collective_contract() -> dict:
    """The current process's collective contract: every CostReport the
    profiling/shard-check capture surface stored, profiled for
    collectives.  Reports with no collectives are omitted --
    ``diff_contract`` treats a missing entry as zero, so a label that
    gains collectives is flagged even when the baseline never listed
    it."""
    from ..profiling import store
    execs: Dict[str, Dict[str, Dict[str, int]]] = {}
    for rep in store.reports():
        prof = collective_profile(rep)
        if not prof:
            continue
        agg = execs.setdefault(rep.get("label", "executable"), {})
        for kind, rec in prof.items():
            cur = agg.setdefault(kind, {"count": 0, "bytes": 0})
            cur["count"] += rec["count"]
            cur["bytes"] += rec["bytes"]
    try:
        import torch
        import torch.distributed as dist
        backend = "cuda" if torch.cuda.is_available() else "cpu"
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
    except Exception:
        backend, n_dev = "unknown", 0
    return {"schema": CONTRACT_SCHEMA, "backend": backend,
            "n_devices": n_dev, "executables": execs}


def save_contract(path: str) -> dict:
    """Write the current collective contract as JSON (the artifact a
    gate diffs against a committed baseline)."""
    c = collective_contract()
    with open(path, "w") as f:
        json.dump(c, f, indent=1, sort_keys=True)
        f.write("\n")
    return c


def load_contract(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != CONTRACT_SCHEMA:
        raise ValueError("%s is not a %s artifact (schema=%r)"
                         % (path, CONTRACT_SCHEMA, data.get("schema")))
    return data


def diff_contract(baseline: dict, current: dict,
                  bytes_tol: float = 0.5) -> List[Diagnostic]:
    """Collective drift of ``current`` vs the blessed ``baseline``:

    - a collective kind the baseline doesn't bless for that step (or a
      new step with collectives) -> error;
    - a blessed kind whose count GREW -> error;
    - a blessed kind whose bytes grew past ``bytes_tol`` -> warning.

    Fewer/smaller collectives than blessed pass silently (an
    improvement is not drift); re-bless with ``save_contract`` after
    an intentional change."""
    diags: List[Diagnostic] = []
    base_ex = baseline.get("executables", {})
    for label, kinds in sorted(current.get("executables", {}).items()):
        blessed = base_ex.get(label, {})
        for kind, rec in sorted(kinds.items()):
            b = blessed.get(kind)
            if b is None:
                diags.append(Diagnostic(
                    "collective-drift",
                    "executable %r gained %d unblessed %r "
                    "collective(s) (%d bytes): the step issues "
                    "collective traffic the baseline does not bless -- "
                    "fix the PartitionSpec (or re-bless via "
                    "analysis.sharding.save_contract)"
                    % (label, rec["count"], kind, rec["bytes"]),
                    node=label))
            elif rec["count"] > b["count"]:
                diags.append(Diagnostic(
                    "collective-drift",
                    "executable %r: %r collectives grew %d -> %d; the "
                    "captured step is moving more data over the "
                    "interconnect than the baseline blesses"
                    % (label, kind, b["count"], rec["count"]),
                    node=label))
            elif b.get("bytes", 0) > 0 and \
                    rec["bytes"] > b["bytes"] * (1.0 + bytes_tol):
                diags.append(Diagnostic(
                    "collective-drift",
                    "executable %r: %r collective bytes grew %d -> %d "
                    "(> %d%% tolerance)"
                    % (label, kind, b["bytes"], rec["bytes"],
                       int(bytes_tol * 100)),
                    node=label, severity=WARNING))
    return diags


@rule("collective-drift", "compiled",
      "A walked step's collectives (kind/count/bytes per step) drifted "
      "past the committed baseline contract -- a mismatched "
      "PartitionSpec became extra collective traffic.  Gate: mxlint "
      "--collective-diff.")
def _rule_collective_drift(baseline, current):
    return diff_contract(baseline, current)


# ----------------------------------------------------------------------
# Transfer guard
# ----------------------------------------------------------------------

_GUARD_MODES = ("allow", "log", "disallow", "log_explicit",
                "disallow_explicit")
# the JAX guard's modes as torch's sync-debug levels
_SYNC_LEVEL = {"allow": 0, "log": 1, "log_explicit": 1, "disallow": 2,
               "disallow_explicit": 2}


def _check_mode(mode):
    if mode not in _GUARD_MODES:
        from ..base import MXNetError
        raise MXNetError("transfer guard mode %r is not one of %s"
                         % (mode, ", ".join(_GUARD_MODES)))


def _set_level(level):
    import torch
    if not torch.cuda.is_available():
        return None
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(level)
    return prev


@contextlib.contextmanager
def transfer_guard(mode="disallow"):
    """Scoped guard: inside the context a host synchronisation on the
    card raises under ``"disallow"`` (warns under ``"log"``) instead of
    silently stalling the step.  ``torch.cuda.set_sync_debug_mode`` is
    process-wide, so the guard covers every thread while it is on.
    Without a card there is nothing to guard and it is a no-op."""
    _check_mode(mode)
    prev = _set_level(_SYNC_LEVEL[mode])
    try:
        yield
    finally:
        if prev is not None:
            _set_level(prev)


def install_transfer_guard(mode=None):
    """Apply the process-global guard (called at package import when
    ``MXNET_TPU_TRANSFER_GUARD`` is set).  Returns the installed mode or
    None."""
    mode = mode if mode is not None else \
        os.environ.get("MXNET_TPU_TRANSFER_GUARD", "")
    if not mode:
        return None
    _check_mode(mode)
    _set_level(_SYNC_LEVEL[mode])
    return mode
