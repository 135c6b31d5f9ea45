"""Concurrency-safety AST pass (counterpart of
``mxnet_tpu/analysis/concurrency.py``).

The serving tier, the checkpoint writer, the device feed, the ops plane
and the always-on loop run threads; this pass makes their lock
discipline machine-checked, the way ``trace_lint`` checks capture
safety.  It

- **inventories** every lock/condition/event/queue the package creates
  (``threading.*`` or the sanitized ``mxnet_tpu_torch.sync`` factories).  A
  ``sync.Lock(name="telemetry.registry")`` creation adopts the literal
  name, so the static graph and the runtime sanitizer
  (``mxnet_tpu_torch/sync.py``) reason about the SAME identities; unnamed
  primitives get a structural ``file:Class.attr`` identity;
- builds a **lock-acquisition-order graph** from lexically nested
  ``with lock:`` scopes across the whole linted tree and reports every
  cycle as ``lock-order-inversion``;
- checks four per-file thread-discipline rules:
  ``unguarded-shared-write``, ``blocking-under-lock``, ``bare-thread``
  and ``sleep-poll``.

Suppress a finding with ``# mxlint: disable=<rule>`` on its line; the
runtime closure of the order graph is ``MXNET_TPU_TSAN=1``
(:mod:`mxnet_tpu_torch.sync`, which seeds its graph from
:func:`static_order_edges`).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Diagnostic, filter_suppressed, rule

__all__ = ["FileInventory", "inventory_file", "order_edges",
           "static_order_edges", "audit_lock_order", "find_cycles"]

# primitive constructors, by the role they play in the order graph
_ORDERED_CTORS = {"Lock", "RLock", "Condition"}   # participate in ordering
_EVENT_CTORS = {"Event"}
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}
_THREAD_CTORS = {"Thread"}
# module aliases the package uses for primitives
_SYNC_MODULES = {"threading", "_threading", "sync", "_sync", "queue"}

# blocking calls flagged under a held lock (rule blocking-under-lock)
_BLOCKING_METHODS = {"wait", "wait_for", "join", "get", "put",
                     "asnumpy", "wait_to_read", "device_get"}
_BLOCKING_FUNCS = {"open", "waitall", "device_get", "sleep"}


def _ctor_of(call: ast.Call) -> Optional[Tuple[str, str]]:
    """``(kind, ctor_name)`` when ``call`` constructs a sync primitive:
    kind is ``lock``/``event``/``queue``/``thread``."""
    f = call.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in _SYNC_MODULES:
        name = f.attr
    elif isinstance(f, ast.Name):
        # `from threading import Lock` style -- only unambiguous names
        if f.id in ("RLock", "Condition"):
            name = f.id
    if name is None:
        return None
    if name in _ORDERED_CTORS:
        return ("lock", name)
    if name in _EVENT_CTORS:
        return ("event", name)
    if name in _QUEUE_CTORS:
        return ("queue", name)
    if name in _THREAD_CTORS:
        return ("thread", name)
    return None


def _name_kwarg(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


class FileInventory:
    """Per-file table of sync primitives and where they bind.

    ``attrs[cls][attr] -> (kind, lock_id, ctor, line)`` for
    ``self.X = ctor()`` bindings; ``globals_``/``locals_`` likewise for
    module-level and function-local bindings (locals keyed by
    ``(funcname, varname)``)."""

    def __init__(self, path: str):
        self.path = path
        self.attrs: Dict[str, Dict[str, tuple]] = {}
        self.globals_: Dict[str, tuple] = {}
        self.locals_: Dict[Tuple[str, str], tuple] = {}

    def _short(self):
        p = Path(self.path)
        return "/".join(p.parts[-2:]) if len(p.parts) >= 2 else p.name

    def record(self, cls, fn, target, call):
        ctor = _ctor_of(call)
        if ctor is None:
            return
        kind, ctor_name = ctor
        explicit = _name_kwarg(call)
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" and cls:
            lock_id = explicit or "%s:%s.%s" % (self._short(), cls,
                                                target.attr)
            self.attrs.setdefault(cls, {})[target.attr] = \
                (kind, lock_id, ctor_name, call.lineno)
        elif isinstance(target, ast.Name):
            if fn is None:
                lock_id = explicit or "%s:%s" % (self._short(), target.id)
                self.globals_[target.id] = (kind, lock_id, ctor_name,
                                            call.lineno)
            else:
                lock_id = explicit or "%s:%s.%s" % (self._short(), fn,
                                                    target.id)
                self.locals_[(fn, target.id)] = (kind, lock_id, ctor_name,
                                                 call.lineno)

    def resolve(self, cls, fn, expr) -> Optional[tuple]:
        """Inventory entry a ``with``-expression / call target names."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls:
            return self.attrs.get(cls, {}).get(expr.attr)
        if isinstance(expr, ast.Name):
            if fn is not None and (fn, expr.id) in self.locals_:
                return self.locals_[(fn, expr.id)]
            return self.globals_.get(expr.id)
        return None

    def primitives(self) -> List[tuple]:
        out = list(self.globals_.values())
        out.extend(v for attrs in self.attrs.values()
                   for v in attrs.values())
        out.extend(self.locals_.values())
        return out


class _InventoryVisitor(ast.NodeVisitor):
    def __init__(self, inv: FileInventory):
        self.inv = inv
        self.cls = None
        self.fn = None

    def visit_ClassDef(self, node):
        prev, self.cls = self.cls, node.name
        prev_fn, self.fn = self.fn, None
        self.generic_visit(node)
        self.cls, self.fn = prev, prev_fn

    def visit_FunctionDef(self, node):
        prev, self.fn = self.fn, node.name
        self.generic_visit(node)
        self.fn = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call):
            for tgt in node.targets:
                self.inv.record(self.cls, self.fn, tgt, node.value)
        self.generic_visit(node)


def inventory_file(tree, path: str) -> FileInventory:
    inv = FileInventory(path)
    _InventoryVisitor(inv).visit(tree)
    return inv


# ----------------------------------------------------------------------
# acquisition-order edges from nested `with` scopes
# ----------------------------------------------------------------------

class _FunctionScopeWalker(ast.NodeVisitor):
    """Walks one file function-by-function, maintaining the lexical
    stack of held (inventoried) locks, and calling ``on_with``/
    ``on_call`` hooks.  Nested function definitions get a fresh held
    stack (they run on their own schedule -- usually another thread)."""

    def __init__(self, inv: FileInventory):
        self.inv = inv
        self.cls = None
        self.fn = None
        self.held: List[tuple] = []     # (lock_id, kind, with_expr, line)

    # hooks --------------------------------------------------------
    def on_with(self, lock_id, kind, node):
        pass

    def on_call(self, node):
        pass

    # scope tracking -----------------------------------------------
    def visit_ClassDef(self, node):
        prev_cls, prev_fn = self.cls, self.fn
        self.cls, self.fn = node.name, None
        self.generic_visit(node)
        self.cls, self.fn = prev_cls, prev_fn

    def visit_FunctionDef(self, node):
        prev_fn, prev_held = self.fn, self.held
        self.fn, self.held = node.name, []
        for stmt in node.body:
            self.visit(stmt)
        self.fn, self.held = prev_fn, prev_held

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            entry = self.inv.resolve(self.cls, self.fn, expr)
            if entry is not None and entry[0] == "lock":
                kind = entry[0]
                self.on_with(entry[1], kind, node)
                self.held.append((entry[1], kind, expr, node.lineno))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        self.on_call(node)
        self.generic_visit(node)


class _EdgeCollector(_FunctionScopeWalker):
    def __init__(self, inv):
        super().__init__(inv)
        self.edges: List[tuple] = []    # (outer_id, inner_id, path, line)

    def on_with(self, lock_id, kind, node):
        if self.held:
            outer = self.held[-1][0]
            if outer != lock_id:
                self.edges.append((outer, lock_id, self.inv.path,
                                   node.lineno))


def order_edges(tree, path) -> List[tuple]:
    """``(outer, inner, file, line)`` acquisition-order edges of one
    file's lexically nested ``with lock:`` scopes."""
    col = _EdgeCollector(inventory_file(tree, path))
    col.visit(tree)
    return col.edges


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


def static_order_edges(paths) -> Set[Tuple[str, str]]:
    """The package-wide acquisition-order edge set -- what
    ``mxnet_tpu_torch.sync.seed_static_order`` folds into the runtime graph."""
    edges = set()
    for path, tree, _src in _parse_tree(paths):
        edges.update((a, b) for a, b, _f, _l in order_edges(tree, path))
    return edges


def find_cycles(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles (as node lists) via SCC decomposition --
    every SCC with more than one node, plus self-loops."""
    index = {}
    low = {}
    on_stack = set()
    stack: List[str] = []
    sccs = []
    counter = [0]
    nodes = set(edges)
    for succs in edges.values():
        nodes.update(succs)

    def strongconnect(v):
        # iterative Tarjan (package files can nest deep)
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or node in edges.get(node, ()):
                    sccs.append(sorted(scc))

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    return sccs


def audit_lock_order(paths, ignore=(), report_files=None
                     ) -> List[Diagnostic]:
    """Cross-file half of the pass: build the global acquisition-order
    graph over ``paths`` and report each cycle at every edge site
    inside it.  ``report_files`` (a set of path strings) restricts
    *reporting* -- not graph construction -- for ``--changed`` runs."""
    if "lock-order-inversion" in ignore:
        return []
    graph: Dict[str, Set[str]] = {}
    sites: Dict[tuple, List[tuple]] = {}   # (a, b) -> [(file, line, lines)]
    for path, tree, src_lines in _parse_tree(paths):
        for a, b, f, line in order_edges(tree, path):
            graph.setdefault(a, set()).add(b)
            sites.setdefault((a, b), []).append((f, line, src_lines))
    diags = []
    for cyc in find_cycles(graph):
        members = set(cyc)
        order = " -> ".join(cyc + [cyc[0]])
        for (a, b), where in sorted(sites.items()):
            if a in members and b in members and b in graph.get(a, ()):
                for f, line, src_lines in where:
                    if report_files is not None and f not in report_files:
                        continue
                    d = Diagnostic(
                        "lock-order-inversion",
                        "acquiring %r while holding %r closes the lock "
                        "cycle [%s]; two threads taking it from "
                        "different entry points deadlock.  Pick one "
                        "global order or drop "
                        "one nesting" % (b, a, order),
                        file=f, line=line)
                    if not filter_suppressed([d], src_lines):
                        continue
                    diags.append(d)
    return diags


@rule("lock-order-inversion", "project",
      "Nested `with lock:` scopes across the tree form a cycle in the "
      "acquisition-order graph -- an A/B-B/A deadlock waiting for the "
      "right schedule.  Runtime closure: MXNET_TPU_TSAN=1.")
def _lint_lock_order(paths, ctx):
    return audit_lock_order(paths)


# ----------------------------------------------------------------------
# per-file rules
# ----------------------------------------------------------------------

def _thread_target_names(tree) -> Set[str]:
    """Names of functions/methods passed as ``target=`` to a Thread
    constructor anywhere in the file."""
    targets = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        ctor = _ctor_of(node)
        if ctor is None or ctor[0] != "thread":
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Name):
                targets.add(v.id)
            elif isinstance(v, ast.Attribute):
                targets.add(v.attr)
    return targets


def _is_guarded(stack_of_withs) -> bool:
    return bool(stack_of_withs)


class _SharedWriteVisitor(ast.NodeVisitor):
    """Collects ``self.X`` writes per class, split into thread-body
    writes and main-path writes, each tagged guarded/unguarded.
    ``__init__``/``_start``-time writes before the thread exists are
    construction, not sharing -- ``__init__`` is exempt."""

    def __init__(self, inv: FileInventory, thread_targets: Set[str]):
        self.inv = inv
        self.thread_targets = thread_targets
        self.cls = None
        self.fn_stack: List[str] = []
        self.with_depth = 0              # inventoried-lock withs held
        # {cls: {attr: {"thread": [(line, guarded)],
        #               "main": [(line, guarded)]}}}
        self.writes: Dict[str, Dict[str, Dict[str, list]]] = {}

    def _in_thread_body(self):
        return any(fn in self.thread_targets for fn in self.fn_stack)

    def visit_ClassDef(self, node):
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def visit_FunctionDef(self, node):
        self.fn_stack.append(node.name)
        prev_depth, self.with_depth = self.with_depth, 0
        self.generic_visit(node)
        self.with_depth = prev_depth
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        fn = self.fn_stack[-1] if self.fn_stack else None
        locked = 0
        for item in node.items:
            entry = self.inv.resolve(self.cls, fn, item.context_expr)
            if entry is not None and entry[0] == "lock":
                locked += 1
        self.with_depth += locked
        for stmt in node.body:
            self.visit(stmt)
        self.with_depth -= locked

    visit_AsyncWith = visit_With

    def _record_write(self, attr_node, line):
        if self.cls is None or not self.fn_stack:
            return
        if self.fn_stack[0] == "__init__":
            return                       # happens-before thread start
        # writes to the sync primitives themselves are lifecycle, not data
        entry = self.inv.attrs.get(self.cls, {}).get(attr_node.attr)
        if entry is not None:
            return
        side = "thread" if self._in_thread_body() else "main"
        rec = self.writes.setdefault(self.cls, {}).setdefault(
            attr_node.attr, {"thread": [], "main": []})
        rec[side].append((line, self.with_depth > 0))

    def _maybe_record(self, target, line):
        if isinstance(target, ast.Subscript):
            # `self.X[...] = v` mutates the shared container X
            target = target.value
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            self._record_write(target, line)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._maybe_record(elt, line)

    def visit_Assign(self, node):
        for tgt in node.targets:
            self._maybe_record(tgt, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._maybe_record(node.target, node.lineno)
        self.generic_visit(node)


@rule("unguarded-shared-write", "ast",
      "An attribute written both inside a Thread(target=...) body and "
      "outside it with at least one side holding no inventoried lock; "
      "the interleaving is a data race.")
def _lint_unguarded_shared_write(tree, path, ctx):
    thread_targets = _thread_target_names(tree)
    if not thread_targets:
        return
    inv = inventory_file(tree, path)
    v = _SharedWriteVisitor(inv, thread_targets)
    v.visit(tree)
    for cls, attrs in sorted(v.writes.items()):
        for attr, rec in sorted(attrs.items()):
            if not rec["thread"] or not rec["main"]:
                continue
            unguarded = [(ln, "thread") for ln, g in rec["thread"]
                         if not g]
            unguarded += [(ln, "main") for ln, g in rec["main"] if not g]
            if not unguarded:
                continue
            line, side = unguarded[0]
            yield Diagnostic(
                "unguarded-shared-write",
                "self.%s is written both inside a thread body and on "
                "the %s path, and this write holds no lock; guard both "
                "sides with one sync lock or hand the value "
                "through a queue" % (attr,
                                     "main" if side == "thread"
                                     else "calling"),
                file=path, line=line)


class _BlockingVisitor(_FunctionScopeWalker):
    """Flags blocking calls made while an inventoried lock is
    lexically held.  ``c.wait()`` where ``c`` is the lock's own
    condition object (the with-context itself) is the condition idiom
    and exempt."""

    def __init__(self, inv):
        super().__init__(inv)
        self.diags: List[Diagnostic] = []

    def _call_name(self, node):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr, f.value
        if isinstance(f, ast.Name):
            return f.id, None
        return None, None

    def on_call(self, node):
        if not self.held:
            return
        name, recv = self._call_name(node)
        if name is None:
            return
        blocking = None
        if recv is None:
            if name in _BLOCKING_FUNCS:
                blocking = "%s()" % name
        else:
            if name in ("wait", "wait_for"):
                # `with cond: cond.wait()` is the condition protocol;
                # waiting on a DIFFERENT primitive while holding is not
                held_expr = self.held[-1][2]
                if ast.dump(recv) == ast.dump(held_expr):
                    return
                blocking = ".%s()" % name
            elif name in ("get", "put"):
                entry = self.inv.resolve(self.cls, self.fn, recv)
                if entry is not None and entry[0] == "queue":
                    blocking = "queue.%s()" % name
            elif name == "join":
                entry = self.inv.resolve(self.cls, self.fn, recv)
                if entry is not None and entry[0] == "thread":
                    blocking = "Thread.join()"
            elif name in ("asnumpy", "wait_to_read", "device_get",
                          "waitall"):
                blocking = ".%s()" % name
            elif name == "sleep" and isinstance(recv, ast.Name) \
                    and recv.id == "time":
                blocking = "time.sleep()"
        if blocking is None and recv is None and name == "open":
            blocking = "open()"
        if blocking is not None:
            lock_id = self.held[-1][0]
            self.diags.append(Diagnostic(
                "blocking-under-lock",
                "%s while holding %r; every other thread needing that "
                "lock stalls behind this call (and a cyclic wait "
                "deadlocks).  Move the blocking call outside the "
                "critical section or hand off through a queue"
                % (blocking, lock_id),
                file=self.inv.path, line=node.lineno))


@rule("blocking-under-lock", "ast",
      "A blocking call (queue get/put, join, wait, device_get/asnumpy/"
      "waitall, open, time.sleep) made while an inventoried lock is "
      "held serializes -- or deadlocks -- every contender.")
def _lint_blocking_under_lock(tree, path, ctx):
    v = _BlockingVisitor(inventory_file(tree, path))
    v.visit(tree)
    yield from v.diags


def _daemonized_before_start(fn_node, var):
    """True when ``var.daemon = True`` appears in ``fn_node``."""
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and tgt.attr == "daemon" \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == var \
                        and isinstance(node.value, ast.Constant) \
                        and node.value.value is True:
                    return True
    return False


@rule("bare-thread", "ast",
      "threading.Thread created without daemon=True (the established "
      "pattern: daemon thread + join on close/reset + errors captured "
      "and re-raised at the consumer).  A non-daemon worker wedges "
      "interpreter shutdown when its consumer dies first.")
def _lint_bare_thread(tree, path, ctx):
    # map each Thread(...) call to its enclosing function for the
    # `t.daemon = True` escape hatch
    class V(ast.NodeVisitor):
        def __init__(self):
            self.fn = None
            self.found = []           # (call, enclosing_fn, assigned_var)

        def visit_FunctionDef(self, node):
            prev, self.fn = self.fn, node
            self.generic_visit(node)
            self.fn = prev

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Assign(self, node):
            if isinstance(node.value, ast.Call):
                ctor = _ctor_of(node.value)
                if ctor is not None and ctor[0] == "thread":
                    var = node.targets[0].id \
                        if isinstance(node.targets[0], ast.Name) else None
                    self.found.append((node.value, self.fn, var))
                    return
            self.generic_visit(node)

        def visit_Call(self, node):
            ctor = _ctor_of(node)
            if ctor is not None and ctor[0] == "thread":
                self.found.append((node, self.fn, None))
            self.generic_visit(node)

    v = V()
    v.visit(tree)
    seen = set()
    for call, fn, var in v.found:
        if id(call) in seen:
            continue
        seen.add(id(call))
        daemon_kw = any(kw.arg == "daemon"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in call.keywords)
        if daemon_kw:
            continue
        if var and fn is not None and _daemonized_before_start(fn, var):
            continue
        yield Diagnostic(
            "bare-thread",
            "threading.Thread without daemon=True; follow the package "
            "pattern (daemon worker + join in close()/reset() + errors "
            "captured and re-raised at the consumer) or the thread "
            "outlives its consumer and wedges shutdown",
            file=path, line=call.lineno)


@rule("sleep-poll", "ast",
      "time.sleep inside a while loop is a polling loop: it burns "
      "latency when the condition flips early and CPU when it never "
      "does.  Wait on an Event/Condition with a timeout instead.")
def _lint_sleep_poll(tree, path, ctx):
    class V(ast.NodeVisitor):
        def __init__(self):
            self.loops = 0
            self.hits = []

        def visit_While(self, node):
            self.loops += 1
            self.generic_visit(node)
            self.loops -= 1

        def visit_FunctionDef(self, node):
            prev, self.loops = self.loops, 0
            self.generic_visit(node)
            self.loops = prev

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            if self.loops and isinstance(f, ast.Attribute) \
                    and f.attr == "sleep" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "time":
                self.hits.append(node)
            self.generic_visit(node)

    v = V()
    v.visit(tree)
    for node in v.hits:
        yield Diagnostic(
            "sleep-poll",
            "time.sleep in a while loop polls; wait on the state "
            "change itself (sync.Event.wait(timeout) / "
            "Condition.wait_for) so the loop wakes the moment the "
            "condition flips",
            file=path, line=node.lineno)
