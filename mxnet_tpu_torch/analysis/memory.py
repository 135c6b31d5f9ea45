"""hbmlint: the memory-pressure sanitizer (counterpart of
``mxnet_tpu/analysis/memory.py``): static rules, the memory audit of the
walked steps with :func:`hbm_plan`, and the runtime leak sentinel.

**Static layer** (AST; runs in ``python -m mxnet_tpu_torch.analysis
--self``): the JAX package's five rules, ids and findings on the same
source, with torch's spellings besides (``x.cpu()``/``x.numpy()`` as
host copies, ``torch.zeros(4096, 4096)`` as a static shape,
``.cuda()`` staging):

- ``device-ref-accumulation``: appending device tensors/NDArrays to a
  container inside a training/step loop -- every retained reference
  pins a device buffer, so ``losses.append(loss)`` keeps one activation
  set alive per step.
- ``unbounded-shape-cache``: a module/class-level dict cache keyed on
  shape/dtype with no LRU bound or eviction -- one captured graph or
  buffer pinned per novel input shape.
- ``host-materialize-large``: ``asnumpy``/``cpu``/``device_get`` of a
  tensor whose static shape exceeds a threshold inside a loop body -- a
  many-MB host copy per iteration.
- ``retained-temp-across-step``: a jit output bound to ``self.X`` in a
  step loop without donation or an explicit delete.
- ``feed-depth-unbounded``: a queue/deque staging device arrays
  constructed without ``maxlen``/``maxsize``.

**Walked layer**: :func:`memory_audit` reads each CostReport's memory
section, per graph-owner key: its inputs, parameters and optimizer
state (``argument_bytes``), its outputs, the argument buffers it writes
in place (``alias_bytes``, the JAX package's donated buffers; with the
outputs shaped like an argument, ``donatable_bytes``), and its peak --
on the card the warm-up's ``torch.cuda.max_memory_allocated`` and at
least the arguments plus the key's graph pool once captured.  The
artifact's keys are the JAX package's (schema ``mxmemory.audit.v1``):
a temp-share advisory (temporaries above k x the arguments) and an
alias-coverage advisory (donatable bytes not written in place), gated
by ``save_audit``/``diff_audit`` and ``--memory-diff`` (rule
``memory-drift``).  :func:`hbm_plan` extrapolates peak device memory
across batch buckets along the line through two measured peaks
(``BucketExecutorPool.hbm_plan`` calls it with its warm-up peaks).

**Runtime layer**: the live-memory leak sentinel.  Behind
``MXNET_TPU_MEMORY_WATCH=1`` (one module-flag check when off),
``ContinuousTrainer`` ticks a :class:`LeakSentinel` per step, which
takes a census (:func:`live_census`) at every goodput-window boundary
and flags monotonic live-bytes growth (EWMA+MAD, the goodput ledger's
machinery) naming the top-growing shape/dtype bucket -- publish-guard
aware, so a checkpoint snapshot spike never flags.

Torch has no ``live_arrays()``.  The census total on the card is the
caching allocator's (``torch.cuda.memory_stats``: allocated bytes and
active blocks, CUDA-graph pools included), one call and no walk; the
live tensors are walked for the shape/dtype buckets only when a window
flags, never every window (a heap-wide walk stalls every other thread
of a serving process).  On the CPU the census walks the live tensors.

The ``memory.leak`` chaos fail point (action :func:`pin_action`) pins
tensors in a hidden list so the sentinel, not the injector, must catch
the growth.
"""
from __future__ import annotations

import ast
import gc
import json
import os
import re
import warnings
from typing import Dict, List, Optional

import torch

from .. import env as _env
from ..base import MXNetError
from ._ast_util import (_call_name, _file_defs_and_assigns, _has_donation,
                        _is_jit_call)
from .core import Diagnostic, rule
from .perf import _chain, _is_train_loop, _own_loops

__all__ = [
    "AUDIT_SCHEMA", "THRESHOLDS",
    "memory_audit", "save_audit", "load_audit", "diff_audit", "hbm_plan",
    "device_hbm_bytes", "watch_enabled", "live_census", "walk_buckets",
    "LeakSentinel", "sentinel", "reset_watch", "pin_action", "pinned_count", "unpin_all",
    "status_row",
]


def _fmt_bytes(v) -> str:
    """Human bytes -- same rendering as mxprof (profiling.cli)."""
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if v >= div:
            return "%.2f %s" % (v / div, unit)
    return "%d B" % v


# ----------------------------------------------------------------------
# shared AST helpers
# ----------------------------------------------------------------------

# chains rooted here produce device arrays (nd.zeros, jnp.square,
# jax.device_put); np.* is HOST and deliberately absent
_DEVICE_ROOTS = {"nd", "jnp", "jax"}

# a call through one of these leaves lands the value host-side -- the
# blessed way to record a per-step scalar without pinning the buffer
_HOST_ESCAPES = {"float", "int", "bool", "str", "item", "asnumpy",
                 "asscalar", "tolist", "device_get", "asarray",
                 "cpu", "numpy"}

# callables whose result is (conservatively) a device value: the step
# fn itself, forward passes, loss computation
_MODEL_CALL_RE = re.compile(r"(step|forward|loss|net|model|block)", re.I)


def _is_host_escape(expr) -> bool:
    """Does ``expr`` materialize its value host-side (float(loss),
    loss.item(), x.asnumpy(), jax.device_get(x))?"""
    if not isinstance(expr, ast.Call):
        return False
    parts = _chain(expr.func)
    return bool(parts) and parts[-1] in _HOST_ESCAPES


def _is_device_producing(expr) -> bool:
    """Conservatively: does ``expr`` produce a device array -- an
    nd/jnp/jax chain call, or a model/step/loss-shaped call?"""
    if not isinstance(expr, ast.Call):
        return False
    if _is_host_escape(expr):
        return False
    parts = _chain(expr.func)
    if not parts:
        return False
    if parts[0] in _DEVICE_ROOTS:
        return True
    if _MODEL_CALL_RE.search(parts[-1]):
        # ...unless an argument already escaped to host
        return True
    # method call on a device-producing receiver: loss.mean()
    if isinstance(expr.func, ast.Attribute) and \
            _is_device_producing(expr.func.value):
        return True
    return False


def _loop_body_walk(loop):
    """Statements/expressions lexically in a loop body, nested defs and
    inner loops excluded (inner loops report themselves)."""
    stack = list(loop.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.For, ast.While)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _loop_device_taints(loop) -> set:
    """Names assigned a device value inside the loop body -- the
    references whose retention pins a buffer per iteration."""
    tainted = set()
    for _ in range(2):          # two passes: forward-flowing reuse
        for n in _loop_body_walk(loop):
            if not isinstance(n, (ast.Assign, ast.AugAssign)):
                continue
            value = n.value
            hot = _is_device_producing(value) or (
                isinstance(value, ast.Name) and value.id in tainted) or (
                isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id in tainted)
            if not hot:
                continue
            targets = n.targets if isinstance(n, ast.Assign) \
                else [n.target]
            for tgt in targets:
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
    return tainted


def _is_device_ref(expr, tainted) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_is_device_ref(e, tainted) for e in expr.elts)
    if isinstance(expr, ast.Attribute):
        return _is_device_ref(expr.value, tainted)
    return _is_device_producing(expr)


# ----------------------------------------------------------------------
# device-ref-accumulation
# ----------------------------------------------------------------------

@rule("device-ref-accumulation", "ast",
      "A device array/NDArray appended to a container inside a "
      "training loop: every retained reference pins its device buffer, "
      "so the list grows one activation set per step -- the classic "
      "slow HBM leak an OOM ten thousand steps in is made of.  Append "
      "a host scalar (float(loss), loss.item()) or bound the "
      "container (collections.deque(maxlen=N)).")
def _lint_device_ref_accumulation(tree, path, ctx):
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        if not _is_train_loop(loop):
            continue
        tainted = _loop_device_taints(loop)
        for n in _loop_body_walk(loop):
            hot = None
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ("append", "extend", "appendleft") \
                    and n.args:
                # deque(maxlen=...) is the blessed bounded form, but a
                # deque is not resolvable here; flag only list-ish
                # receivers (a Name/attribute) -- the sweep's fixtures
                # cover both polarities
                if _is_device_ref(n.args[0], tainted):
                    hot = n
            elif isinstance(n, ast.AugAssign) and \
                    isinstance(n.op, ast.Add) and \
                    isinstance(n.value, (ast.List, ast.Tuple)) and \
                    any(_is_device_ref(e, tainted)
                        for e in n.value.elts):
                hot = n
            if hot is None:
                continue
            yield Diagnostic(
                "device-ref-accumulation",
                "device array accumulated into a container inside a "
                "training loop (line %d): each retained reference "
                "pins a device buffer, growing HBM one entry per "
                "step.  Did you mean to append a host scalar "
                "(float(x) / x.item() / x.asnumpy()) or use "
                "collections.deque(maxlen=N)?" % hot.lineno,
                file=path, line=hot.lineno)


# ----------------------------------------------------------------------
# unbounded-shape-cache
# ----------------------------------------------------------------------

_SHAPE_ATTR_RE = re.compile(r"^(shape|dtype|aval|ndim)$")
_SHAPE_NAME_RE = re.compile(r"shape|dtype|sig|aval|fingerprint", re.I)


def _mentions_shape(expr, depth=0) -> bool:
    """Does the key expression spell shape/dtype (``x.shape``,
    ``str(a.dtype)``, a name like ``sig``/``shape_key``)?"""
    if expr is None or depth > 6:
        return False
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and _SHAPE_ATTR_RE.match(n.attr):
            return True
        if isinstance(n, ast.Name) and _SHAPE_NAME_RE.search(n.id):
            return True
    return False


def _module_and_class_dicts(tree) -> Dict[str, int]:
    """Names bound to a fresh dict at module or class level -- the
    long-lived caches whose growth nothing bounds."""
    out = {}
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)]
    for scope in scopes:
        for node in scope.body:
            tgt = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt, value = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                tgt, value = node.target.id, node.value
            if tgt is None or value is None:
                continue
            if isinstance(value, ast.Dict) and not value.keys:
                out[tgt] = node.lineno
            elif isinstance(value, ast.Call) and \
                    _call_name(value) == "dict" and not value.args \
                    and not value.keywords:
                out[tgt] = node.lineno
    return out


def _eviction_evidence(tree, name) -> bool:
    """Anything in the file that bounds ``name``: pop/popitem/del, a
    ``len(name)`` comparison (an explicit bound check), or an LRU
    move_to_end."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr in ("pop", "popitem", "move_to_end") and \
                isinstance(n.func.value, ast.Name) and \
                n.func.value.id == name:
            return True
        if isinstance(n, ast.Delete):
            for t in n.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == name:
                    return True
        if isinstance(n, ast.Compare):
            for side in [n.left] + list(n.comparators):
                if isinstance(side, ast.Call) and \
                        _call_name(side) == "len" and side.args and \
                        isinstance(side.args[0], ast.Name) and \
                        side.args[0].id == name:
                    return True
    return False


@rule("unbounded-shape-cache", "ast",
      "A module/class-level dict cache keyed on shape/dtype with no "
      "LRU bound or eviction anywhere in the file: every novel input "
      "shape pins another compiled program / device buffer forever -- "
      "the unbounded Predictor cache pattern.  Bound it (pop the oldest "
      "past N entries, like MXNET_TPU_SERVING_PREDICTOR_CACHE) or "
      "suppress with the invariant that bounds the key space.")
def _lint_unbounded_shape_cache(tree, path, ctx):
    caches = _module_and_class_dicts(tree)
    if not caches:
        return
    defs, _assigns = _file_defs_and_assigns(tree)
    # per-function name -> latest assigned value, for resolving a key
    # precomputed as `key = (x.shape, x.dtype)` two lines above
    reported = set()
    for fn in [tree] + list(defs.values()):
        local = {}
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                local[n.targets[0].id] = n.value
        for n in ast.walk(fn):
            name = key = None
            if isinstance(n, ast.Assign):
                for tgt in n.targets:
                    if isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id in caches:
                        name, key = tgt.value.id, tgt.slice
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "setdefault" and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id in caches and n.args:
                name, key = n.func.value.id, n.args[0]
            if name is None or (name, path) in reported:
                continue
            shapey = _mentions_shape(key)
            if not shapey and isinstance(key, ast.Name) and \
                    key.id in local:
                shapey = _mentions_shape(local[key.id])
            if not shapey:
                continue
            if _eviction_evidence(tree, name):
                continue
            reported.add((name, path))
            yield Diagnostic(
                "unbounded-shape-cache",
                "dict cache %r is keyed on shape/dtype but nothing in "
                "this file ever evicts from it: every novel shape "
                "pins another entry (compiled program / device "
                "buffer) forever.  Did you mean an LRU bound "
                "(pop the oldest past N entries) or an explicit "
                "invariant suppression?" % name,
                file=path, line=n.lineno)


# ----------------------------------------------------------------------
# host-materialize-large
# ----------------------------------------------------------------------

_CREATOR_LEAVES = {"zeros", "ones", "full", "empty", "uniform",
                   "normal", "array"}
# torch's spellings besides: x.cpu(), x.numpy()
_MATERIALIZE_LEAVES = {"asnumpy", "device_get", "cpu", "numpy"}


def _literal_elems(node) -> Optional[int]:
    """Element count a literal shape spells, None when not static."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        total = 1
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, int)):
                return None
            total *= e.value
        return total
    return None


def _static_shapes(scope) -> Dict[str, int]:
    """Name -> static element count for arrays created with a literal
    shape in ``scope`` (``x = nd.zeros((4096, 4096))``)."""
    out = {}
    for n in ast.walk(scope):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n is not scope:
            continue
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Call)):
            continue
        parts = _chain(n.value.func)
        if not parts or parts[-1] not in _CREATOR_LEAVES:
            continue
        shape_node = n.value.args[0] if n.value.args else None
        if len(n.value.args) > 1 and parts[-1] != "full":
            # torch's spelling: torch.zeros(4096, 4096)
            shape_node = ast.Tuple(elts=list(n.value.args), ctx=ast.Load())
        for kw in n.value.keywords:
            if kw.arg in ("shape", "size"):
                shape_node = kw.value
        elems = _literal_elems(shape_node)
        if elems is not None:
            out[n.targets[0].id] = elems
    return out


@rule("host-materialize-large", "ast",
      "asnumpy()/device_get() of a statically-large tensor inside a "
      "loop body: each iteration synchronously copies the whole "
      "buffer to host -- many MB per step of D2H traffic stalling the "
      "dispatch pipeline.  Materialize once outside the loop, or "
      "reduce on device first (x.sum().asnumpy() ships 4 bytes).")
def _lint_host_materialize_large(tree, path, ctx):
    threshold = THRESHOLDS["host_materialize_elems"]
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        shapes = _static_shapes(scope)
        if not shapes:
            continue
        loops = _own_loops(scope) if not isinstance(scope, ast.Module) \
            else (n for n in scope.body if isinstance(n, (ast.For,
                                                          ast.While)))
        for loop in loops:
            for n in _loop_body_walk(loop):
                if not isinstance(n, ast.Call):
                    continue
                parts = _chain(n.func)
                if not parts or parts[-1] not in _MATERIALIZE_LEAVES:
                    continue
                if parts[-1] != "device_get":
                    src = n.func.value \
                        if isinstance(n.func, ast.Attribute) else None
                else:
                    src = n.args[0] if n.args else None
                if not isinstance(src, ast.Name):
                    continue
                elems = shapes.get(src.id)
                if elems is None or elems <= threshold:
                    continue
                yield Diagnostic(
                    "host-materialize-large",
                    "%s of %r (%s elements, statically known) inside "
                    "a loop body: a full synchronous D2H copy per "
                    "iteration.  Did you mean to materialize once "
                    "outside the loop, or reduce on device first?"
                    % (parts[-1], src.id, "{:,}".format(elems)),
                    file=path, line=n.lineno)


# ----------------------------------------------------------------------
# retained-temp-across-step
# ----------------------------------------------------------------------

def _jit_assign_calls(tree) -> Dict[str, ast.Call]:
    """Name -> the jax.jit(...) call it is bound to, anywhere in the
    file (``step = jax.jit(body, ...)``)."""
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name) and \
                isinstance(n.value, ast.Call) and _is_jit_call(n.value):
            out[n.targets[0].id] = n.value
    return out


@rule("retained-temp-across-step", "ast",
      "A jit output bound to self.X inside a training loop with "
      "neither donation on the jit nor an explicit delete: the "
      "PREVIOUS step's output buffer stays live while the next "
      "dispatch allocates a new one -- steady-state device memory "
      "carries two copies of the state.  Donate the state argnums "
      "(donate_argnums=...) or `del self.X` before the call.")
def _lint_retained_temp_across_step(tree, path, ctx):
    jits = _jit_assign_calls(tree)
    if not jits:
        return
    # each loop is judged exactly once, under its INNERMOST enclosing
    # function -- that is where donation evidence for the jit lives
    loop_scopes = {}

    def _map(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.For, ast.While)):
                loop_scopes[child] = fn
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            _map(child, inner)

    _map(tree, None)
    for loop, enclosing in loop_scopes.items():
        if not _is_train_loop(loop):
            continue
        # `del self.X` / `self.X = None` inside the loop releases
        # the previous buffer before the next dispatch
        released = set()
        for n in _loop_body_walk(loop):
            if isinstance(n, ast.Delete):
                for t in n.targets:
                    if isinstance(t, ast.Attribute):
                        released.add(t.attr)
            if isinstance(n, ast.Assign) and \
                    isinstance(n.value, ast.Constant) and \
                    n.value.value is None:
                for tgt in n.targets:
                    if isinstance(tgt, ast.Attribute):
                        released.add(tgt.attr)
        for n in _loop_body_walk(loop):
            if not (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)):
                continue
            fname = _call_name(n.value)
            jit_call = jits.get(fname)
            if jit_call is None:
                continue
            if _has_donation(jit_call, enclosing):
                continue
            for tgt in n.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self" and \
                        tgt.attr not in released:
                    yield Diagnostic(
                        "retained-temp-across-step",
                        "jit output of %r bound to self.%s in a "
                        "training loop without donation or an "
                        "explicit delete: the previous step's "
                        "buffer stays live through the next "
                        "dispatch.  Did you mean donate_argnums= "
                        "on the jit, or `del self.%s` before the "
                        "call?" % (fname, tgt.attr, tgt.attr),
                        file=path, line=n.lineno)


# ----------------------------------------------------------------------
# feed-depth-unbounded
# ----------------------------------------------------------------------

_FEED_NAME_RE = re.compile(r"feed|queue|stag|prefetch|pin|inflight",
                           re.I)


def _unbounded_queue_ctor(call: ast.Call) -> Optional[str]:
    """``'deque'``/``'Queue'`` when the constructor has no depth bound,
    None otherwise."""
    parts = _chain(call.func)
    if not parts:
        return None
    leaf = parts[-1]
    if leaf == "deque":
        if len(call.args) >= 2:
            return None                      # deque(iterable, maxlen)
        for kw in call.keywords:
            if kw.arg == "maxlen" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None):
                return None
        return "deque"
    if leaf in ("Queue", "LifoQueue", "SimpleQueue"):
        if leaf == "SimpleQueue":
            return "SimpleQueue"             # never bounded
        bound = None
        if call.args:
            bound = call.args[0]
        for kw in call.keywords:
            if kw.arg == "maxsize":
                bound = kw.value
        if bound is None or (isinstance(bound, ast.Constant)
                             and bound.value in (0, None)):
            return leaf
        return None
    return None


def _depth_bound_evidence(tree, name) -> bool:
    """A ``len(q)`` comparison anywhere in the file bounds the queue as
    surely as a ctor maxlen -- the shed-on-full pattern
    (``if len(self._queue) >= self.max_queue: raise``)."""
    def _is_target(x):
        return (isinstance(x, ast.Name) and x.id == name) or \
            (isinstance(x, ast.Attribute) and x.attr == name)
    for n in ast.walk(tree):
        if not isinstance(n, ast.Compare):
            continue
        for side in [n.left] + list(n.comparators):
            if isinstance(side, ast.Call) and \
                    _call_name(side) == "len" and side.args and \
                    _is_target(side.args[0]):
                return True
    return False


def _stages_device_arrays(scope, target) -> bool:
    """Does ``scope`` put device-producing values into ``target``
    (``q.put(device_put(batch))``, ``feed.append(nd.array(...))``)?"""
    for n in ast.walk(scope):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("put", "put_nowait", "append",
                                    "appendleft")
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == target and n.args):
            continue
        for a in ast.walk(n.args[0]):
            if isinstance(a, ast.Call):
                parts = _chain(a.func)
                if parts and (parts[0] in _DEVICE_ROOTS
                              or parts[-1] in ("device_put", "cuda")):
                    return True
    return False


@rule("feed-depth-unbounded", "ast",
      "A queue/deque staging device arrays constructed without a "
      "maxlen/maxsize depth bound: a producer that outruns the "
      "consumer stages unbounded device batches -- HBM grows with the "
      "producer lead instead of the double-buffering depth.  Bound it "
      "(deque(maxlen=N) / Queue(maxsize=N), cf. "
      "MXNET_TPU_FEED_DEPTH).")
def _lint_feed_depth_unbounded(tree, path, ctx):
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef))]
    seen = set()
    for scope in scopes:
        body = scope.body
        for node in body if isinstance(scope, ast.ClassDef) else \
                ast.walk(scope):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)):
                continue
            kind = _unbounded_queue_ctor(node.value)
            if kind is None or node.lineno in seen:
                continue
            tgt = node.targets[0]
            name = tgt.id if isinstance(tgt, ast.Name) else (
                tgt.attr if isinstance(tgt, ast.Attribute) else None)
            if name is None:
                continue
            staging = bool(_FEED_NAME_RE.search(name)) or \
                _stages_device_arrays(scope, name)
            if not staging:
                continue
            if _depth_bound_evidence(tree, name):
                continue
            seen.add(node.lineno)
            yield Diagnostic(
                "feed-depth-unbounded",
                "%s %r stages device batches without a depth bound: "
                "a producer lead becomes unbounded staged HBM.  Did "
                "you mean %s (cf. MXNET_TPU_FEED_DEPTH's default of "
                "2 = double buffering)?"
                % (kind, name,
                   "deque(maxlen=N)" if kind == "deque"
                   else "Queue(maxsize=N)"),
                file=path, line=node.lineno)


# ======================================================================
# Walked layer: the peak-memory auditor of the CostReports
# ======================================================================

AUDIT_SCHEMA = "mxmemory.audit.v1"

THRESHOLDS = {
    # temp-share advisory fires when temp bytes exceed this multiple of
    # the argument bytes (rematerialization headroom)
    "temp_args_factor": 2.0,
    # alias-coverage advisory fires when in-place bytes cover less than
    # this share of the donatable (output-shaped) argument bytes
    "alias_cover_min": 0.5,
    # static host-materialize-large threshold (elements)
    "host_materialize_elems": 1 << 20,
}


def _memory_of(rep: Dict, audit: Optional[Dict]) -> Dict:
    """One walked step's memory as the JAX audit's plain ints."""
    mem = rep["memory"]
    return {
        "argument_bytes": int(mem["argument_bytes"]),
        "output_bytes": int(mem["output_bytes"]),
        "temp_bytes": int(mem["temp_bytes"]),
        "alias_bytes": int(mem["alias_bytes"]),
        "donatable_bytes": int((audit or {}).get("donatable_bytes",
                                                 mem["alias_bytes"])),
        "peak_hbm_bytes": int(mem["peak_hbm_bytes"]),
    }


def _dominant_category(rep: Dict) -> Optional[str]:
    """The category carrying the most bytes in the step -- what a
    rematerialization remedy should aim at."""
    cats = {c: v["bytes"] for c, v in rep["categories"].items()
            if v["bytes"]}
    return max(cats, key=lambda c: cats[c]) if cats else None


def _metrics_of(mem: Dict) -> Dict:
    args = mem["argument_bytes"] or 1
    donatable = mem["donatable_bytes"]
    return {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
        "temp_bytes": mem["temp_bytes"],
        "alias_bytes": mem["alias_bytes"],
        "donatable_bytes": donatable,
        "peak_hbm_bytes": mem["peak_hbm_bytes"],
        "temp_share": round(mem["temp_bytes"] / args, 4),
        "alias_coverage": round(min(mem["alias_bytes"], donatable)
                                / donatable, 4) if donatable else 1.0,
    }


def _advisories_for(label: str, metrics: Dict, dominant: Optional[str],
                    thresholds: Dict) -> List[Dict]:
    adv = []
    if metrics["argument_bytes"] and metrics["temp_bytes"] > \
            thresholds["temp_args_factor"] * metrics["argument_bytes"]:
        adv.append({
            "kind": "temp-share",
            "share": metrics["temp_share"],
            "dominant_category": dominant,
            "message": "%r's temporaries are %.1fx its argument bytes "
                       "(%s temp vs %s args; dominant category: %s): the "
                       "live intermediate set dominates peak device "
                       "memory -- recompute the %s region in backward "
                       "(activation checkpointing) or shrink its live "
                       "range"
                       % (label, metrics["temp_share"],
                          _fmt_bytes(metrics["temp_bytes"]),
                          _fmt_bytes(metrics["argument_bytes"]),
                          dominant or "<unknown>",
                          dominant or "dominant"),
        })
    donatable = metrics["donatable_bytes"]
    if donatable and metrics["alias_coverage"] < \
            thresholds["alias_cover_min"]:
        adv.append({
            "kind": "alias-coverage",
            "share": round(1.0 - metrics["alias_coverage"], 4),
            "dominant_category": dominant,
            "message": "%.0f%% of %r's donatable step-shaped argument "
                       "bytes (%s output-matching) are not written in "
                       "place: input AND output state stay live across "
                       "the step.  Update the state in place (copy_/"
                       "out=), as TrainStep does"
                       % (100 * (1.0 - metrics["alias_coverage"]),
                          label, _fmt_bytes(donatable)),
        })
    adv.sort(key=lambda a: -a["share"])
    return adv


def memory_audit(thresholds=None) -> Dict:
    """Audit every CostReport the profiling walk registered for device
    memory pressure.  Returns the ``mxmemory.audit.v1`` artifact.

    Repeated labels (two keys of one block) merge: byte totals sum,
    ``peak_hbm_bytes`` takes the max (peaks of distinct graphs do not
    add -- they are not live together by construction of the dispatch
    order)."""
    from ..profiling import store
    from .perf import _backend
    th = dict(THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    merged: Dict[str, Dict] = {}
    dominants: Dict[str, Optional[str]] = {}
    for _key, rep, audit in store.audited():
        mem = _memory_of(rep, audit)
        label = rep["label"]
        if label in merged:
            agg = merged[label]
            for k, v in mem.items():
                agg[k] = max(agg[k], v) if k == "peak_hbm_bytes" \
                    else agg[k] + v
        else:
            merged[label] = mem
            dominants[label] = _dominant_category(rep)
    execs = {}
    for label, mem in merged.items():
        metrics = _metrics_of(mem)
        execs[label] = {
            "metrics": metrics,
            "advisories": _advisories_for(label, metrics,
                                          dominants.get(label), th),
        }
    ranked = sorted(
        (dict(a, executable=label)
         for label, e in execs.items() for a in e["advisories"]),
        key=lambda a: -a["share"])
    return {
        "schema": AUDIT_SCHEMA,
        "backend": _backend(),
        "thresholds": th,
        "executables": execs,
        "advisories": ranked,
    }


def save_audit(path: str, audit=None) -> Dict:
    """Write the current memory audit as JSON (the artifact
    ``--memory-diff`` compares)."""
    audit = audit if audit is not None else memory_audit()
    with open(path, "w") as f:
        json.dump(audit, f, indent=1, sort_keys=True)
        f.write("\n")
    return audit


def load_audit(path: str) -> Dict:
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != AUDIT_SCHEMA:
        raise ValueError("%s is not a %s artifact (schema=%r)"
                         % (path, AUDIT_SCHEMA, data.get("schema")))
    return data


def diff_audit(baseline: Dict, current: Dict,
               tol: Optional[float] = None) -> List[Diagnostic]:
    """Memory drift of ``current`` vs the blessed ``baseline``:

    - a step label the baseline never blessed -> error (a new graph
      claims memory nothing gated);
    - an advisory KIND the baseline doesn't carry for that step ->
      error;
    - ``peak_hbm_bytes`` grown more than ``tol`` (relative; default
      ``MXNET_TPU_MEMORY_AUDIT_TOL`` = 0.02) -> error.

    Shrinkage (smaller peaks, fewer advisories, retired steps) passes
    silently -- re-bless with :func:`save_audit` after an intentional
    change."""
    tol = _env.get("MXNET_TPU_MEMORY_AUDIT_TOL") if tol is None else tol
    diags: List[Diagnostic] = []
    base_ex = baseline.get("executables", {})
    for label, cur in sorted(current.get("executables", {}).items()):
        base = base_ex.get(label)
        cm = cur.get("metrics", {})
        if base is None:
            diags.append(Diagnostic(
                "memory-drift",
                "unblessed executable %r audits at peak HBM %s; a new "
                "graph claims memory nothing gated -- bless via "
                "analysis.memory.save_audit or drop the registration"
                % (label, _fmt_bytes(cm.get("peak_hbm_bytes", 0))),
                node=label))
            continue
        blessed = {a["kind"] for a in base.get("advisories", [])}
        for a in cur.get("advisories", []):
            if a["kind"] not in blessed:
                diags.append(Diagnostic(
                    "memory-drift",
                    "executable %r gained unblessed %r advisory "
                    "(share %.1f%%): %s -- fix the regression or "
                    "re-bless via analysis.memory.save_audit"
                    % (label, a["kind"], 100 * a["share"],
                       a["message"]),
                    node=label))
        b = base.get("metrics", {}).get("peak_hbm_bytes", 0)
        c = cm.get("peak_hbm_bytes", 0)
        if b and c > b * (1.0 + tol):
            diags.append(Diagnostic(
                "memory-drift",
                "executable %r: peak HBM grew %s -> %s (+%.1f%%, "
                "tolerance %.1f%%); the step claims more memory than "
                "the baseline blesses" % (
                    label, _fmt_bytes(b), _fmt_bytes(c),
                    100.0 * (c - b) / b, 100.0 * tol),
                node=label))
    return diags


@rule("memory-drift", "compiled",
      "A walked step's peak device memory (or its advisory set: "
      "temp-share, alias-coverage) drifted past a blessed memory-audit "
      "artifact -- a named, gated memory regression.  Gate: "
      "--memory-diff.")
def _rule_memory_drift(baseline, current):
    return diff_audit(baseline, current)


# ----------------------------------------------------------------------
# hbm_plan: batch-bucket peak-memory extrapolation
# ----------------------------------------------------------------------

def _tensor_leaves(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensor_leaves(a)


def _with_batch(args, b0, b1):
    """``args`` with every tensor whose leading dimension is ``b0``
    grown (or cut) to ``b1`` rows, its rows taken in turn."""
    def grow(a):
        if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == b0:
            return a[torch.arange(b1, device=a.device) % b0]
        if isinstance(a, (list, tuple)):
            return type(a)(grow(x) for x in a)
        return a
    return [grow(a) for a in args]


def _measured_peak(fn, args) -> int:
    """The peak allocated bytes of a warm run of ``fn(*args)`` on the
    card: one run first, then the run measured after the peak's
    reset."""
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())


def hbm_plan(label, device_hbm_bytes=None, buckets=None, batch_size=None,
             fn=None, args=None, probe_factor=2, peaks=None) -> Dict:
    """Extrapolate peak device memory across batch buckets -- linear in
    the batch-carried bytes, constant in the parameters -- and answer
    "what is the largest bucket that fits ``device_hbm_bytes``".

    Two measured peaks anchor the line, given as ``peaks`` (``{batch:
    peak bytes}``, e.g. a bucket pool's warm-up peaks on the card) or
    measured here, on the card, by running ``fn(*args)`` (the JAX
    package's form): ``torch.cuda.max_memory_allocated`` over a warm
    run at the arguments' batch (``batch_size``, by default the most
    frequent leading dimension of the tensors in ``args``) and one at
    ``probe_factor`` times it.  Give ``peaks`` or ``fn``, not both.
    From ``peaks``, ``batch_size`` (default the smallest batch) and the
    next batch measured are taken, one batch giving a flat line.

    Returns the JAX package's keys: ``{"label", "batch_size",
    "const_bytes", "per_item_bytes", "measured", "buckets",
    "largest_fit_batch", "largest_fit_bucket", "device_hbm_bytes"}``;
    raises ``ValueError`` without peaks or a batch, and
    ``MXNetError`` for ``fn`` on tensors off the card."""
    if fn is not None:
        if peaks:
            raise MXNetError("hbm_plan: give peaks= or fn=, not both")
        leaves = list(_tensor_leaves(args or ()))
        if not any(t.is_cuda for t in leaves):
            raise MXNetError("hbm_plan: the peaks of fn= are the card's "
                             "allocator's; %r has no argument on a CUDA "
                             "device" % (label,))
        if batch_size is None:
            counts = {}
            for t in leaves:
                if t.dim():
                    counts[int(t.shape[0])] = counts.get(int(t.shape[0]),
                                                         0) + 1
            batch_size = max(counts, key=counts.get) if counts else None
        if not batch_size or not any(t.dim() and t.shape[0] == batch_size
                                     for t in leaves):
            raise ValueError("hbm_plan: no argument of %r carries batch "
                             "dim %r" % (label, batch_size))
        b0 = int(batch_size)
        b1 = max(1, b0 * int(probe_factor))
        if b1 == b0:
            b1 = b0 + 1
        peaks = {b0: _measured_peak(fn, args),
                 b1: _measured_peak(fn, _with_batch(args, b0, b1))}
    if not peaks:
        raise ValueError("hbm_plan: %r has no measured peaks (pass "
                         "peaks=, a warmed bucket pool's, or fn=/args= "
                         "on the card)" % (label,))
    batches = sorted(int(b) for b in peaks)
    b0 = int(batch_size) if batch_size else batches[0]
    b1 = next((b for b in batches if b != b0), b0)
    peak0, peak1 = int(peaks[b0]), int(peaks[b1])
    per_item = max(0.0, (peak1 - peak0) / float(b1 - b0)) \
        if b1 != b0 else 0.0
    const = max(0.0, peak0 - per_item * b0)
    plan = {"label": label, "batch_size": b0,
            "const_bytes": int(const), "per_item_bytes": int(per_item),
            "measured": {str(b0): peak0, str(b1): peak1},
            "device_hbm_bytes": device_hbm_bytes, "buckets": [],
            "largest_fit_batch": None, "largest_fit_bucket": None}
    if device_hbm_bytes and per_item > 0:
        plan["largest_fit_batch"] = int(
            (device_hbm_bytes - const) // per_item) \
            if device_hbm_bytes > const else 0
    for b in sorted(buckets or ()):
        pred = int(const + per_item * int(b))
        fits = (pred <= device_hbm_bytes) if device_hbm_bytes else None
        plan["buckets"].append({"batch": int(b),
                                "predicted_peak_hbm_bytes": pred,
                                "fits": fits})
        if fits:
            plan["largest_fit_bucket"] = int(b)
    return plan


def device_hbm_bytes() -> Optional[int]:
    """Device memory of the first card in bytes; None without CUDA (the
    CPU) -- callers skip the memory validation then."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


# ======================================================================
# Runtime layer: the live-memory leak sentinel
# ======================================================================

# THE flag the hot paths check: one module-attribute read when off.
_WATCH = os.environ.get("MXNET_TPU_MEMORY_WATCH", "0") != "0"

# sentinel state the /statusz row reads
_STATE = {"censuses": 0, "live_bytes": None, "live_arrays": None,
          "leaks": 0, "last_leak": None}

# the memory.leak chaos action pins tensors here: hidden from the code
# under test, visible to the census -- the sentinel, not the injector,
# must catch the growth
_PINNED: List[object] = []


def watch_enabled() -> bool:
    """Is the live-memory watch armed (``MXNET_TPU_MEMORY_WATCH``)?"""
    return _WATCH


def _set_watch(flag):
    """Test/scenario hook: flip the watch without re-importing."""
    global _WATCH
    prev = _WATCH
    _WATCH = bool(flag)
    return prev


def _census_device():
    """The card the census reads, or None on a host without one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def walk_buckets(device_type=None) -> Dict:
    """The live tensors (on ``device_type``, default every device),
    bucketed by shape/dtype: ``{"bytes_total", "arrays", "buckets":
    {key: {"count", "bytes"}}}``.  Each live tensor object counts its
    own elements (a view as well as its base)."""
    buckets: Dict[str, Dict] = {}
    total = count = 0
    seen = set()
    with warnings.catch_warnings():
        # isinstance() on every heap object touches deprecated module
        # attributes, whose access warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        if obj.is_meta:
            continue
        if device_type is not None and obj.device.type != device_type:
            continue
        ident = id(obj)
        if ident in seen:
            continue
        seen.add(ident)
        nbytes = obj.numel() * obj.element_size()
        key = "%s/%s" % (tuple(obj.shape), str(obj.dtype).replace(
            "torch.", ""))
        b = buckets.setdefault(key, {"count": 0, "bytes": 0})
        b["count"] += 1
        b["bytes"] += nbytes
        total += nbytes
        count += 1
    return {"bytes_total": total, "arrays": count, "buckets": buckets}


def live_census() -> Dict:
    """One census: ``{"bytes_total", "arrays", "buckets"}``.  On the
    card the allocator's allocated bytes and active blocks, with
    ``buckets`` None (walked only when a window flags); on the CPU the
    live tensors, bucketed.  Publishes the ``memory.live_bytes`` /
    ``memory.live_arrays`` gauges and the /statusz counters."""
    dev = _census_device()
    if dev is not None:
        stats = torch.cuda.memory_stats(dev)
        census = {"bytes_total": int(stats.get(
                      "allocated_bytes.all.current", 0)),
                  "arrays": int(stats.get("active.all.current", 0)),
                  "buckets": None}
    else:
        census = walk_buckets("cpu")
    total, count = census["bytes_total"], census["arrays"]
    _STATE["censuses"] += 1
    _STATE["live_bytes"] = total
    _STATE["live_arrays"] = count
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.memory_census(total, count)
    return census


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class LeakSentinel:
    """Live-bytes leak detection across goodput windows.

    ``step()`` once per training step; every ``window_steps`` the
    sentinel takes a census and judges the total against its EWMA
    baseline: a flag needs (a) a warm baseline (``min_baseline``
    windows), (b) live bytes beyond mean + ``mad_k`` deviations, AND
    (c) a monotonic growth streak of at least ``growth_windows``
    censuses -- a one-window allocation burst never flags, a steady
    leak always does.  ``note_publish()`` marks the window
    publish-guarded: a checkpoint snapshot legitimately spikes live
    bytes, so guarded windows neither judge nor teach the baseline.
    The rules and state are the JAX package's, window for window."""

    def __init__(self, window_steps=None, mad_k=None, ewma_alpha=0.3,
                 min_baseline=3, growth_windows=2,
                 min_growth_frac=0.02):
        self.window_steps = window_steps if window_steps is not None \
            else _env_int("MXNET_TPU_OBS_GOODPUT_WINDOW", 20)
        self.mad_k = mad_k if mad_k is not None \
            else _env_float("MXNET_TPU_OBS_GOODPUT_MAD_K", 4.0)
        self.ewma_alpha = ewma_alpha
        self.min_baseline = min_baseline
        self.growth_windows = growth_windows
        self.min_growth_frac = min_growth_frac
        self._steps = 0
        self._publishes = 0
        self._index = 0
        self._mean = 0.0
        self._dev = 0.0
        self._n = 0
        self._streak = 0
        self._prev = None          # previous census (bucket growth)
        self._walked = None        # buckets of the previous flag's walk
        self._last = None          # last window report (statusz/tests)

    def step(self):
        """One training-step tick; closes a window at the boundary."""
        self._steps += 1
        if self._steps >= self.window_steps:
            self.flush()

    def note_publish(self):
        """Mark this window publish-guarded (a checkpoint snapshot's
        live-bytes spike is expected work, not a leak)."""
        self._publishes += 1

    def flush(self) -> Optional[Dict]:
        """Close the current window now (the trainer's close() tail);
        returns the window report, or None on an empty window."""
        if not self._steps:
            return None
        steps, self._steps = self._steps, 0
        publishes, self._publishes = self._publishes, 0
        index = self._index
        self._index += 1
        census = live_census()
        x = float(census["bytes_total"])
        prev, self._prev = self._prev, census
        report = {"index": index, "steps": steps,
                  "publishes": publishes, "live_bytes": int(x),
                  "live_arrays": census["arrays"], "leak": None}
        if publishes:
            # publish guard: judge nothing, teach nothing
            self._last = report
            return report
        grew = prev is not None and x > prev["bytes_total"]
        self._streak = self._streak + 1 if grew else 0
        if self._n >= self.min_baseline:
            thresh = self._mean + self.mad_k * max(
                self._dev, 0.05 * self._mean, 1.0)
            moved = x - self._mean
            if x > thresh and self._streak >= self.growth_windows \
                    and moved >= self.min_growth_frac * max(
                        self._mean, 1.0):
                bucket, growth = self._top_growing(prev, census)
                report["leak"] = {
                    "live_bytes": int(x),
                    "baseline_bytes": int(self._mean),
                    "growth_bytes": int(growth),
                    "bucket": bucket,
                    "streak": self._streak,
                }
                _STATE["leaks"] += 1
                _STATE["last_leak"] = dict(report["leak"],
                                           window=index)
                from .. import telemetry as _telemetry
                if _telemetry._ENABLED:
                    _telemetry.hooks.memory_leak(
                        bucket, int(growth), int(x), index)
        # EWMA update (mean + absolute-deviation MAD analog); flagged
        # windows update too -- a sustained shift becomes the new
        # normal instead of alerting forever (the goodput contract)
        if self._n == 0:
            self._mean, self._dev, self._n = x, 0.0, 1
        else:
            a = self.ewma_alpha
            self._dev = (1 - a) * self._dev + a * abs(x - self._mean)
            self._mean = (1 - a) * self._mean + a * x
            self._n += 1
        self._last = report
        return report

    def _top_growing(self, prev, census):
        """The shape bucket that grew the most vs the previous census
        -- what the leak report NAMES.  A census without buckets (the
        card's) walks the live tensors now, and diffs against the
        previous flag's walk (none at the first flag: the largest
        bucket)."""
        if census["buckets"] is None:
            dev = _census_device()
            walked = walk_buckets(dev.type if dev is not None else None)
            buckets = walked["buckets"]
            prev_buckets, self._walked = self._walked or {}, buckets
        else:
            buckets = census["buckets"]
            prev_buckets = (prev or {}).get("buckets") or {}
        best, best_growth = None, 0
        for key, b in buckets.items():
            growth = b["bytes"] - prev_buckets.get(
                key, {"bytes": 0})["bytes"]
            if growth > best_growth:
                best, best_growth = key, growth
        return best or "<none>", best_growth

    def last(self) -> Optional[Dict]:
        return self._last

    def baseline(self) -> Dict:
        """EWMA state (tests)."""
        return {"mean": self._mean, "dev": self._dev, "n": self._n}


_SENTINEL: Optional[LeakSentinel] = None


def sentinel(**kwargs) -> LeakSentinel:
    """Get-or-create the process LeakSentinel (what ContinuousTrainer
    ticks when ``MXNET_TPU_MEMORY_WATCH=1``)."""
    global _SENTINEL
    if _SENTINEL is None:
        _SENTINEL = LeakSentinel(**kwargs)
    return _SENTINEL


def reset_watch():
    """Drop the sentinel, pins, and /statusz counters (tests)."""
    global _SENTINEL
    _SENTINEL = None
    _PINNED.clear()
    _STATE.update({"censuses": 0, "live_bytes": None,
                   "live_arrays": None, "leaks": 0, "last_leak": None})


# -- chaos integration -------------------------------------------------

def pin_action(ctx):
    """The ``memory.leak`` chaos action: allocate a tensor (on the card
    when there is one in use, else on the host) and pin it in a hidden
    module list, so live bytes grow monotonically and the SENTINEL (not
    the injector) must catch the leak.  Arm with::

        chaos.on("memory.leak", memory.pin_action)

    ``ctx`` may carry ``nbytes`` (default 1 MiB per fire)."""
    nbytes = int(ctx.get("nbytes", 1 << 20))
    dev = _census_device()
    _PINNED.append(torch.zeros((max(1, nbytes // 4),), dtype=torch.float32,
                               device=dev if dev is not None else "cpu"))


def pinned_count() -> int:
    return len(_PINNED)


def unpin_all() -> int:
    """Release every chaos-pinned tensor; returns how many."""
    n = len(_PINNED)
    _PINNED.clear()
    return n


def status_row() -> Dict:
    """The ``/statusz`` memory row: watch arm state, censuses run,
    latest live totals, leaks flagged, and the last leak's
    attribution."""
    return {"armed": _WATCH, "censuses": _STATE["censuses"],
            "live_bytes": _STATE["live_bytes"],
            "live_arrays": _STATE["live_arrays"],
            "leaks": _STATE["leaks"], "last_leak": _STATE["last_leak"],
            "pinned": len(_PINNED)}
