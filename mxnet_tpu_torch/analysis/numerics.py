"""mxnumerics: the precision-flow sanitizer (counterpart of
``mxnet_tpu/analysis/numerics.py``): static rules, the precision audit
of the walked steps, and the runtime non-finite sentinel.

**Static layer** (AST; runs in ``python -m mxnet_tpu_torch.analysis
--self``): the JAX package's five rules with its ids and findings on the
same source, and torch's spellings besides (``x.to(torch.bfloat16)``,
``x.half()``, ``x.bfloat16()``, ``x.float()``):

- ``bf16-sensitive-reduce``: a sum/mean/var/std/norm/softmax reduction
  over a half-precision value inside a captured scope with no fp32
  accumulation -- bf16 carries ~8 mantissa bits, so a long reduction
  loses everything below 1/256 of the running sum.
- ``unscaled-half-loss``: a half-precision loss fed to ``backward()``
  with no LossScaler / ``amp.scale_loss`` in the dataflow -- fp16
  gradients underflow to zero without scaling (bf16 shares fp32's
  exponent range; fp16 does not).
- ``half-optimizer-state``: optimizer state / EMA buffers created in
  fp16/bf16 -- momentum and variance accumulate tiny deltas that a
  half-precision store absorbs; state must be fp32.
- ``implicit-downcast``: an fp32 value or small Python-float constant
  silently narrowed by mixed-dtype promotion landing in half precision
  (a Python scalar with a bf16 tensor stays bf16, so ``x + 1e-8`` is
  ``x`` exactly in bf16).
- ``nonfinite-guard-missing``: ``log``/``rsqrt``/``reciprocal`` on an
  unbounded input with no eps/clip guard in the same expression.

**Walked layer**: :func:`numerics_audit` reads the counters the
profiling walk stored beside each CostReport (``profiling.aten.Walk``):
the bytes of dtype casts (``_to_copy``) with their ops, the matrix
products (``mm``/``bmm``/``addmm``/convolutions) that may accumulate in
their half input type, and the reductions (``sum``/``mean``/``var``/
``norm``/softmax/pooling) whose every float operand and result is half.
A cuBLAS bf16/fp16 GEMM accumulates in fp32 unless PyTorch's
reduced-precision reduction flag for that type is on; a cuDNN
convolution accumulates in fp32.  A hand kernel counts by the type it
accumulates in, recorded beside its cost function
(``kernels/costs.py :: KERNEL_NUMERICS``: all in fp32).  The artifact
is the JAX package's (schema ``mxnumerics.audit.v1``), gated by
``save_audit``/``diff_audit`` and ``--numerics-diff`` (rule
``numerics-drift``).

**Runtime layer**: the non-finite sentinel.  Behind
``MXNET_TPU_NUMERICS_CHECK=1`` (read once at import; tests flip it
with :func:`_set_check`), ``TrainStep`` reads the finite flag its step
already computes, once after the step.  On the first non-finite step it
recomputes that step's gradients eagerly, from the weights the step kept
(a non-finite step keeps the pre-step weights and states) on the same
batch with the random state of the step, names the first offender
(:func:`attribute_nonfinite`, NaN before Inf) and raises
:class:`NonFiniteError`.  Disarmed, the default, the step makes no host
read for it.

The eager twins serve code outside ``TrainStep``:
:func:`finite_all` (and :func:`finite_tree` on tensors) is one finite
check over a set of arrays, a 0-d bool on their device, with no host
read (the fp16 loss scaler's overflow check, ``TrainStep``'s finite
select); :func:`finite_sentinel` checks named arrays when the sentinel
is armed, with one host read, and raises :class:`NonFiniteError`
naming the first offender.  Where the JAX functions flatten each dtype
group into one buffer for XLA to fuse, these reduce each array where it
lies and combine the flags: the same answer without a copy of every
gradient.

The ``numerics.nonfinite`` chaos point (armed with
:func:`poison_action`) lets a test or a chaos run poison one batch with
:func:`poison_nd`, so the fault flows through forward and backward and
the sentinel, not the injector, must catch it; ``TrainStep`` and the
continuous trainer visit it once a step.  Checks and detections count
under the JAX package's ``numerics.*`` telemetry instruments, and
:func:`status_row` is the ``/statusz`` row.
"""
from __future__ import annotations

import ast
import json
import re as _re
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import env
from ..bucketing import dtype_groups
from ._ast_util import (_file_defs_and_assigns, _is_jit_call,
                        _resolve_body)
from .core import Diagnostic, rule
from .trace_lint import _traced_scopes

__all__ = [
    "AUDIT_SCHEMA", "THRESHOLDS",
    "numerics_audit", "save_audit", "load_audit", "diff_audit",
    "NonFiniteError", "check_enabled", "finite_tree", "finite_all",
    "finite_sentinel", "attribute_nonfinite", "note_check", "poison_nd",
    "poison_action", "record_nonfinite", "status_row",
]

# ----------------------------------------------------------------------
# dtype spelling helpers (shared by all five static rules)
# ----------------------------------------------------------------------

_HALF_NAMES = {"float16", "bfloat16", "half"}
_F32_NAMES = {"float32", "single", "float64", "double"}


def _dtype_name(node) -> Optional[str]:
    """The dtype a literal/attribute spells: ``'bfloat16'``,
    ``np.float16``, ``jnp.bfloat16`` -> its name; None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_half_dtype(node) -> bool:
    return _dtype_name(node) in _HALF_NAMES


def _is_wide_dtype(node) -> bool:
    return _dtype_name(node) in _F32_NAMES


def _dtype_kw(call: ast.Call):
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


_CAST_METHODS = {"astype", "cast", "as_in_ctx", "as_type"}
# torch's spellings: x.to(torch.bfloat16), x.type(torch.float16), and
# the dtype-named conversion methods
_TORCH_CAST_METHODS = {"to", "type"}
_TORCH_HALF_METHODS = {"half", "bfloat16"}
_TORCH_WIDE_METHODS = {"float", "double"}


def _cast_target(expr) -> Optional[str]:
    """``'half'``/``'wide'`` when ``expr`` is an explicit dtype cast
    (``x.astype(bf16)``, ``F.cast(x, dtype='float16')``, and torch's
    ``x.to(torch.bfloat16)``, ``x.half()``, ``x.float()``); else
    None."""
    if not isinstance(expr, ast.Call):
        return None
    f = expr.func
    cand = None
    if isinstance(f, ast.Attribute) and not expr.args \
            and not expr.keywords:
        if f.attr in _TORCH_HALF_METHODS:
            return "half"
        if f.attr in _TORCH_WIDE_METHODS:
            return "wide"
    if isinstance(f, ast.Attribute) and f.attr in (
            ("astype", "cast") + tuple(_TORCH_CAST_METHODS)) \
            and expr.args:
        cand = expr.args[0]
    dk = _dtype_kw(expr)
    if dk is not None:
        cand = dk
    if cand is None:
        return None
    if _is_half_dtype(cand):
        return "half"
    if _is_wide_dtype(cand):
        return "wide"
    return None


def _expr_half(expr, tainted) -> bool:
    """Conservatively: does ``expr`` produce a half-precision value?

    Half flows from explicit half casts / ``dtype=`` kwargs and from
    names in ``tainted``; an explicit fp32 cast cleanses.  Mixed binops
    follow the promotion of JAX and of torch alike: half op f32 widens,
    half op a Python scalar stays half."""
    if expr is None:
        return False
    cast = _cast_target(expr)
    if cast == "half":
        return True
    if cast == "wide":
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        return _expr_half(expr.value, tainted)
    if isinstance(expr, ast.BinOp):
        lh = _expr_half(expr.left, tainted)
        rh = _expr_half(expr.right, tainted)
        lw = isinstance(expr.left, ast.Constant)
        rw = isinstance(expr.right, ast.Constant)
        return (lh and (rh or rw)) or (rh and lw)
    if isinstance(expr, ast.UnaryOp):
        return _expr_half(expr.operand, tainted)
    if isinstance(expr, ast.Call):
        # dtype-preserving op/method call: half in -> half out
        if isinstance(expr.func, ast.Attribute) and \
                _expr_half(expr.func.value, tainted):
            return True
        return any(_expr_half(a, tainted) for a in expr.args)
    if isinstance(expr, (ast.Subscript, ast.Starred)):
        return _expr_half(expr.value, tainted)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_expr_half(e, tainted) for e in expr.elts)
    return False


def _expr_wide(expr, tainted32) -> bool:
    """Does ``expr`` produce a deliberately-fp32 value (an explicit
    upcast or a name carrying one)?"""
    if expr is None:
        return False
    cast = _cast_target(expr)
    if cast == "wide":
        return True
    if cast == "half":
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted32
    if isinstance(expr, ast.Attribute):
        return _expr_wide(expr.value, tainted32)
    if isinstance(expr, ast.BinOp):
        return _expr_wide(expr.left, tainted32) or \
            _expr_wide(expr.right, tainted32)
    if isinstance(expr, ast.UnaryOp):
        return _expr_wide(expr.operand, tainted32)
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute) and \
                _expr_wide(expr.func.value, tainted32):
            return True
        return any(_expr_wide(a, tainted32) for a in expr.args)
    return False


def _assign_targets(node) -> List[str]:
    out = []
    targets = node.targets if isinstance(node, ast.Assign) \
        else [node.target]
    for tgt in targets:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


def _scope_taints(fn) -> Tuple[set, set]:
    """(half_tainted, f32_tainted) name sets of one function scope,
    propagated through assignments in source order (two passes to
    catch forward-flowing reuse)."""
    assigns = [n for n in ast.walk(fn)
               if isinstance(n, (ast.Assign, ast.AugAssign))]
    assigns.sort(key=lambda n: n.lineno)
    half, wide = set(), set()
    for _ in range(2):
        for node in assigns:
            value = node.value
            names = _assign_targets(node)
            if _expr_half(value, half):
                half.update(names)
                wide.difference_update(names)
            elif _expr_wide(value, wide):
                wide.update(names)
                half.difference_update(names)
    return half, wide


def _jitted_fn_nodes(tree):
    """Function defs passed to ``jax.jit`` (the perflint resolver)."""
    defs, assigns = _file_defs_and_assigns(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_jit_call(node) and node.args:
            body = _resolve_body(node.args[0], defs, assigns)
            if body is not None and body[2] is not None:
                out.append(body[2])
    return out


def _traced_and_jitted_scopes(tree):
    scopes = list(_traced_scopes(tree))
    seen = {id(s) for s in scopes}
    for fn in _jitted_fn_nodes(tree):
        if id(fn) not in seen:
            seen.add(id(fn))
            scopes.append(fn)
    return scopes


def _leaf_name(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


# ----------------------------------------------------------------------
# bf16-sensitive-reduce
# ----------------------------------------------------------------------

# dtype-sensitive reductions: long accumulation chains where bf16's 8
# mantissa bits lose everything below 1/256 of the running sum
_REDUCE_NAMES = {"sum", "mean", "prod", "var", "std", "norm",
                 "softmax", "log_softmax", "logsumexp", "cumsum"}


def _has_f32_accum(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "preferred_element_type":
            return True
        if kw.arg in ("dtype", "acc_dtype") and _is_wide_dtype(kw.value):
            return True
    return False


@rule("bf16-sensitive-reduce", "ast",
      "A sum/mean/var/std/norm/softmax reduction over a half-precision "
      "value inside a captured scope with no fp32 accumulation: bf16 "
      "carries ~8 mantissa bits, so the running sum silently absorbs "
      "every addend below 1/256 of its magnitude.  Upcast first "
      "(x.astype('float32')) or pass preferred_element_type.")
def _lint_bf16_reduce(tree, path, ctx):
    for fn in _traced_and_jitted_scopes(tree):
        half, _wide = _scope_taints(fn)
        if not half:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _leaf_name(node.func)
            if name not in _REDUCE_NAMES or _has_f32_accum(node):
                continue
            # method form x.sum(): the receiver carries the dtype;
            # func form F.sum(x): the first tensor arg does
            if isinstance(node.func, ast.Attribute) and \
                    not isinstance(node.func.value, ast.Name):
                src = node.func.value
                hot = _expr_half(src, half)
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in half:
                hot = True
            else:
                hot = any(_expr_half(a, half) for a in node.args)
            if not hot:
                continue
            yield Diagnostic(
                "bf16-sensitive-reduce",
                "%s() reduces a half-precision value in traced scope "
                "%r without fp32 accumulation; bf16/fp16 running sums "
                "absorb addends below ~1/256 of their magnitude.  Did "
                "you mean x.astype('float32').%s(...) (x.float() in "
                "torch) or an fp32 dtype= on the reduction?"
                % (name, fn.name, name),
                file=path, line=node.lineno)


# ----------------------------------------------------------------------
# unscaled-half-loss
# ----------------------------------------------------------------------

# any of these names in the enclosing scope marks the loss as scaled /
# scaling-aware (LossScaler instance, amp.scale_loss, trainer AMP init)
_SCALE_MARKERS = {"LossScaler", "scale_loss", "loss_scale", "amp",
                  "loss_scaler", "unscale", "init_trainer"}


def _scope_mentions_scaling(fn) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and n.id in _SCALE_MARKERS:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _SCALE_MARKERS:
            return True
    return False


@rule("unscaled-half-loss", "ast",
      "A half-precision loss fed to backward() with no LossScaler/"
      "amp.scale_loss in the dataflow: fp16 gradients underflow to "
      "zero unscaled (bf16 shares fp32's exponent range; fp16 does "
      "not).  Wrap with amp.scale_loss(loss, trainer) or a LossScaler.")
def _lint_unscaled_half_loss(tree, path, ctx):
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        half, _wide = _scope_taints(fn)
        if not half or _scope_mentions_scaling(fn):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hot = False
            if isinstance(f, ast.Attribute) and f.attr == "backward" \
                    and _expr_half(f.value, half):
                hot = True          # loss.backward()
            elif _leaf_name(f) == "backward" and \
                    any(_expr_half(a, half) for a in node.args):
                hot = True          # autograd.backward(loss)
            if not hot:
                continue
            yield Diagnostic(
                "unscaled-half-loss",
                "backward() on a half-precision loss in %r with no "
                "loss scaling in scope; fp16 grads underflow unscaled. "
                " Did you mean amp.scale_loss(loss, trainer).backward()"
                " or a LossScaler?" % fn.name,
                file=path, line=node.lineno)


# ----------------------------------------------------------------------
# half-optimizer-state
# ----------------------------------------------------------------------

_ARRAY_CREATORS = {"zeros", "ones", "full", "empty", "zeros_like",
                   "ones_like", "full_like", "array"}
_STATE_FN_RE = _re.compile(r"create_state|_state$", _re.I)
_STATE_NAME_RE = _re.compile(
    r"(mom(entum)?|var(iance)?|mean|ema|avg|state|vhat|mhat|velocity|"
    r"accum)", _re.I)


@rule("half-optimizer-state", "ast",
      "Optimizer state / EMA buffer created in fp16/bf16: momentum and "
      "variance accumulate per-step deltas ~1/1000 of their magnitude, "
      "which a half-precision store absorbs entirely.  Keep state fp32 "
      "(the master-weights discipline) and cast at apply time.")
def _lint_half_optimizer_state(tree, path, ctx):
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        in_state_fn = bool(_STATE_FN_RE.search(fn.name))
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.Return)):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)
                    and _leaf_name(value.func) in _ARRAY_CREATORS):
                continue
            dk = _dtype_kw(value)
            if dk is None or not _is_half_dtype(dk):
                continue
            if isinstance(node, ast.Return):
                statey = in_state_fn
            else:
                names = _assign_targets(node)
                attrs = [t.attr for tgt in (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target])
                    for t in ast.walk(tgt) if isinstance(t, ast.Attribute)]
                statey = in_state_fn or any(
                    _STATE_NAME_RE.search(nm) for nm in names + attrs)
            if not statey:
                continue
            yield Diagnostic(
                "half-optimizer-state",
                "%s(dtype=%s) creates optimizer state in half "
                "precision in %r; per-step deltas underflow the store. "
                " Did you mean dtype='float32' (cast at apply time)?"
                % (_leaf_name(value.func), _dtype_name(dk), fn.name),
                file=path, line=value.lineno)


# ----------------------------------------------------------------------
# implicit-downcast
# ----------------------------------------------------------------------

# bf16 resolves ~2^-8 relative; a Python float below this absolute
# threshold next to O(1) half activations is at absorption risk
_WEAK_CONST_MAX = 2.0 ** -8


@rule("implicit-downcast", "ast",
      "An fp32 value or small Python-float constant narrowed by "
      "mixed-dtype promotion landing in half precision: a weak-typed "
      "scalar with a bf16 array stays bf16 (x + 1e-8 is exactly x), "
      "and .astype(half) on a deliberate fp32 upcast throws the "
      "precision away.  Materialize constants at fp32 and keep the "
      "compute wide until the final cast.")
def _lint_implicit_downcast(tree, path, ctx):
    for fn in _traced_and_jitted_scopes(tree):
        half, wide = _scope_taints(fn)
        for node in ast.walk(fn):
            # form (a): tiny weak float absorbed by a half operand
            if isinstance(node, ast.BinOp) and \
                    isinstance(node.op, (ast.Add, ast.Sub)) and half:
                for c, other in ((node.left, node.right),
                                 (node.right, node.left)):
                    if not (isinstance(c, ast.Constant)
                            and isinstance(c.value, float)):
                        continue
                    if not (0.0 < abs(c.value) < _WEAK_CONST_MAX):
                        continue
                    if _expr_half(other, half):
                        yield Diagnostic(
                            "implicit-downcast",
                            "python float %g with a half-precision "
                            "operand in traced scope %r is weak-typed: "
                            "promotion lands bf16/fp16 and the "
                            "constant is absorbed (bf16 resolves "
                            "~2^-8).  Did you mean to upcast first "
                            "(x.astype('float32') + %g)?"
                            % (c.value, fn.name, c.value),
                            file=path, line=node.lineno)
            # form (b): a deliberate fp32 value cast back down to half
            if isinstance(node, ast.Call) and wide:
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "astype" \
                        and node.args and _is_half_dtype(node.args[0]) \
                        and _expr_wide(f.value, wide):
                    yield Diagnostic(
                        "implicit-downcast",
                        ".astype(%r) narrows a deliberate fp32 value "
                        "back to half precision in traced scope %r; "
                        "keep the accumulation wide until the final "
                        "output cast" % (_dtype_name(node.args[0]),
                                         fn.name),
                        file=path, line=node.lineno)


# ----------------------------------------------------------------------
# nonfinite-guard-missing
# ----------------------------------------------------------------------

_NONFINITE_FNS = {"log", "log2", "log10", "rsqrt", "reciprocal"}
_GUARD_CALLS = {"maximum", "clip", "clamp", "abs", "exp", "softmax",
                "sigmoid", "softplus", "square", "relu", "where",
                "clamp_min"}
_EPS_NAME_RE = _re.compile(r"eps|epsilon|delta|tiny", _re.I)


def _arg_guarded(expr) -> bool:
    """Is the argument expression bounded away from the pole -- an eps
    addition, a clip/maximum/abs/exp wrap, or a literal?"""
    if isinstance(expr, ast.Constant):
        return True
    for n in ast.walk(expr):
        if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Add,
                                                          ast.Sub)):
            for side in (n.left, n.right):
                if isinstance(side, ast.Constant) and \
                        isinstance(side.value, (int, float)) and \
                        side.value != 0:
                    return True
                if isinstance(side, ast.Name) and \
                        _EPS_NAME_RE.search(side.id):
                    return True
                if isinstance(side, ast.Attribute) and \
                        _EPS_NAME_RE.search(side.attr):
                    return True
        if isinstance(n, ast.Call) and _leaf_name(n.func) in _GUARD_CALLS:
            return True
        if isinstance(n, ast.Name) and _EPS_NAME_RE.search(n.id):
            return True
    return False


@rule("nonfinite-guard-missing", "ast",
      "log/rsqrt/reciprocal on an unbounded input inside a captured "
      "scope with no eps/clip guard in the expression: the first NaN "
      "factory every divergence postmortem finds.  Guard the argument "
      "(log(x + eps), rsqrt(var + eps), clip/maximum first).")
def _lint_nonfinite_guard(tree, path, ctx):
    for fn in _traced_and_jitted_scopes(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _leaf_name(node.func)
            if name not in _NONFINITE_FNS or not node.args:
                continue
            if any(kw.arg is not None and _EPS_NAME_RE.search(kw.arg)
                   for kw in node.keywords):
                continue
            if _arg_guarded(node.args[0]):
                continue
            yield Diagnostic(
                "nonfinite-guard-missing",
                "%s() on an unguarded input in traced scope %r can go "
                "non-finite at the pole.  Did you mean %s(x + eps) or "
                "a maximum/clip guard?" % (name, fn.name, name),
                file=path, line=node.lineno)


# ======================================================================
# Walked layer: the precision auditor of the CostReports
# ======================================================================

AUDIT_SCHEMA = "mxnumerics.audit.v1"

# convert-storm fires when cast bytes reach this share of the step's
# byte traffic; the product/reduce advisories fire on presence (their
# share metrics gate growth via diff_audit)
THRESHOLDS = {
    "convert_share": 0.15,
}

_COUNTER_KEYS = ("convert_bytes", "half_dot_bytes", "mxu_bytes",
                 "half_reduce_bytes", "reduce_bytes")
_COUNTER_MAPS = ("convert_ops", "half_dots", "half_reduces")


def _counters_of(rep: Dict, audit: Optional[Dict]) -> Dict:
    a = audit or {}
    out = {"bytes_total": int(rep["totals"]["bytes_accessed"])}
    for k in _COUNTER_KEYS:
        out[k] = int(a.get(k, 0))
    for k in _COUNTER_MAPS:
        out[k] = dict(a.get(k, {}))
    return out


def _merge_counters(agg: Dict, cur: Dict):
    for k, v in cur.items():
        if isinstance(v, dict):
            slot = agg.setdefault(k, {})
            for nm, b in v.items():
                slot[nm] = slot.get(nm, 0) + b
        else:
            agg[k] = agg.get(k, 0) + v


def _metrics_of(counters: Dict) -> Dict:
    total = counters["bytes_total"] or 1
    mxu = counters["mxu_bytes"] or 1
    red = counters["reduce_bytes"] or 1
    return {
        "convert_share": round(counters["convert_bytes"] / total, 4),
        "half_accum_dot_share": round(
            counters["half_dot_bytes"] / mxu, 4),
        "half_reduce_share": round(
            counters["half_reduce_bytes"] / red, 4),
        "bytes_total": counters["bytes_total"],
    }


def _top(d: Dict, n=3) -> List[str]:
    return [nm for nm, _b in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _advisories_for(label: str, metrics: Dict, counters: Dict,
                    thresholds: Dict) -> List[Dict]:
    adv = []
    if metrics["half_accum_dot_share"] > 0:
        names = _top(counters["half_dots"])
        adv.append({
            "kind": "half-accum-dot",
            "share": metrics["half_accum_dot_share"],
            "op_names": names,
            "message": "%.0f%% of %r's product bytes are GEMMs that may "
                       "sum partial products in their half input type "
                       "(ops: %s); set torch.backends.cuda.matmul."
                       "allow_bf16_reduced_precision_reduction (or the "
                       "fp16 flag) to False so cuBLAS accumulates fp32"
                       % (100 * metrics["half_accum_dot_share"], label,
                          ", ".join(names) or "<unnamed>"),
        })
    if metrics["convert_share"] >= thresholds["convert_share"]:
        names = _top(counters["convert_ops"])
        adv.append({
            "kind": "convert-storm",
            "share": metrics["convert_share"],
            "op_names": names,
            "message": "%.0f%% of %r's memory traffic is dtype casts "
                       "(ops: %s) -- a mixed-precision boundary is "
                       "thrashing; align dtypes across the op chain or "
                       "move the cast outside the hot loop"
                       % (100 * metrics["convert_share"], label,
                          ", ".join(names) or "<unnamed>"),
        })
    if metrics["half_reduce_share"] > 0:
        names = _top(counters["half_reduces"])
        adv.append({
            "kind": "half-reduce",
            "share": metrics["half_reduce_share"],
            "op_names": names,
            "message": "%.0f%% of %r's reduction bytes read and write "
                       "only bf16/fp16 (ops: %s): each result is rounded "
                       "to half; upcast the reduction input to fp32 -- "
                       "the static bf16-sensitive-reduce rule names the "
                       "source sites"
                       % (100 * metrics["half_reduce_share"], label,
                          ", ".join(names) or "<unnamed>"),
        })
    adv.sort(key=lambda a: -a["share"])
    return adv


def numerics_audit(thresholds=None) -> Dict:
    """Audit every CostReport the profiling walk registered for
    precision hazards, merged per label as ``perf.perf_audit`` does.
    Returns the ``mxnumerics.audit.v1`` artifact."""
    from ..profiling import store
    from .perf import _backend
    th = dict(THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    merged: Dict[str, Dict] = {}
    for _key, rep, audit in store.audited():
        counters = _counters_of(rep, audit)
        if rep["label"] in merged:
            _merge_counters(merged[rep["label"]], counters)
        else:
            merged[rep["label"]] = counters
    execs = {}
    for label, counters in merged.items():
        metrics = _metrics_of(counters)
        execs[label] = {
            "metrics": metrics,
            "advisories": _advisories_for(label, metrics, counters, th),
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
    """Write the current numerics audit as JSON (the artifact
    ``--numerics-diff`` compares)."""
    audit = audit if audit is not None else numerics_audit()
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


# share metrics where GROWTH is a precision regression
_GROWTH_METRICS = ("convert_share", "half_accum_dot_share",
                   "half_reduce_share")


def diff_audit(baseline: Dict, current: Dict,
               tol: Optional[float] = None) -> List[Diagnostic]:
    """Precision drift of ``current`` vs the blessed ``baseline``:

    - an advisory KIND the baseline doesn't carry for that step (or a
      brand-new step auditing with advisories) -> error;
    - a share metric (convert / half-accum-dot / half-reduce) grown
      more than ``tol`` (absolute; default
      ``MXNET_TPU_NUMERICS_AUDIT_TOL`` = 0.02) -> error.

    Improvements (smaller shares, fewer advisories) pass silently --
    re-bless with :func:`save_audit` after an intentional change."""
    tol = env.get("MXNET_TPU_NUMERICS_AUDIT_TOL") if tol is None else tol
    diags: List[Diagnostic] = []
    base_ex = baseline.get("executables", {})
    for label, cur in sorted(current.get("executables", {}).items()):
        base = base_ex.get(label, {"metrics": {}, "advisories": []})
        blessed = {a["kind"] for a in base.get("advisories", [])}
        for a in cur.get("advisories", []):
            if a["kind"] not in blessed:
                diags.append(Diagnostic(
                    "numerics-drift",
                    "executable %r gained unblessed %r advisory "
                    "(precision share %.1f%%): %s -- fix the "
                    "regression or re-bless via analysis.numerics."
                    "save_audit" % (label, a["kind"], 100 * a["share"],
                                    a["message"]),
                    node=label))
        bm = base.get("metrics", {})
        cm = cur.get("metrics", {})
        for m in _GROWTH_METRICS:
            b, c = bm.get(m, 0.0), cm.get(m, 0.0)
            if c > b + tol:
                diags.append(Diagnostic(
                    "numerics-drift",
                    "executable %r: %s grew %.4f -> %.4f (tolerance "
                    "%.4f); the step lost precision headroom vs what "
                    "the baseline blesses" % (label, m, b, c, tol),
                    node=label))
    return diags


@rule("numerics-drift", "compiled",
      "A walked step's precision metrics (half-accumulated products, "
      "cast bytes, all-half reductions) drifted past a blessed "
      "numerics-audit artifact -- a named, gated precision regression.  "
      "Gate: --numerics-diff.")
def _rule_numerics_drift(baseline, current):
    return diff_audit(baseline, current)


# ======================================================================
# Runtime layer: the non-finite sentinel
# ======================================================================

_CHECK = env.get("MXNET_TPU_NUMERICS_CHECK")

# the sentinel's record: checks made and their host-read seconds,
# non-finite steps seen, the last one
_STATE = {"checks": 0, "check_seconds": 0.0, "nonfinite": 0, "last": None}


def check_enabled() -> bool:
    """Is the non-finite sentinel armed (``MXNET_TPU_NUMERICS_CHECK``)?"""
    return _CHECK


def _set_check(flag):
    """Arm or disarm the sentinel without re-importing; returns the
    previous setting."""
    global _CHECK
    prev = _CHECK
    _CHECK = bool(flag)
    return prev


class NonFiniteError(RuntimeError):
    """A gradient (or the loss) went NaN/Inf; ``param`` names the first
    offender, ``step`` the update count, ``kind`` is ``'nan'`` or
    ``'inf'``.  Raised after the step kept the pre-step weights and
    optimizer state, so a handler can lower the lr or skip the batch and
    go on."""

    def __init__(self, param, step, kind):
        super().__init__(
            "non-finite gradient: %s in parameter %r at step %s "
            "(weights kept at their pre-step values)" % (kind, param, step))
        self.param = param
        self.step = step
        self.kind = kind


def _float_leaves(leaves):
    return [x for x in leaves
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def finite_tree(leaves):
    """Whether every element of every floating tensor of ``leaves`` is
    finite, as a 0-d bool on their device (on the CPU when there is
    none); other leaves (integer counters) are skipped.  Each dtype
    group reduces to one flag; no host read."""
    fl = _float_leaves(leaves)
    if not fl:
        return torch.tensor(True)
    flags = [torch.stack([torch.isfinite(fl[i]).all() for i in idxs]).all()
             for _dtype, idxs in dtype_groups(fl)]
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def finite_all(arrays):
    """:func:`finite_tree` over NDArrays or tensors: one finite check
    over the set, a device boolean the caller reads when it chooses."""
    return finite_tree([getattr(a, "_data", a) for a in arrays])


def attribute_nonfinite(named):
    """``(name, kind)`` of the first non-finite entry of ``(name,
    tensor)`` pairs, NaN reported before Inf when both occur; None when
    every entry is finite.  Reads each tensor on the host (the failure
    path only)."""
    first_inf = None
    for name, t in named:
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            continue
        t = t.detach()
        if bool(torch.isnan(t).any()):
            return name, "nan"
        if first_inf is None and bool(torch.isinf(t).any()):
            first_inf = (name, "inf")
    return first_inf


def note_check(seconds):
    """Book one sentinel check of ``seconds`` (its host read): the
    ``/statusz`` counter and the ``numerics.checks`` /
    ``numerics.check_time`` instruments."""
    _STATE["checks"] += 1
    _STATE["check_seconds"] += seconds
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.numerics_check(seconds)


def finite_sentinel(named, step=None):
    """Check ``(name, array)`` pairs for non-finite values with one
    host read and raise :class:`NonFiniteError` naming the first
    offender (NaN before Inf).  Disarmed, the default, it touches
    nothing.  Returns True on a clean pass."""
    if not _CHECK:
        return True
    named = list(named)
    ok_dev = finite_all([a for _n, a in named])
    t0 = time.perf_counter()
    ok = bool(ok_dev)
    note_check(time.perf_counter() - t0)
    if ok:
        return True
    hit = attribute_nonfinite(
        [(n, getattr(a, "_data", a)) for n, a in named])
    param, kind = hit if hit is not None else ("<unattributed>",
                                               "nonfinite")
    record_nonfinite(param, step, kind)
    raise NonFiniteError(param, step, kind)


def record_nonfinite(param, step, kind):
    """Book a detected non-finite step: telemetry and the ``/statusz``
    row."""
    _STATE["nonfinite"] += 1
    _STATE["last"] = {"param": param, "step": step, "kind": kind}
    from .. import telemetry as _telemetry
    if _telemetry._ENABLED:
        _telemetry.hooks.numerics_nonfinite(param, step, kind)


# -- chaos integration -------------------------------------------------

def poison_action(ctx):
    """The ``numerics.nonfinite`` chaos action: instead of raising,
    mark the caller's ``box`` so IT poisons the in-flight batch with a
    NaN -- the fault then flows through forward/backward and must be
    caught by the sentinel, not by the injector.  Arm with::

        chaos.on("numerics.nonfinite", numerics.poison_action, nth=3)
    """
    box = ctx.get("box")
    if box is not None:
        box["poison"] = True


def poison_nd(x):
    """A copy of a floating array (NDArray or tensor) with element 0 set
    to NaN, in the wrapper it came in; any other array comes back as it
    is."""
    data = getattr(x, "_data", x)
    if not data.is_floating_point():
        return x
    poisoned = data.detach().clone()
    poisoned.view(-1)[0] = float("nan")
    if hasattr(x, "_data"):
        from ..ndarray import NDArray
        return NDArray(poisoned)
    return poisoned


def status_row():
    """The ``/statusz`` numerics row: sentinel arm state, checks run,
    non-finite steps seen, and the last attribution."""
    return {"armed": _CHECK, "checks": _STATE["checks"],
            "nonfinite": _STATE["nonfinite"], "last": _STATE["last"]}
