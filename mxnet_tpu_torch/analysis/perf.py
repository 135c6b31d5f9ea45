"""perflint: the performance linter and the efficiency auditor of the
walked steps (counterpart of ``mxnet_tpu/analysis/perf.py``).

**Static layer** (AST; runs in ``python -m mxnet_tpu_torch.analysis
--self``).  The rules, ids and findings are the JAX package's on the
same source; what each finding costs on the H100:

- ``layout-hostile-conv``: a Conv/Pool layer constructed with the
  *silent* NCHW default in model code.  cuDNN's tensor-core
  convolutions run channels-last; an NCHW net pays transposes around
  every one (the layout category is 12.1% of the AMP ResNet-50 step's
  bytes, PERF.md section 5).  Construction sites must choose a layout
  explicitly -- thread a ``layout`` parameter (model_zoo does) or pass
  the literal deliberately.
- ``pad-waste``: a literal layer dim (Dense units, Conv channels,
  Embedding width) not aligned to what the tensor-core paths need, 16
  bytes in the minor dimension: a multiple of 8 elements in bf16 and 4
  in fp32/TF32.  The waste fraction is computed against that and an
  aligned did-you-mean dim suggested.
- ``python-loop-unroll``: a Python ``for`` over ``range(N)`` or a
  homogeneous layer stack inside a captured scope or a ``jax.jit`` step
  function -- the capture records N copies of the body: capture time
  and graph nodes grow linearly.
- ``scalar-recompile``: a per-step-varying Python scalar (``lr``,
  ``t``, ``loss_scale``, ...) passed by keyword into an op invocation
  when that name is not fed from the device
  (``parallel/data_parallel.py :: _DYNAMIC_PARAMS``): inside a capture
  the value is frozen, or keyed on, one graph captured per value.
- ``eager-in-step-loop``: an eager ``nd.*`` op dispatched inside a
  detected training loop -- per-step launches between the captured
  steps that leave the card idle (eager Adam's idle share was
  0.23-0.43, PERF.md section 6).

**Walked layer**: :func:`perf_audit` reads the CostReports that the
profiling walk registered (``profiling.store``; each key's eager
warm-up walked by ``profiling.aten.Walk``) with the counters stored
beside each, and emits ranked advisories: layout-movement share above
threshold, convolutions on channels-first activations (which cuDNN's
tensor-core paths convert), elementwise bytes left to separate aten
launches, operand
bytes lost to the tensor cores' 16-byte alignment, and memory-bound
steps whose arithmetic intensity sits far below the H100's ridge
(``profiling/roofline.py :: device_peaks``: about 295 flop/B in bf16,
20 in fp32).  Hand kernels appear once, under their own names, charged
by their ``KernelSpec`` cost functions (``kernels/costs.py``).  The
artifact is the JAX package's (schema ``mxperf.audit.v1``, the same
keys), so ``save_audit``/``diff_audit`` and ``--perf-diff`` gate drift
as there (rule ``perf-drift``).
"""
from __future__ import annotations

import ast
import json
import re as _re
from typing import Dict, List, Optional

from .. import env as _env
from ._ast_util import (_call_name, _file_defs_and_assigns, _is_jit_call,
                        _resolve_body)
from .core import Diagnostic, WARNING, rule
from .retrace import VARYING_PARAM_NAMES, eager_dynamic_params
from .trace_lint import _traced_scopes

__all__ = [
    "AUDIT_SCHEMA", "THRESHOLDS",
    "perf_audit", "save_audit", "load_audit", "diff_audit",
]

# ----------------------------------------------------------------------
# the tensor cores' alignment: 16 bytes in the minor dimension
# ----------------------------------------------------------------------

ALIGN_BYTES = 16
ALIGN_BF16 = ALIGN_BYTES // 2      # elements
ALIGN_F32 = ALIGN_BYTES // 4
# literal dims below this are structural (class counts, stem widths) --
# rounding them up changes the task, not the padding
_PAD_MIN_DIM = 16

# layer constructors whose dim/layout choices the static rules inspect
_DIM_LAYERS = {"Dense": 0, "Conv1D": 0, "Conv2D": 0, "Conv3D": 0,
               "Embedding": 1}
_DIM_KWARGS = {"units", "channels", "output_dim"}
_LAYOUT_LAYERS = {
    "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose", "Conv1DTranspose",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
    "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
}
# iterables that read as a homogeneous layer/step stack
_STACK_NAME_RE = _re.compile(r"(layers|blocks|cells|steps|stack)s?$",
                             _re.I)
_MIN_UNROLL = 4


def _ceil_to(d, g):
    return ((d + g - 1) // g) * g


# ----------------------------------------------------------------------
# layout-hostile-conv
# ----------------------------------------------------------------------

@rule("layout-hostile-conv", "ast",
      "A Conv/Pool layer constructed with the silent NCHW default in "
      "model code; the channels-last (NHWC) path exists and NCHW costs "
      "transposes around every cuDNN tensor-core convolution on the "
      "H100.  Thread a layout parameter (model_zoo idiom) or pass "
      "layout= explicitly.")
def _lint_layout_hostile(tree, path, ctx):
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node) in _LAYOUT_LAYERS):
            continue
        kwnames = {kw.arg for kw in node.keywords}
        if "layout" in kwnames:
            continue
        if None in kwnames:
            continue      # a **kwargs splat may carry layout; not decidable
        yield Diagnostic(
            "layout-hostile-conv",
            "%s constructed without an explicit layout= relies on the "
            "silent NCHW default; a channels-last path exists "
            "(layout=\"NHWC\") and on the H100 the NCHW tax is a "
            "transpose around every cuDNN tensor-core convolution.  "
            "Thread a layout parameter or pass the literal deliberately"
            % _call_name(node),
            file=path, line=node.lineno)


# ----------------------------------------------------------------------
# pad-waste
# ----------------------------------------------------------------------

def _literal_dim(call: ast.Call) -> Optional[int]:
    name = _call_name(call)
    pos = _DIM_LAYERS.get(name)
    cand = None
    if pos is not None and len(call.args) > pos:
        cand = call.args[pos]
    for kw in call.keywords:
        if kw.arg in _DIM_KWARGS:
            cand = kw.value
    if isinstance(cand, ast.Constant) and isinstance(cand.value, int):
        return cand.value
    return None


@rule("pad-waste", "ast",
      "A literal layer dim not aligned to the tensor cores' 16 bytes "
      "(8 elements bf16 / 4 fp32-TF32): the product runs on a padded "
      "copy or off the aligned path, and the pad fraction is dead "
      "work.  Round the dim to the suggested multiple, or suppress "
      "where the dim is semantic (class count, reference "
      "architecture).")
def _lint_pad_waste(tree, path, ctx):
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node) in _DIM_LAYERS):
            continue
        d = _literal_dim(node)
        if d is None or d < _PAD_MIN_DIM or d % ALIGN_BF16 == 0:
            continue
        pad16 = _ceil_to(d, ALIGN_BF16)
        pad32 = _ceil_to(d, ALIGN_F32)
        yield Diagnostic(
            "pad-waste",
            "%s dim %d is not a multiple of the tensor cores' 16-byte "
            "alignment: pads to %d in bf16 (%.1f%% waste) and %d in "
            "fp32/TF32 (%.1f%% waste); did you mean %d?"
            % (_call_name(node), d, pad16, 100 * (pad16 - d) / pad16,
               pad32, 100 * (pad32 - d) / pad32, pad16),
            file=path, line=node.lineno)


# ----------------------------------------------------------------------
# python-loop-unroll
# ----------------------------------------------------------------------

def _jitted_fn_nodes(tree):
    """Function defs in ``tree`` that are passed to ``jax.jit`` --
    their bodies are traced, so Python loops there unroll."""
    defs, assigns = _file_defs_and_assigns(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_jit_call(node) and node.args:
            body = _resolve_body(node.args[0], defs, assigns)
            if body is not None and body[2] is not None:
                out.append(body[2])
    return out


def _own_loops(fn):
    """For loops lexically in ``fn``'s body, nested defs excluded
    (their loops belong to another trace decision)."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.For):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _range_trip(it) -> Optional[int]:
    if not (isinstance(it, ast.Call) and _call_name(it) == "range"):
        return None
    args = it.args
    lits = [a.value for a in args
            if isinstance(a, ast.Constant) and isinstance(a.value, int)]
    if len(lits) != len(args) or not args:
        return None
    if len(lits) == 1:
        return lits[0]
    if len(lits) >= 2:
        return lits[1] - lits[0]
    return None


def _calls_loop_target(loop) -> bool:
    if not isinstance(loop.target, ast.Name):
        return False
    tgt = loop.target.id
    for n in ast.walk(loop):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name) and f.id == tgt:
                return True
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == tgt:
                return True
    return False


def _iter_stack_name(it) -> Optional[str]:
    base = it
    if isinstance(base, ast.Call) and isinstance(base.func, ast.Attribute) \
            and base.func.attr in ("values", "items"):
        base = base.func.value
    if isinstance(base, ast.Attribute):
        name = base.attr
    elif isinstance(base, ast.Name):
        name = base.id
    else:
        return None
    return name if _STACK_NAME_RE.search(name) else None


@rule("python-loop-unroll", "ast",
      "A Python for over range(N)/a homogeneous layer stack inside a "
      "captured scope (hybrid_forward and its kin, or a jitted step "
      "fn): the capture records N copies of the body -- capture time "
      "and graph nodes grow linearly with N.")
def _lint_loop_unroll(tree, path, ctx):
    scopes = list(_traced_scopes(tree))
    seen = {id(s) for s in scopes}
    for fn in _jitted_fn_nodes(tree):
        if id(fn) not in seen:
            seen.add(id(fn))
            scopes.append(fn)
    for fn in scopes:
        for loop in _own_loops(fn):
            trip = _range_trip(loop.iter)
            if trip is not None and trip >= _MIN_UNROLL:
                yield Diagnostic(
                    "python-loop-unroll",
                    "python for over range(%d) inside captured scope %r "
                    "records %d copies of the body into the graph; "
                    "capture time and graph nodes grow with it -- keep "
                    "the loop outside the capture or batch the work"
                    % (trip, fn.name, trip),
                    file=path, line=loop.lineno)
                continue
            stack = _iter_stack_name(loop.iter)
            if stack is not None and _calls_loop_target(loop):
                yield Diagnostic(
                    "python-loop-unroll",
                    "python for over homogeneous stack %r inside "
                    "captured scope %r records one body copy per layer "
                    "into the graph (capture time and graph nodes grow "
                    "with the depth)" % (stack, fn.name),
                    file=path, line=loop.lineno)


# ----------------------------------------------------------------------
# scalar-recompile
# ----------------------------------------------------------------------

def _chain(func) -> List[str]:
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def _is_op_invoke(func) -> bool:
    parts = _chain(func)
    if not parts:
        return False
    if parts[0] in ("F", "nd", "sym"):
        return len(parts) > 1
    return len(parts) > 2 and parts[0] == "mx" and parts[1] in ("nd", "sym")


@rule("scalar-recompile", "ast",
      "A per-step-varying Python scalar (lr/t/loss_scale/...) passed "
      "by keyword into an op invocation when no device tensor feeds "
      "that name (TrainStep's _DYNAMIC_PARAMS): inside a capture the "
      "value is frozen into the graph, or each value captures a graph "
      "of its own.  The static call-site twin of the retrace auditor.")
def _lint_scalar_recompile(tree, path, ctx):
    try:
        dynamic = set(eager_dynamic_params())
    except Exception:
        dynamic = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_op_invoke(node.func)):
            continue
        for kw in node.keywords:
            if kw.arg not in VARYING_PARAM_NAMES or kw.arg in dynamic:
                continue
            if isinstance(kw.value, ast.Constant):
                continue      # a literal is one cache entry, not a leak
            yield Diagnostic(
                "scalar-recompile",
                "op call passes varying scalar %r=%s outside the "
                "device-fed set %s; inside a capture the value is "
                "frozen into the graph (or one graph is captured per "
                "value).  Feed it from the step's scalars tensor or "
                "pass it as a tensor input"
                % (kw.arg, ast.unparse(kw.value), sorted(dynamic)),
                file=path, line=node.lineno)


# ----------------------------------------------------------------------
# eager-in-step-loop
# ----------------------------------------------------------------------

# ingest/sync entry points, not per-step compute dispatch
_EAGER_EXEMPT = {"array", "NDArray", "waitall", "save", "load"}


def _is_eager_nd_call(func) -> bool:
    parts = _chain(func)
    if len(parts) < 2:
        return False
    if parts[0] == "nd" or (len(parts) > 2 and parts[0] == "mx"
                            and parts[1] == "nd"):
        leaf = parts[-1]
        return leaf not in _EAGER_EXEMPT and not leaf[:1].isupper()
    return False


def _is_train_loop(loop) -> bool:
    """A loop whose body dispatches a train step (bare ``step(...)`` or
    ``trainer.step(...)``), nested defs excluded."""
    stack = list(loop.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Name) and f.id == "step") or \
                    (isinstance(f, ast.Attribute) and f.attr == "step"):
                return True
        stack.extend(ast.iter_child_nodes(n))
    return False


@rule("eager-in-step-loop", "ast",
      "An eager nd.* op dispatched inside a detected training loop (a "
      "loop whose body calls step()): per-step launches between the "
      "captured steps, each a host dispatch that leaves the card idle; "
      "the captured step should absorb them.")
def _lint_eager_in_step_loop(tree, path, ctx):
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        if not _is_train_loop(node):
            continue
        stack = list(node.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.For, ast.While)):
                continue          # inner loops report themselves
            if isinstance(n, ast.Call) and _is_eager_nd_call(n.func):
                yield Diagnostic(
                    "eager-in-step-loop",
                    "eager op %s dispatched inside a training loop: a "
                    "launch between captured steps that idles the card; "
                    "move it into the captured step (TrainStep) or the "
                    "input pipeline"
                    % ".".join(_chain(n.func)),
                    file=path, line=n.lineno)
            stack.extend(ast.iter_child_nodes(n))


# ======================================================================
# Walked layer: the efficiency auditor of the CostReports
# ======================================================================

AUDIT_SCHEMA = "mxperf.audit.v1"

# advisory thresholds -- shares of the step's walked byte traffic
# (transpose/unfused) or of its aligned product operand bytes (pad
# waste); memory-bound fires when intensity < ridge / factor
THRESHOLDS = {
    "transpose_share": 0.20,
    "unfused_elementwise_share": 0.15,
    "pad_waste": 0.15,
    "membound_ridge_factor": 8.0,
}

def _kernel_remedy(kind: str) -> Optional[str]:
    """The hand kernels remedying an advisory kind (each registered
    ``KernelSpec`` names its ``remedies``), or None."""
    from ..kernels import registry
    specs = [registry.get(n) for n in registry.list_kernels()]
    names = ["%s (%s)" % (s.name, s.source) for s in specs
             if kind in s.remedies]
    return "hand kernels " + ", ".join(names) if names else None


def _merge_counters(agg: Dict, cur: Dict):
    for k, v in cur.items():
        if isinstance(v, dict):
            slot = agg.setdefault(k, {})
            for nm, b in v.items():
                slot[nm] = slot.get(nm, 0) + b
        else:
            agg[k] = agg.get(k, 0) + v


def _counters_of(rep: Dict, audit: Optional[Dict]) -> Dict:
    """The JAX audit's counters of one walked step: its categories'
    bytes and flops from the CostReport, the rest from the walk's
    audit counters (zero when the report was stored without them)."""
    a = audit or {}
    return {
        "bytes_total": int(rep["totals"]["bytes_accessed"]),
        "flops_total": int(rep["totals"]["flops"]),
        "category_bytes": {c: int(v["bytes"])
                           for c, v in rep["categories"].items()},
        "unfused_elementwise_bytes": int(
            a.get("unfused_elementwise_bytes", 0)),
        "unfused_elementwise_count": int(
            a.get("unfused_elementwise_count", 0)),
        "transpose_ops": dict(a.get("transpose_ops", {})),
        "mxu_actual_bytes": int(a.get("mxu_actual_bytes", 0)),
        "mxu_padded_bytes": int(a.get("mxu_padded_bytes", 0)),
        "half_product_flops": int(a.get("half_product_flops", 0)),
        "product_flops": int(a.get("product_flops", 0)),
        "conv_bytes": int(a.get("conv_bytes", 0)),
        "nchw_conv_bytes": int(a.get("nchw_conv_bytes", 0)),
        "kernels": dict(a.get("kernel_bytes", {})),
    }


def _metrics_of(counters: Dict) -> Dict:
    total_b = counters["bytes_total"] or 1
    flops = counters["flops_total"]
    nbytes = counters["bytes_total"]
    return {
        "transpose_share": round(
            counters["category_bytes"].get("transpose_layout", 0)
            / total_b, 4),
        "unfused_elementwise_share": round(
            counters["unfused_elementwise_bytes"] / total_b, 4),
        "unfused_elementwise_count":
            counters["unfused_elementwise_count"],
        "pad_waste": round(
            1.0 - counters["mxu_actual_bytes"]
            / counters["mxu_padded_bytes"], 4)
            if counters["mxu_padded_bytes"] else 0.0,
        "intensity": round(flops / nbytes, 4) if nbytes else 0.0,
        "flops": flops,
        "bytes": nbytes,
        "nchw_conv_share": round(
            counters["nchw_conv_bytes"] / counters["conv_bytes"], 4)
            if counters["conv_bytes"] else 0.0,
    }


def _ridge_of(counters: Dict, ridges: Dict) -> float:
    """The ridge of the step's dominant product type: bf16's when half
    products carry most of its product flops, fp32's otherwise."""
    half = counters["half_product_flops"]
    return ridges["bfloat16"] if half * 2 > counters["product_flops"] \
        and half else ridges["float32"]


def _advisories_for(label: str, metrics: Dict, counters: Dict,
                    ridge: float, thresholds: Dict) -> List[Dict]:
    adv = []
    top_transpose = sorted(counters["transpose_ops"].items(),
                           key=lambda kv: -kv[1])[:3]
    if metrics["transpose_share"] >= thresholds["transpose_share"]:
        adv.append({
            "kind": "transpose-share",
            "category": "transpose_layout",
            "share": metrics["transpose_share"],
            "op_names": [nm for nm, _b in top_transpose],
            "message": "%.0f%% of %r's memory traffic is pure layout "
                       "movement (permute/copy/pad/cast); top ops: %s "
                       "-- a channels-last layout (cuDNN's tensor-core "
                       "convolutions run NHWC) usually removes it"
                       % (100 * metrics["transpose_share"], label,
                          ", ".join(nm for nm, _b in top_transpose)
                          or "<unnamed>"),
        })
    if metrics["nchw_conv_share"] > 0:
        adv.append({
            "kind": "layout-nchw-conv",
            "category": "transpose_layout",
            "share": metrics["nchw_conv_share"],
            "op_names": ["aten.convolution"],
            "message": "%.0f%% of %r's convolution bytes run on "
                       "channels-first (NCHW) activations: cuDNN's "
                       "tensor-core convolutions take channels-last, so "
                       "each pays layout conversions -- build the net "
                       "with layout=\"NHWC\" (the static "
                       "layout-hostile-conv rule names the constructors)"
                       % (100 * metrics["nchw_conv_share"], label),
        })
    if metrics["unfused_elementwise_share"] >= \
            thresholds["unfused_elementwise_share"]:
        adv.append({
            "kind": "unfused-elementwise",
            "category": "elementwise_fusion",
            "share": metrics["unfused_elementwise_share"],
            "op_names": [],
            "message": "%.0f%% of %r's memory traffic is %d elementwise "
                       "aten op(s), each its own launch and HBM round "
                       "trip -- a hand kernel or a fused op should carry "
                       "the chain"
                       % (100 * metrics["unfused_elementwise_share"],
                          label, metrics["unfused_elementwise_count"]),
        })
    if metrics["pad_waste"] >= thresholds["pad_waste"]:
        adv.append({
            "kind": "hlo-pad-waste",
            "category": "conv_dot",
            "share": metrics["pad_waste"],
            "op_names": [],
            "message": "%.0f%% of %r's product operand bytes are padding "
                       "to the tensor cores' 16-byte alignment -- align "
                       "the feature dims (the static pad-waste rule names "
                       "the constructors)"
                       % (100 * metrics["pad_waste"], label),
        })
    factor = thresholds["membound_ridge_factor"]
    if metrics["bytes"] and metrics["intensity"] < ridge / factor:
        adv.append({
            "kind": "memory-bound",
            "category": "elementwise_fusion",
            "share": round(min(1.0, metrics["intensity"] / ridge), 4),
            "op_names": [],
            "message": "%r's arithmetic intensity %.2f flops/byte is "
                       ">%.0fx below the H100's ridge %.1f -- the step is "
                       "bound by HBM bandwidth; do more work per byte "
                       "(bigger batch, bf16 activations, fused kernels)"
                       % (label, metrics["intensity"], factor, ridge),
        })
    for a in adv:
        remedy = _kernel_remedy(a["kind"])
        if remedy:
            a["remedy"] = remedy
    adv.sort(key=lambda a: -a["share"])
    return adv


def _backend():
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def perf_audit(thresholds=None, peaks=None) -> Dict:
    """Audit every CostReport the profiling walk registered.

    Reports are merged per label (several keys of one label sum their
    counters) and the audit artifact returned::

        {"schema": ..., "ridge_intensity": ...,
         "executables": {label: {"metrics": {...},
                                 "advisories": [...]}}}

    ``thresholds`` overrides :data:`THRESHOLDS`; ``peaks`` is an
    optional ``(peak_flops, peak_bytes_per_s)`` pair pinning one ridge
    for every step (tests); by default the card's peaks
    (``roofline.device_peaks``: the bf16 ridge for a step whose
    products run mostly on half inputs, the fp32 one otherwise; assumed
    peaks off the card, recorded in ``peaks_assumed``)."""
    from ..profiling import roofline, store

    th = dict(THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    if peaks is not None:
        ridges = {dt: peaks[0] / peaks[1] for dt in ("bfloat16",
                                                      "float32")}
        assumed = False
    else:
        ridges = {}
        for dt in ("bfloat16", "float32"):
            fl, bw, assumed = roofline.device_peaks(dtype=dt)
            ridges[dt] = fl / bw

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
        ridge = _ridge_of(counters, ridges)
        metrics["ridge_intensity"] = round(ridge, 3)
        execs[label] = {
            "metrics": metrics,
            "advisories": _advisories_for(label, metrics, counters,
                                          ridge, th),
            # the hand kernels, each under its own name, by its bytes
            "kernels": counters["kernels"],
        }
    ranked = sorted(
        (dict(a, executable=label)
         for label, e in execs.items() for a in e["advisories"]),
        key=lambda a: -a["share"])
    return {
        "schema": AUDIT_SCHEMA,
        "backend": _backend(),
        "ridge_intensity": round(ridges["bfloat16"], 3),
        "ridge_intensity_fp32": round(ridges["float32"], 3),
        "peaks_assumed": assumed,
        "thresholds": th,
        "executables": execs,
        "advisories": ranked,
    }


def save_audit(path: str, audit=None) -> Dict:
    """Write the current perf audit as JSON (the artifact
    ``--perf-diff`` compares)."""
    audit = audit if audit is not None else perf_audit()
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


# share metrics where GROWTH is a regression
_GROWTH_METRICS = ("transpose_share", "unfused_elementwise_share",
                   "pad_waste", "nchw_conv_share")


def diff_audit(baseline: Dict, current: Dict,
               tol: Optional[float] = None) -> List[Diagnostic]:
    """Perf drift of ``current`` vs the blessed ``baseline``:

    - an advisory KIND the baseline doesn't carry for that step (or a
      brand-new step that audits with advisories) -> error;
    - a share metric (transpose / unfused-elementwise / pad-waste)
      grown more than ``tol`` (absolute; default
      ``MXNET_TPU_PERF_AUDIT_TOL`` = 0.02) -> error;
    - arithmetic intensity dropped >20% -> warning.

    Improvements (smaller shares, fewer advisories) pass silently --
    re-bless with :func:`save_audit` after an intentional change."""
    tol = _env.get("MXNET_TPU_PERF_AUDIT_TOL") if tol is None else tol
    diags: List[Diagnostic] = []
    base_ex = baseline.get("executables", {})
    for label, cur in sorted(current.get("executables", {}).items()):
        base = base_ex.get(label, {"metrics": {}, "advisories": []})
        blessed_kinds = {a["kind"] for a in base.get("advisories", [])}
        for a in cur.get("advisories", []):
            if a["kind"] not in blessed_kinds:
                remedy = a.get("remedy") or _kernel_remedy(a["kind"])
                diags.append(Diagnostic(
                    "perf-drift",
                    "executable %r gained unblessed %r advisory "
                    "(category %s, cost share %.1f%%%s): %s -- fix the "
                    "regression or re-bless via analysis.perf."
                    "save_audit" % (label, a["kind"], a["category"],
                                    100 * a["share"],
                                    ", remedy: %s" % remedy if remedy
                                    else "", a["message"]),
                    node=label))
        bm = base.get("metrics", {})
        cm = cur.get("metrics", {})
        for m in _GROWTH_METRICS:
            b, c = bm.get(m, 0.0), cm.get(m, 0.0)
            if c > b + tol:
                diags.append(Diagnostic(
                    "perf-drift",
                    "executable %r: %s grew %.4f -> %.4f (tolerance "
                    "%.4f); the step got less efficient than the "
                    "baseline blesses" % (label, m, b, c, tol),
                    node=label))
        b_int, c_int = bm.get("intensity", 0.0), cm.get("intensity", 0.0)
        if b_int > 0 and c_int < b_int * 0.8:
            diags.append(Diagnostic(
                "perf-drift",
                "executable %r: arithmetic intensity dropped %.3f -> "
                "%.3f (>20%%); the step is doing less compute per byte "
                "moved" % (label, b_int, c_int),
                node=label, severity=WARNING))
    return diags


@rule("perf-drift", "compiled",
      "A walked step's efficiency metrics (transpose share, unfused "
      "elementwise bytes, alignment pad waste, intensity) drifted past "
      "a blessed perf-audit artifact -- a named, gated regression.  "
      "Gate: --perf-diff.")
def _rule_perf_drift(baseline, current):
    return diff_audit(baseline, current)
