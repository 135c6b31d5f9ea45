"""AST helpers shared by the static rules: the port's copy of the
helpers ``mxnet_tpu/analysis/sharding.py`` holds for the JAX package's
perf, numerics and memory rules, so each rule resolves calls, bodies and
``jax.jit`` sites exactly as its JAX twin does."""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


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
