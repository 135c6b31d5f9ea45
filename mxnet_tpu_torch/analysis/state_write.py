"""Atomicity lint: bare ``open(..., "wb")`` state writes (counterpart
of ``mxnet_tpu/analysis/state_write.py``).

A save path that writes state with a bare ``open()`` leaves, when the
process is killed mid-write (a preemption's grace window ending, an OOM
kill), a truncated file that loads garbage or crashes the resume.  The
port's save paths route through ``mxnet_tpu_torch.checkpoint.core``'s
atomic tmp+fsync+``os.replace`` commit; this rule keeps it that way.

A diagnostic fires for ``open(<path>, "wb"/"bw"/"wb+"/...)`` inside any
function whose name marks it as a state-serialization path (``save``,
``checkpoint``, ``states``, ``dump``, ``export`` in the name) -- except
inside ``checkpoint/core.py`` itself, which owns the staging files.
Serialization *primitives* that legitimately write a caller-staged path
(``ndarray.save``) carry a ``# mxlint: disable=bare-state-write``
with a comment pointing callers at ``checkpoint.core.commit``.
"""
from __future__ import annotations

import ast
import re

from .core import Diagnostic, rule

__all__ = []

# function names that mark a state-serialization path
_STATE_FN_RE = re.compile(
    r"(save|checkpoint|states|dump|serialize|export)", re.IGNORECASE)
# the module allowed to open staging files directly
_EXEMPT_PATH_RE = re.compile(r"checkpoint[/\\]core\.py$")


def _write_binary_mode(call):
    """The mode string of an ``open`` call, if it is a binary write."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and "w" in mode.value and "b" in mode.value:
        return mode.value
    return None


@rule("bare-state-write", "ast",
      "A bare open(..., 'wb') in a save/checkpoint/export path writes "
      "state without torn-write protection; route it through "
      "mxnet_tpu_torch.checkpoint.core (commit / atomic_write_bytes).")
def _lint_bare_state_write(tree, path, ctx):
    if _EXEMPT_PATH_RE.search(path or ""):
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _STATE_FN_RE.search(fn.name):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Name) and f.id == "open"):
                continue
            mode = _write_binary_mode(node)
            if mode is None:
                continue
            yield Diagnostic(
                "bare-state-write",
                "open(..., %r) inside %r writes state without "
                "torn-write protection: a kill mid-write leaves a "
                "truncated file that loads garbage.  Use "
                "checkpoint.core.atomic_write_bytes / commit "
                "(tmp+fsync+os.replace)" % (mode, fn.name),
                file=path, line=node.lineno)
