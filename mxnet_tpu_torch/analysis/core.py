"""Pluggable rule framework shared by the analysis passes (counterpart
of ``mxnet_tpu/analysis/core.py``, the same ids, severities, suppression
comments and JSON).

The reference validates a graph only when binding it (``GraphExecutor``
runs nnvm InferShape/InferType and aborts on the first inconsistency);
everything else -- host syncs inside what will become a captured CUDA
graph, scalars frozen into a capture -- surfaces as a runtime failure or
a perf cliff.  Here every check is a ``Rule`` with a stable id, a
severity, and one of these kinds:

- ``graph``: walks a ``Symbol`` (:mod:`.graph_check`)
- ``ast``:   walks a source file's AST (:mod:`.trace_lint` and the
  per-file rules of the other passes)
- ``project``: walks a whole source tree (:mod:`.concurrency`)
- ``registry``: cross-references op specs with engine internals
  (:mod:`.retrace`)
- ``compiled``: diffs two audit artifacts (:mod:`.perf`,
  :mod:`.numerics`, :mod:`.memory`)

A rule is added by decorating a checker with ``@rule(...)``; the
CLI, the CI gate, suppression comments, and ``--json`` output all pick
it up with no further wiring.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["Diagnostic", "Rule", "RULES", "rule", "get_rule", "list_rules",
           "filter_suppressed", "render_human", "render_json",
           "ERROR", "WARNING"]

ERROR = "error"
WARNING = "warning"


@dataclass
class Diagnostic:
    """One finding: where, which rule, and what to do about it."""
    rule: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    node: Optional[str] = None       # graph node name for graph rules
    severity: str = ERROR

    @property
    def location(self) -> str:
        if self.file is not None:
            return "%s:%s" % (self.file, self.line if self.line else "?")
        if self.node is not None:
            return "graph:%s" % self.node
        return "<registry>"

    def format(self) -> str:
        return "%s: %s[%s]: %s" % (self.location, self.severity,
                                   self.rule, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "file": self.file,
                "line": self.line, "node": self.node}


@dataclass
class Rule:
    """A registered check.  ``check``'s signature depends on ``kind``:

    - ast:      ``check(tree, path, ctx) -> Iterable[Diagnostic]``
    - graph:    ``check(symbol, ctx) -> Iterable[Diagnostic]``
    - registry: ``check(ctx) -> Iterable[Diagnostic]``
    """
    id: str
    kind: str                 # "ast" | "graph" | "registry"
    doc: str
    severity: str = ERROR
    check: Callable = field(default=None, repr=False)


RULES: Dict[str, Rule] = {}


def rule(id: str, kind: str, doc: str, severity: str = ERROR):
    """Decorator registering a checker under a stable rule id."""
    def deco(fn: Callable) -> Callable:
        if id in RULES:
            raise ValueError("duplicate analysis rule id: %s" % id)
        RULES[id] = Rule(id=id, kind=kind, doc=doc, severity=severity,
                         check=fn)
        return fn
    return deco


def get_rule(id: str) -> Rule:
    return RULES[id]


def list_rules(kind: Optional[str] = None) -> List[Rule]:
    return [r for r in RULES.values() if kind is None or r.kind == kind]


# -- per-line suppression ----------------------------------------------
# ``# mxlint: disable=rule-a,rule-b`` silences those rules on its line;
# ``# mxlint: disable`` with no list silences every rule on the line.
_SUPPRESS_RE = re.compile(r"#\s*mxlint:\s*disable(?:=([\w,\-]+))?")


def suppressions_for_line(line_text: str) -> Optional[set]:
    """None if no directive; empty set means 'all rules'."""
    m = _SUPPRESS_RE.search(line_text)
    if m is None:
        return None
    return set(filter(None, (m.group(1) or "").split(",")))


def filter_suppressed(diags: List[Diagnostic],
                      source_lines: List[str]) -> List[Diagnostic]:
    """Drop file diagnostics whose source line carries a matching
    ``# mxlint: disable`` directive."""
    out = []
    for d in diags:
        if d.line is not None and 1 <= d.line <= len(source_lines):
            sup = suppressions_for_line(source_lines[d.line - 1])
            if sup is not None and (not sup or d.rule in sup):
                continue
        out.append(d)
    return out


# -- output ------------------------------------------------------------

def render_human(diags: List[Diagnostic]) -> str:
    lines = [d.format() for d in diags]
    errors = sum(d.severity == ERROR for d in diags)
    warnings = len(diags) - errors
    lines.append("mxlint: %d error(s), %d warning(s)" % (errors, warnings))
    return "\n".join(lines)


def render_json(diags: List[Diagnostic]) -> str:
    errors = sum(d.severity == ERROR for d in diags)
    return json.dumps({
        "diagnostics": [d.to_dict() for d in diags],
        "errors": errors,
        "warnings": len(diags) - errors,
    }, indent=2)
