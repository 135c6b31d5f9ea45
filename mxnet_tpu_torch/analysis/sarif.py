"""SARIF 2.1.0 export of mxlint findings (counterpart of
``mxnet_tpu/analysis/sarif.py``; the same document, the tool named
``mxlint-torch`` with the port's version).

``python -m mxnet_tpu_torch.analysis --sarif OUT.sarif`` serializes
every surviving diagnostic -- all passes -- as one SARIF run, so tools
that speak the OASIS Static Analysis Results Interchange Format (code
scanning services, SARIF viewers) show the findings as inline
annotations.  The CLI's exit-code contract is unchanged: the export is
a side artifact, not a reporting mode.

Only the schema's *required* fields are emitted (version, runs,
the tool's name, result ruleId/level/message), plus the optional
tool version, rule metadata (shortDescription/fullDescription from
the registry docstrings) and physical locations
(artifactLocation.uri + region.startLine).
"""
from __future__ import annotations

import json
from typing import Dict, List

from .core import ERROR, RULES, Diagnostic

__all__ = ["SARIF_VERSION", "SARIF_SCHEMA", "to_sarif", "write_sarif"]

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def _rule_meta(rule_id: str) -> Dict:
    meta = {"id": rule_id}
    reg = RULES.get(rule_id)
    if reg is not None and reg.doc:
        first = reg.doc.split(". ")[0].rstrip(".") + "."
        meta["shortDescription"] = {"text": first}
        meta["fullDescription"] = {"text": reg.doc}
    else:
        # ad-hoc diagnostics (syntax-error, graph-load) carry no
        # registry entry; SARIF still requires the id
        meta["shortDescription"] = {"text": rule_id}
    return meta


def _result(d: Diagnostic) -> Dict:
    res = {
        "ruleId": d.rule,
        "level": "error" if d.severity == ERROR else "warning",
        "message": {"text": d.message},
    }
    if d.file:
        region = {}
        if d.line:
            region["startLine"] = int(d.line)
        loc = {"artifactLocation": {"uri": d.file}}
        if region:
            loc["region"] = region
        res["locations"] = [{"physicalLocation": loc}]
    return res


def to_sarif(diags: List[Diagnostic]) -> Dict:
    """The findings as one SARIF 2.1.0 log object (a single run,
    tool ``mxlint-torch``); rule metadata is pulled from the registry for
    every rule id present."""
    from .. import __version__
    seen, rules = set(), []
    for d in diags:
        if d.rule not in seen:
            seen.add(d.rule)
            rules.append(_rule_meta(d.rule))
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "mxlint-torch",
                "version": __version__,
                "informationUri":
                    "https://github.com/apache/incubator-mxnet",
                "rules": rules,
            }},
            "results": [_result(d) for d in diags],
        }],
    }


def write_sarif(path: str, diags: List[Diagnostic]) -> Dict:
    log = to_sarif(diags)
    with open(path, "w") as f:
        json.dump(log, f, indent=1, sort_keys=True)
        f.write("\n")
    return log
