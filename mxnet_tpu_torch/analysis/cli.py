"""``python -m mxnet_tpu_torch.analysis`` -- the port's mxlint, one CLI
over all the analysis passes (counterpart of
``mxnet_tpu/analysis/cli.py``: its flags, exit codes and JSON).

Exit status: 1 when any error-severity diagnostic survives suppression
(warnings too under ``--strict``), 2 on unreadable input, else 0 -- so
a gate reads the exit code and consumes ``--json`` for reporting.

Incremental mode: ``--changed`` lints only files ``git diff`` names
(worktree vs HEAD, falling back to the last commit), and ``--baseline
snapshot.json`` suppresses findings recorded by a previous
``--write-baseline`` run, while ``--self`` (the port's package) remains
the authoritative full gate.  ``--collective-diff`` diffs two
collective contracts of walked steps (the sharding sanitizer's gate).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List

from .core import (ERROR, RULES, Diagnostic, render_human, render_json)

__all__ = ["main"]

# what ``--self`` lints (from the repository's root): the port's package
SELF_PATHS = ("mxnet_tpu_torch",)


def _build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="Static graph checker + capture-safety linter + "
                    "concurrency sanitizer + perf linter + numerics "
                    "sanitizer + memory sanitizer + retrace auditor for "
                    "mxnet_tpu_torch.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint")
    ap.add_argument("--self", dest="self_check", action="store_true",
                    help="lint the port itself (%s) and run the "
                         "retrace audit -- the full lint gate"
                         % " ".join(SELF_PATHS))
    ap.add_argument("--changed", action="store_true",
                    help="lint only files `git diff --name-only` "
                         "reports (worktree vs HEAD, else the last "
                         "commit); lock-order analysis still builds "
                         "the full-tree graph but reports only into "
                         "changed files")
    ap.add_argument("--baseline", metavar="JSON",
                    help="suppress findings recorded in this snapshot "
                         "(see --write-baseline)")
    ap.add_argument("--write-baseline", metavar="JSON",
                    help="write surviving findings as a baseline "
                         "snapshot and exit 0")
    ap.add_argument("--graph", action="append", default=[],
                    metavar="SYMBOL_JSON",
                    help="run the static graph checker over a saved "
                         "-symbol.json (repeatable)")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="NAME=SHAPE",
                    help="input shape for --graph checking, e.g. "
                         "data=1,3,224,224 (repeatable)")
    ap.add_argument("--retrace", action="store_true",
                    help="audit op-table params against the "
                         "capture keys")
    ap.add_argument("--collective-diff", nargs=2,
                    metavar=("BASELINE", "CURRENT"),
                    help="diff two collective-contract JSONs (written "
                         "by analysis.sharding.save_contract) and fail "
                         "on unblessed collectives of a walked step")
    ap.add_argument("--perf-diff", nargs=2,
                    metavar=("BASELINE", "CURRENT"),
                    help="diff two perf-audit JSONs (written by "
                         "analysis.perf.save_audit) and fail on grown "
                         "transpose/unfused/pad-waste shares or "
                         "unblessed advisories")
    ap.add_argument("--numerics-diff", nargs=2,
                    metavar=("BASELINE", "CURRENT"),
                    help="diff two numerics-audit JSONs (written by "
                         "analysis.numerics.save_audit) and fail on "
                         "grown half-accum-dot/convert-storm/"
                         "half-reduce shares or unblessed advisories")
    ap.add_argument("--memory-diff", nargs=2,
                    metavar=("BASELINE", "CURRENT"),
                    help="diff two memory-audit JSONs (written by "
                         "analysis.memory.save_audit) and fail on "
                         "grown peak memory or unblessed steps/"
                         "advisories")
    ap.add_argument("--sarif", metavar="OUT",
                    help="also write surviving findings (every pass) "
                         "as a SARIF 2.1.0 log; exit-code contract "
                         "unchanged")
    ap.add_argument("--disable", default="", metavar="RULES",
                    help="comma-separated rule ids to skip")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every registered rule and exit")
    return ap


def _parse_shapes(specs) -> dict:
    shapes = {}
    for spec in specs:
        name, _, dims = spec.partition("=")
        shapes[name] = tuple(int(d) for d in dims.split(",") if d)
    return shapes


def _list_rules() -> str:
    lines = []
    for r in sorted(RULES.values(), key=lambda r: (r.kind, r.id)):
        lines.append("%-22s %-9s %-8s %s"
                     % (r.id, r.kind, r.severity, r.doc))
    return "\n".join(lines)


def _git_changed_files() -> List[str]:
    """Python files the working tree changed vs HEAD; when the tree is
    clean (CI on a fresh checkout), the files of the last commit."""
    def run(*args):
        try:
            out = subprocess.run(["git"] + list(args),
                                 capture_output=True, text=True,
                                 timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return []
        if out.returncode != 0:
            return []
        return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]

    files = run("diff", "--name-only", "HEAD")
    files += run("ls-files", "--others", "--exclude-standard")
    if not files:
        # a clean tree (CI on a fresh checkout): the last commit's
        # files; diff-tree also handles the root commit
        files = run("diff-tree", "--no-commit-id", "--name-only", "-r",
                    "--root", "HEAD")
    import os
    return sorted({f for f in files
                   if f.endswith(".py") and os.path.exists(f)})


def _baseline_key(d: Diagnostic) -> tuple:
    # line numbers shift on unrelated edits; (rule, file, message) is
    # stable across them
    return (d.rule, d.file or "", d.message)


def _load_baseline(path):
    with open(path) as f:
        data = json.load(f)
    return {(rec["rule"], rec.get("file") or "", rec["message"])
            for rec in data.get("findings", [])}


def _write_baseline(path, diags: List[Diagnostic]):
    recs = [{"rule": d.rule, "file": d.file, "message": d.message}
            for d in diags]
    with open(path, "w") as f:
        json.dump({"format": 1, "findings": recs}, f, indent=2,
                  sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    # importing the passes registers their rules
    from . import (concurrency, graph_check, memory, numerics, perf,
                   retrace, sharding, trace_lint)

    if args.list_rules:
        print(_list_rules())
        return 0

    ignore = set(filter(None, args.disable.split(",")))
    diags: List[Diagnostic] = []

    paths = list(args.paths)
    run_retrace = args.retrace
    report_files = None
    if args.self_check:
        import os
        paths.extend(p for p in SELF_PATHS if os.path.exists(p))
        run_retrace = True
    if args.changed:
        import os
        changed = _git_changed_files()
        # inside this repo, scope to what --self lints (tests are not
        # gated); in a foreign tree every changed .py file counts
        if not paths and any(os.path.exists(p) for p in SELF_PATHS):
            changed = [f for f in changed
                       if any(f == p
                              or f.startswith(p.rstrip("/") + "/")
                              for p in SELF_PATHS)]
        paths.extend(changed)
        # the order graph needs the WHOLE tree to catch a cycle whose
        # other half lives in an unchanged file; reporting stays scoped
        report_files = set(changed)

    if paths:
        diags.extend(trace_lint.lint_paths(paths, ignore=ignore))
        conc_paths = paths
        if report_files is not None:
            import os
            conc_paths = [p for p in SELF_PATHS if os.path.exists(p)]
        diags.extend(concurrency.audit_lock_order(
            conc_paths, ignore=ignore, report_files=report_files))
        # mesh-axis declarations span files the same way lock-order
        # edges do: scan the whole tree, report into the scoped set
        diags.extend(sharding.audit_sharding(
            conc_paths, ignore=ignore, report_files=report_files))

    for gpath in args.graph:
        from ..symbol import load as sym_load
        from ..base import MXNetError
        try:
            sym = sym_load(gpath)
        except (MXNetError, OSError, ValueError, KeyError) as e:
            diags.append(Diagnostic("graph-load",
                                    "cannot load %s: %s" % (gpath, e),
                                    file=gpath, line=0))
            continue
        for d in graph_check.check_symbol(
                sym, shapes=_parse_shapes(args.shape), ignore=ignore):
            d.file = gpath
            diags.append(d)

    if run_retrace:
        diags.extend(d for d in retrace.audit_retrace()
                     if d.rule not in ignore)

    if args.collective_diff:
        base_path, cur_path = args.collective_diff
        try:
            base = sharding.load_contract(base_path)
            cur = sharding.load_contract(cur_path)
        except (OSError, ValueError, KeyError) as e:
            print("mxlint: cannot read collective contract: %s" % e,
                  file=sys.stderr)
            return 2
        diags.extend(d for d in sharding.diff_contract(base, cur)
                     if d.rule not in ignore)

    if args.perf_diff:
        base_path, cur_path = args.perf_diff
        try:
            base = perf.load_audit(base_path)
            cur = perf.load_audit(cur_path)
        except (OSError, ValueError, KeyError) as e:
            print("mxlint: cannot read perf audit: %s" % e,
                  file=sys.stderr)
            return 2
        diags.extend(d for d in perf.diff_audit(base, cur)
                     if d.rule not in ignore)

    if args.numerics_diff:
        base_path, cur_path = args.numerics_diff
        try:
            base = numerics.load_audit(base_path)
            cur = numerics.load_audit(cur_path)
        except (OSError, ValueError, KeyError) as e:
            print("mxlint: cannot read numerics audit: %s" % e,
                  file=sys.stderr)
            return 2
        diags.extend(d for d in numerics.diff_audit(base, cur)
                     if d.rule not in ignore)

    if args.memory_diff:
        base_path, cur_path = args.memory_diff
        try:
            base = memory.load_audit(base_path)
            cur = memory.load_audit(cur_path)
        except (OSError, ValueError, KeyError) as e:
            print("mxlint: cannot read memory audit: %s" % e,
                  file=sys.stderr)
            return 2
        diags.extend(d for d in memory.diff_audit(base, cur)
                     if d.rule not in ignore)

    if not paths and not args.graph and not run_retrace \
            and not args.changed and not args.collective_diff \
            and not args.perf_diff and not args.numerics_diff \
            and not args.memory_diff:
        _build_parser().print_usage()
        return 2

    if args.baseline:
        try:
            known = _load_baseline(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print("mxlint: cannot read baseline %s: %s"
                  % (args.baseline, e), file=sys.stderr)
            return 2
        diags = [d for d in diags if _baseline_key(d) not in known]

    if args.write_baseline:
        _write_baseline(args.write_baseline, diags)
        print("mxlint: wrote %d finding(s) to baseline %s"
              % (len(diags), args.write_baseline))
        return 0

    if args.sarif:
        from .sarif import write_sarif
        write_sarif(args.sarif, diags)

    print(render_json(diags) if args.as_json else render_human(diags))
    failing = [d for d in diags
               if d.severity == ERROR or args.strict]
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
