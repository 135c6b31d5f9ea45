"""``mxnet_tpu_torch.analysis``: the port's mxlint (counterpart of
``mxnet_tpu.analysis``, its ``__all__`` names): the static graph
checker, the capture-safety, state-write, concurrency and retrace
lints, the perf, numerics and memory static rules with their audits
over the profiling walk's CostReports, SARIF export and the CLI --
behind one pluggable rule framework (:mod:`.core`).

- :func:`check_symbol` / :func:`assert_graph_ok` -- validate a
  ``Symbol`` (shapes and dtypes on ``meta`` tensors, dangling/duplicate
  inputs, unknown ops) before anything is allocated.  Also the opt-in
  bind gate: ``Executor(..., check=True)``, ``simple_bind(check=True)``
  or ``MXNET_TPU_GRAPH_CHECK=1``.
- :func:`lint_paths` -- AST-lint source trees for capture-unsafe Python
  (host syncs and value branches in captured scopes, mutable defaults,
  bare ``except:``), non-atomic state writes, the concurrency rules and
  the perf/numerics/memory static rules; the JAX package's rule ids and
  findings on the same source.
- :func:`audit_retrace` -- op params that a capture would freeze.
- :func:`audit_lock_order` / :func:`static_order_edges` -- the
  lock-acquisition-order graph (``sync.seed_static_order`` folds its
  edges into ``MXNET_TPU_TSAN=1``'s runtime graph).
- :func:`perf_audit`, :func:`numerics_audit`, :func:`memory_audit` --
  the audits of the walked steps (``mx.profiling``), each with
  ``save_audit``/``load_audit``/``diff_audit`` in its module, and
  :func:`hbm_plan`; the runtime halves: :func:`finite_sentinel`
  (``MXNET_TPU_NUMERICS_CHECK=1``) and the leak sentinel
  (``MXNET_TPU_MEMORY_WATCH=1``).
- :func:`to_sarif` / :func:`write_sarif` -- SARIF 2.1.0 export.
- the sharding sanitizer (:mod:`.sharding`): the mesh-spec and
  donation rules, the collective contract of each walked step
  (``collective_contract``/``save_contract``/``diff_contract``, rule
  ``collective-drift``, ``MXNET_TPU_SHARD_CHECK``) and the transfer
  guard (``MXNET_TPU_TRANSFER_GUARD``).

CLI: ``python -m mxnet_tpu_torch.analysis`` (``--self`` lints the port's
tree).  Add a rule with ``@mxnet_tpu_torch.analysis.rule(...)``.
"""
from .core import (Diagnostic, Rule, RULES, rule, get_rule, list_rules,
                   render_human, render_json, ERROR, WARNING)
from .graph_check import GraphCheckError, assert_graph_ok, check_symbol
from .trace_lint import lint_file, lint_paths, lint_source
from . import state_write  # noqa: F401  (registers bare-state-write)
from .concurrency import audit_lock_order, static_order_edges
from .retrace import audit_retrace
from .sharding import (audit_sharding, collective_contract,
                       collective_profile, diff_contract, load_contract,
                       save_contract, transfer_guard)
from .perf import diff_audit, load_audit, perf_audit, save_audit
# numerics shares perf's save/load/diff_audit spelling; reach them as
# analysis.numerics.save_audit etc.
from . import numerics
from .numerics import (NonFiniteError, finite_sentinel, finite_tree,
                       numerics_audit)
# memory shares the save/load/diff_audit spelling too; reach them as
# analysis.memory.save_audit etc.
from . import memory
from .memory import hbm_plan, memory_audit
from . import sarif
from .sarif import to_sarif, write_sarif
from .cli import main


def audit_hlo_text(text):
    """The JAX package's HLO-text counters: the port has no HLO (its
    audits read the profiling walk's counters, :func:`perf_audit`)."""
    from ..base import MXNetError
    raise MXNetError("analysis.audit_hlo_text: the port compiles no HLO; "
                     "perf_audit() reads the profiling walk's counters")


__all__ = [
    "Diagnostic", "Rule", "RULES", "rule", "get_rule", "list_rules",
    "render_human", "render_json", "ERROR", "WARNING",
    "GraphCheckError", "assert_graph_ok", "check_symbol",
    "lint_file", "lint_paths", "lint_source",
    "audit_lock_order", "static_order_edges", "audit_retrace",
    "audit_sharding", "collective_contract", "collective_profile",
    "diff_contract", "load_contract", "save_contract", "transfer_guard",
    "audit_hlo_text", "diff_audit", "load_audit", "perf_audit",
    "save_audit",
    "numerics", "NonFiniteError", "finite_sentinel", "finite_tree",
    "numerics_audit",
    "memory", "hbm_plan", "memory_audit",
    "sarif", "to_sarif", "write_sarif",
    "main",
]
