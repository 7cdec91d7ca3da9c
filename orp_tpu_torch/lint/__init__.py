"""orp_tpu_torch.lint — CUDA/H100-aware static analyzer + runtime auditors
(counterpart of ``orp_tpu/lint``).

Static side (``python -m orp_tpu_torch.lint [--json|--format sarif]
[paths]``): an AST rules engine (lint/engine.py) with per-file rules
targeting the port's real hazards (lint/rules.py, ORP001-ORP019 + ORP023 +
ORP024, the JAX package's codes with their CUDA counterparts) plus a
PROJECT-WIDE lock-discipline pass (lint/concurrency.py, ORP020-ORP022:
guarded-by drift, blocking work under a lock, lock-order cycles across the
serve/store/obs/guard/pilot planes) and per-line
``# orp: noqa[RULE] -- reason`` suppressions. The port lints itself clean
(tests/test_torch_lint_self.py); ``--changed`` scopes the per-file pass to
the git diff for the inner edit loop; ``--list --markdown`` generates the
README rule table (pinned by a drift test).

Runtime side: ``CompileAudit`` (lint/trace_audit.py) counts ``nvcc`` runs
and CUDA-graph captures per capture site and enforces budgets;
``LockAudit`` (lint/lock_audit.py) wraps named locks to record per-thread
acquisition order and hold times, failing tests on lock-order inversions
and hold-budget breaches — the dynamic counterpart of ORP020-ORP022.
"""

from orp_tpu_torch.lint.engine import (
    Finding,
    RULES,
    all_rule_summaries,
    format_findings,
    format_json,
    format_rule_list,
    format_sarif,
    lint_paths,
    lint_source,
)
from orp_tpu_torch.lint import rules as _rules  # noqa: F401  (registers ORP001-ORP024)
from orp_tpu_torch.lint.concurrency import (
    CONCURRENCY_RULES,
    analyze_paths,
    analyze_sources,
)
from orp_tpu_torch.lint.trace_audit import (
    CompileAudit,
    CompileBudgetExceeded,
    compile_count,
    watch_backward_walk,
    watch_serve_engine,
)
from orp_tpu_torch.lint.lock_audit import (
    HoldBudgetExceeded,
    LockAudit,
    LockAuditError,
    LockOrderInversion,
    audit_host,
)

__all__ = [
    "CONCURRENCY_RULES",
    "CompileAudit",
    "CompileBudgetExceeded",
    "Finding",
    "HoldBudgetExceeded",
    "LockAudit",
    "LockAuditError",
    "LockOrderInversion",
    "RULES",
    "all_rule_summaries",
    "analyze_paths",
    "analyze_sources",
    "audit_host",
    "compile_count",
    "format_findings",
    "format_json",
    "format_rule_list",
    "format_sarif",
    "lint_paths",
    "lint_source",
    "watch_backward_walk",
    "watch_serve_engine",
]
