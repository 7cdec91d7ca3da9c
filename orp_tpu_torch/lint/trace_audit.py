"""Runtime compile auditor: count the port's kernel builds and CUDA-graph
captures per watched site (counterpart of ``orp_tpu/lint/trace_audit.py``).

The static rules (orp_tpu_torch/lint/rules.py) catch capture *hazards*; this
is the runtime companion that catches capture *facts*. A ``CompileAudit``
context manager snapshots the count of registered capture sites on entry and
enforces per-site budgets on exit:

    audit = CompileAudit()
    audit.watch("gn_iteration", "gn_iteration", budget=2)
    with audit:
        backward_induction(...)
    audit.deltas()  # {"gn_iteration": 1} — or CompileBudgetExceeded on exit

The counters are ``utils/cuda_build.SITE_COUNTS``, fed by every build and
capture site of the port: ``nvcc`` runs, the CUDA graphs captured of an Adam
epoch (``fit_epoch``), a GN iteration (``gn_iteration``) and a served bucket
(``serve_bucket``), other ``aot_compile`` captures (``aot_graph``), and the
programs the fused walk builds before its date loop (``walk_program``, counted
on any device; the card captures each once). A "compile" here is what costs
wall time on the card: an ``nvcc`` run or a graph capture (the JAX package
counts XLA executables). Two invariants ride on it:

- a served AOT bundle captures exactly one graph per shape bucket
  (``HedgeEngine.cache_info()["graph_captures"]`` reads the same counters);
- the backward walk builds and captures a number of programs that does not
  depend on the date count (one per leg, first and warm dates sharing it —
  a walk whose count grows with dates has broken shape stability).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from orp_tpu_torch.utils import cuda_build


class CompileBudgetExceeded(RuntimeError):
    """A watched site built or captured more programs than its budget."""


def compile_count(site: str) -> int:
    """This process's count at capture site ``site``.

    ``site`` must name one of ``cuda_build.CAPTURE_SITES``; anything else
    (a function, an unknown name) raises TypeError, so a mis-wired audit
    fails loudly, not at zero forever."""
    if not isinstance(site, str) or site not in cuda_build.SITE_COUNTS:
        raise TypeError(
            f"{site!r} is not a capture site — pass one of "
            f"{cuda_build.CAPTURE_SITES} (the port's build and capture sites "
            "count there), not a function")
    return cuda_build.SITE_COUNTS[site]


@dataclasses.dataclass
class _Watch:
    name: str
    site: str
    budget: int | None
    before: int


class CompileAudit:
    """Context manager enforcing build/capture budgets over a code region.

    ``watch(name, site, budget=None)`` registers a capture site; a budget is
    a ceiling on NEW builds or captures inside the ``with`` block (None =
    count only). Budgets are checked on clean exit; an exception already in
    flight propagates untouched. Re-entrant use re-snapshots, so one audit
    can gate several regions sequentially.
    """

    def __init__(self) -> None:
        self._watches: dict[str, _Watch] = {}
        self._active = False

    def watch(self, name: str, site: str, budget: int | None = None) -> None:
        if name in self._watches:
            w = self._watches[name]
            if w.site != site:
                raise ValueError(f"watch {name!r} already registered for {w.site!r}")
            if budget is not None:
                w.budget = budget if w.budget is None else min(w.budget, budget)
            return
        self._watches[name] = _Watch(
            name, site, budget,
            before=compile_count(site) if self._active else 0,
        )

    def __enter__(self) -> "CompileAudit":
        self._active = True
        for w in self._watches.values():
            w.before = compile_count(w.site)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._active = False
        if exc_type is not None:
            return
        over = [
            f"{w.name}: {d} builds/captures > budget {w.budget}"
            for w in self._watches.values()
            if w.budget is not None and (d := self.delta(w.name)) > w.budget
        ]
        if over:
            raise CompileBudgetExceeded(
                "compile budget exceeded — a shape leak or a per-call capture "
                "is forcing rebuilds: " + "; ".join(over)
            )

    def delta(self, name: str) -> int:
        w = self._watches[name]
        return compile_count(w.site) - w.before

    def deltas(self) -> dict[str, int]:
        return {name: self.delta(name) for name in self._watches}

    def report(self) -> dict[str, Any]:
        """JSON-able audit record (for bench/CI artifacts)."""
        return {
            "compiles": self.deltas(),
            "budgets": {n: w.budget for n, w in self._watches.items()},
        }


def watch_backward_walk(audit: CompileAudit, *, fit_budget: int | None = 2,
                        outputs_budget: int | None = 1,
                        mesh=None) -> CompileAudit:
    """Register the backward walk's capture sites on ``audit``.

    Budgets encode the walk's shape-stability contract: each fit kind
    captures once per fit config (the GN iteration once per leg, the Adam
    epoch once per first-date and warm config: ``fit_budget`` = 2), all
    regardless of date count; ``nvcc`` (the path kernels' one build, none
    once cached) is held to ``outputs_budget``; the fused walk's programs
    (``walk_program``) are counted, one per leg and config per walk.

    ``mesh``: accepted as the JAX package's is, and changes nothing: the
    port's mesh is one process a rank, threaded through
    ``backward_induction(mesh=)``, so a rank's walk captures at the same
    sites in its own process, where this audit counts them (there is no
    per-mesh wrapper to watch, as the JAX package's ``fused_walk_on_mesh``
    is).
    """
    audit.watch("fit_epoch", "fit_epoch", budget=fit_budget)
    audit.watch("gn_iteration", "gn_iteration", budget=fit_budget)
    audit.watch("nvcc", "nvcc", budget=outputs_budget)
    audit.watch("walk_program", "walk_program")  # count-only: legs x configs
    return audit


def watch_serve_engine(audit: CompileAudit, *, budget: int | None = None
                       ) -> CompileAudit:
    """Register the serve engine's one capture site: a graph per bucket.

    ``budget`` should be the number of DISTINCT shape buckets the audited
    region is allowed to capture (one capture per bucket, ever; an engine on
    an AOT-less bundle captures none).
    """
    audit.watch("serve_bucket", "serve_bucket", budget=budget)
    return audit
