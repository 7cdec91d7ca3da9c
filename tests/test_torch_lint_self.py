"""Tier-1 gates for the port's lint layer (mirroring ``tests/test_lint_self.py``):
the port lints itself clean, and the runtime compile auditor
(``orp_tpu_torch/lint/trace_audit.py``) pins the capture-stability invariants
the static rules cannot prove:

- the fused walk builds (and on the card captures) a number of programs that
  does not depend on the date count — one per leg and fit config;
- an engine serves every bucket with no capture of its own unless its bundle
  ships an AOT set (one capture a bucket then, ``tests/test_torch_cuda.py``).

On the CPU nothing is captured: the walk's ``walk_program`` site is the one
the card captures at, and it is counted on any device.
"""

import pathlib

import numpy as np
import pytest
import torch

from orp_tpu_torch.lint import (CompileAudit, CompileBudgetExceeded, analyze_paths,
                                compile_count, format_findings, lint_paths,
                                watch_backward_walk, watch_serve_engine)
from orp_tpu_torch.lint.concurrency import build_analyzer

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_package_lints_clean():
    """``python -m orp_tpu_torch.lint`` exits 0 on this tree: every
    intentional hazard site carries a reasoned ``# orp: noqa[RULE]``."""
    findings = lint_paths([REPO / "orp_tpu_torch"])
    assert findings == [], "\n" + format_findings(findings)


def test_smoke_and_port_tools_lint_clean():
    findings = lint_paths([REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("torch_*.py"))])
    assert findings == [], "\n" + format_findings(findings)


def test_concurrency_pass_runs_clean_on_the_port():
    findings = analyze_paths([REPO / "orp_tpu_torch"])
    assert findings == [], "\n" + format_findings(findings)


def test_lock_order_graph_is_acyclic_and_nontrivial():
    """The index sees the port's lock family (a refactor that renamed the
    locks out of recognition would turn the pass into a no-op), build_lock is
    the outermost lock and nothing re-enters the host lock."""
    analyzer = build_analyzer([REPO / "orp_tpu_torch"])
    stats = analyzer.stats()
    assert stats["locks"] >= 10 and stats["classes"] >= 30
    edges = {(e["from"], e["to"]) for e in analyzer.lock_order_edges()}
    assert ("_Tenant.build_lock", "ServeHost._lock") in edges
    assert ("ServeHost._lock", "TierManager._lock") in edges
    inner = {"TierManager._lock", "ServeHost._pending_lock"}
    assert not any(a in inner for a, _ in edges)
    # acyclic: no pair in both directions, and a topological order exists
    nodes = {n for e in edges for n in e}
    order, pending = [], set(nodes)
    while pending:
        free = [n for n in pending if not any(a in pending and b == n for a, b in edges)]
        assert free, f"lock-order cycle among {sorted(pending)}"
        order += free
        pending -= set(free)


# -- compile auditor ---------------------------------------------------------


def test_compile_count_requires_a_capture_site():
    with pytest.raises(TypeError, match="not a capture site"):
        compile_count(lambda x: x)


def test_compile_audit_counts_and_enforces():
    from orp_tpu_torch.utils import cuda_build

    audit = CompileAudit()
    audit.watch("fit", "fit_epoch", budget=1)
    with audit:
        cuda_build.count_capture(0.0, site="fit_epoch")
    assert audit.deltas() == {"fit": 1}
    audit2 = CompileAudit()
    audit2.watch("fit", "fit_epoch", budget=0)
    with pytest.raises(CompileBudgetExceeded, match="fit: 1 builds/captures"):
        with audit2:
            cuda_build.count_capture(0.0, site="fit_epoch")
    # an exception in flight propagates untouched (no budget masking)
    audit3 = CompileAudit()
    audit3.watch("fit", "fit_epoch", budget=0)
    with pytest.raises(ZeroDivisionError):
        with audit3:
            cuda_build.count_capture(0.0, site="fit_epoch")
            1 / 0


def _tiny_policy():
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge

    return european_hedge(EuropeanConfig(),
                          SimConfig(n_paths=256, T=1.0, dt=1 / 4, rebalance_every=2),
                          TrainConfig(dual_mode="mse_only", epochs_first=10, epochs_warm=5,
                                      batch_size=256), device="cpu")


def test_serve_engine_captures_nothing_without_an_aot_set():
    """An engine on an AOT-less bundle serves every bucket eagerly: the
    serve_bucket site stays at zero over a sweep of sizes and dates, and the
    buckets are the reference's."""
    from orp_tpu_torch.serve import HedgeEngine

    engine = HedgeEngine(_tiny_policy(), device="cpu")
    audit = watch_serve_engine(CompileAudit(), budget=0)
    with audit:
        for date in range(engine.n_dates):
            for n in (1, 5, 8, 100, 128):
                engine.evaluate(date, np.ones((n, 1), np.float32))
    assert audit.deltas() == {"serve_bucket": 0}
    assert engine.cache_info()["graph_captures"] == 0
    assert engine.cache_info()["buckets"] == [8, 128]


def _walk(n_dates: int, optimizer: str):
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.qmc import gbm_log_plain
    from orp_tpu_torch.train import BackwardConfig, backward_induction

    s = gbm_log_plain(128, n_dates, s0=1.0, drift=0.08, sigma=0.15, dt=1.0 / n_dates,
                      seed=1234).exp().float()
    b = torch.exp(0.08 * torch.linspace(0.0, 1.0, n_dates + 1))
    cfg = BackwardConfig(epochs_first=5, epochs_warm=3, dual_mode="mse_only", batch_size=128,
                         lr=1e-3, optimizer=optimizer, gn_iters_first=4, gn_iters_warm=2,
                         fused=True)
    audit = watch_backward_walk(CompileAudit())
    with audit:
        backward_induction(HedgeMLP(n_features=1), s[:, :, None], s, b,
                           torch.clamp(s[:, -1] - 1.0, min=0.0), cfg)
    return audit.deltas()


@pytest.mark.parametrize("optimizer", ["adam", "gauss_newton"])
def test_backward_walk_capture_count_constant_in_dates(optimizer):
    """The walk's shape-stability contract: a 3-date and a 6-date fused walk
    build the same programs before their date loops (one per leg and fit
    config), and capture the same (none on the CPU)."""
    d3, d6 = _walk(3, optimizer), _walk(6, optimizer)
    assert d3 == d6
    assert 1 <= d3["walk_program"] <= 2
    assert d3["fit_epoch"] == d3["gn_iteration"] == d3["nvcc"] == 0
