"""The port's lock-discipline tooling (``orp_tpu_torch/lint``) against the JAX
package's, mirroring ``tests/test_lint_concurrency.py``.

- ORP020-ORP022: every fixture project of the reference's tests (its
  constants and the snippets inline in its test functions) gives the same
  findings — path, rule, line, column and message — through both packages'
  ``analyze_sources``: each reference test runs here with its ``conc``
  helper routed through both analyzers, so its own assertions hold on the
  port's findings too.
- ``LockAudit``: an injected inversion is reported with both sites, a
  hold-budget breach with its site, a condition wait ends the hold, a
  reentrant acquire is one hold, the live condition of a running batcher is
  audited in place. Every check is on counts or on bounds no loaded test
  worker can trip (a hold that sleeps past its budget can only get longer).
- ``CompileAudit``: an injected extra capture is reported by its site's name;
  ``compile_count`` refuses what is not a capture site.
- A warm-tier thread stress on the port's ``ServeHost`` under the audit: no
  order inversion, and the runtime edges respect the static canonical order.
"""

import inspect
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_lint_concurrency as ref
from orp_tpu.lint import analyze_sources as janalyze_sources
from orp_tpu_torch.lint import (CONCURRENCY_RULES, CompileAudit, CompileBudgetExceeded,
                                HoldBudgetExceeded, LockAudit, LockOrderInversion,
                                analyze_sources, audit_host, compile_count)
from orp_tpu_torch.lint.lock_audit import audit_condition
from orp_tpu_torch.lint.trace_audit import watch_backward_walk, watch_serve_engine
from orp_tpu_torch.utils import cuda_build

REF_STATIC = sorted(name for name, fn in inspect.getmembers(ref, inspect.isfunction)
                    if name.startswith(("test_orp020", "test_orp021", "test_orp022",
                                        "test_concurrency_rule_registry")))


def _key(findings):
    return [(f.path, f.rule, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("name", REF_STATIC)
def test_reference_fixture_projects_give_the_same_findings(name, monkeypatch):
    seen = []

    def both(sources: dict, select=None):
        srcs = {p: textwrap.dedent(s) for p, s in sources.items()}
        got = analyze_sources(srcs, select=select)
        want = janalyze_sources(srcs, select=select)
        assert _key(got) == _key(want)
        seen.append(len(srcs))
        return [(f.path, f.rule) for f in want], want

    monkeypatch.setattr(ref, "conc", both)
    getattr(ref, name)()
    assert seen or name == "test_concurrency_rule_registry"


def test_fixture_projects_under_port_paths():
    """The planes are found by path component, so the reference's fixtures
    fire the same way under ``orp_tpu_torch/`` paths, and ``pilot/`` is one
    of the port's planes."""
    for prefix in ("orp_tpu_torch/serve", "orp_tpu_torch/store", "orp_tpu_torch/pilot"):
        got = analyze_sources({f"{prefix}/counter.py": textwrap.dedent(ref.ORP020_POS)})
        assert [f.rule for f in got] == ["ORP020"]
    got = analyze_sources({"orp_tpu_torch/serve/a.py": textwrap.dedent(ref.CYCLE_A),
                           "orp_tpu_torch/store/b.py": textwrap.dedent(ref.CYCLE_B)})
    assert "ORP022" in [f.rule for f in got]
    from orp_tpu_torch.lint.concurrency import plane_files
    from orp_tpu_torch.lint.engine import DEFAULT_LINT_ROOT

    planes = {f.relative_to(DEFAULT_LINT_ROOT).parts[0] for f in plane_files([DEFAULT_LINT_ROOT])}
    assert planes == {"serve", "store", "obs", "guard", "pilot"}


def test_orp021_flags_torch_host_syncs_under_a_lock():
    src = """
        import threading
        import torch

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.out = None

            def read(self):
                with self._lock:
                    torch.cuda.synchronize()
                    return self.out.cpu()

            def ok(self):
                with self._lock:
                    out = self.out
                return out.cpu()
    """
    got = analyze_sources({"orp_tpu_torch/serve/e.py": textwrap.dedent(src)},
                          select=["ORP021"])
    assert [(f.rule, f.line) for f in got] == [("ORP021", 12), ("ORP021", 13)]


def test_concurrency_rule_registry():
    assert set(CONCURRENCY_RULES) == {"ORP020", "ORP021", "ORP022"}
    with pytest.raises(ValueError, match="unknown concurrency rule"):
        analyze_sources({}, select=["ORP099"])


# -- LockAudit: runtime order/hold sanitizer ----------------------------------


def test_lock_audit_reports_injected_inversion_with_both_sites():
    audit = LockAudit()
    a, b = audit.wrap("A"), audit.wrap("B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=60)
    with pytest.raises(LockOrderInversion) as ei:
        audit.check()
    msg = str(ei.value)
    assert "A -> B" in msg and "B -> A" in msg
    assert msg.count("test_torch_lint_concurrency.py:") == 4
    assert audit.report()["violations"]


def test_lock_audit_reports_hold_budget_breach_with_site():
    audit = LockAudit(hold_budget_s=0.001)
    lk = audit.wrap("ServeHost._lock")
    with lk:
        time.sleep(0.02)   # a hold can only get longer on a loaded worker
    with pytest.raises(HoldBudgetExceeded) as ei:
        audit.check()
    msg = str(ei.value)
    assert "ServeHost._lock" in msg and "budget" in msg
    assert "test_torch_lint_concurrency.py:" in msg


def test_lock_audit_condition_wait_ends_the_hold():
    """Condition(wrapped) routes wait() through _release_save/_acquire_restore:
    the wait ends the hold (two acquires recorded: the entry and the wake-up),
    and the waiter's long wait is not billed as one hold."""
    audit = LockAudit(hold_budget_s=None)
    lk = audit.wrap("cv_lock", threading.RLock())
    cv = threading.Condition(lk)
    done, woke = [], threading.Event()

    def waiter():
        with cv:
            while not done:
                cv.wait(timeout=30.0)
        woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    while audit.report()["acquires"].get("cv_lock", 0) < 1:
        time.sleep(0.001)
    time.sleep(0.05)
    with cv:            # the notifier takes the lock while the waiter waits
        done.append(1)
        cv.notify_all()
    t.join(timeout=60)
    assert woke.is_set()
    rep = audit.report()
    assert rep["acquires"]["cv_lock"] >= 3        # waiter, notifier, waiter's wake-up
    assert rep["max_hold_s"]["cv_lock"]["hold_s"] < 30.0


def test_lock_audit_reentrant_acquire_is_one_hold():
    audit = LockAudit(hold_budget_s=None)
    lk = audit.wrap("r", threading.RLock())
    with lk:
        with lk:  # nested: not a second hold, the clock keeps running
            time.sleep(0.01)
        time.sleep(0.01)
    rep = audit.report()
    assert rep["acquires"]["r"] == 1
    assert rep["max_hold_s"]["r"]["hold_s"] >= 0.02    # ONE hold spanning both sleeps


def test_lock_audit_bookkeeping_is_counted_per_acquire():
    """The auditor's cost is a dict update and a clock pair per acquire:
    counted here (every acquire recorded, no edge or violation from an
    uncontended lock), not timed, so a loaded worker cannot trip it."""
    audit = LockAudit(hold_budget_s=None)
    lk = audit.wrap("bench")
    for _ in range(2000):
        with lk:
            pass
    rep = audit.report()
    assert rep["acquires"] == {"bench": 2000}
    assert rep["edges"] == [] and rep["violations"] == []
    audit.check()


def test_audit_condition_routes_a_live_condition():
    """A running batcher's condition is audited in place: a thread already
    parked in wait() still wakes on notify, and the next acquires are
    recorded under the name."""
    audit = LockAudit(hold_budget_s=None)
    cv = threading.Condition()
    flag, woke = [], threading.Event()

    def waiter():
        with cv:
            while not flag:
                cv.wait(timeout=30.0)
        woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    audit_condition(cv, audit, "MicroBatcher._cv[x]")
    with cv:
        flag.append(1)
        cv.notify_all()
    t.join(timeout=60)
    assert woke.is_set()
    assert audit.report()["acquires"]["MicroBatcher._cv[x]"] >= 1
    audit.check()


# -- CompileAudit ---------------------------------------------------------------


def test_compile_audit_reports_injected_extra_capture_by_name():
    audit = CompileAudit()
    audit.watch("gn_iteration", "gn_iteration", budget=0)
    with pytest.raises(CompileBudgetExceeded, match="gn_iteration: 1 builds/captures"):
        with audit:
            cuda_build.count_capture(0.0, site="gn_iteration")  # the injected capture
    assert audit.deltas() == {"gn_iteration": 1}


def test_compile_count_refuses_what_is_not_a_capture_site():
    with pytest.raises(TypeError, match="not a capture site"):
        compile_count(torch.matmul)
    with pytest.raises(TypeError, match="not a capture site"):
        compile_count("jit_cache")
    assert compile_count("nvcc") == cuda_build.SITE_COUNTS["nvcc"]


def test_watch_helpers_register_the_port_sites():
    audit = watch_serve_engine(watch_backward_walk(CompileAudit()), budget=3)
    rep = audit.report()
    assert set(rep["budgets"]) == {"fit_epoch", "gn_iteration", "nvcc", "walk_program",
                                   "serve_bucket"}
    assert rep["budgets"]["serve_bucket"] == 3 and rep["budgets"]["walk_program"] is None
    with audit:
        cuda_build.count_capture(0.0, site="serve_bucket")
        cuda_build.count_site("walk_program")
    assert audit.deltas()["serve_bucket"] == 1 and audit.deltas()["walk_program"] == 1


# -- warm-tier thread stress under the audit ----------------------------------


@pytest.fixture(scope="module")
def trained():
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return european_hedge(EuropeanConfig(),
                              SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2),
                              TrainConfig(dual_mode="mse_only", epochs_first=4, epochs_warm=2),
                              device="cpu")
    finally:
        torch.set_num_threads(n)


def test_warm_tier_stress_green_under_lock_audit(trained):
    """Hammer the port's ServeHost activate/evict/prefetch/stats from threads
    with every host, tier, build and live batcher lock audited: no order
    inversion and no hold past a budget no CPU worker reaches (nothing blocks
    under a serving lock)."""
    from orp_tpu_torch.serve import ServeHost
    from orp_tpu_torch.store import TierManager

    rng = np.random.default_rng(7)
    feats = (1.0 + 0.1 * rng.standard_normal((8, trained.model.n_features))).astype(np.float32)
    names = [f"t{i}" for i in range(4)]
    audit = LockAudit(hold_budget_s=30.0)
    with ServeHost(max_live_engines=2, tiers=TierManager(max_warm=2),
                   engine_kwargs={"device": "cpu"}) as host:
        for n in names:
            host.add_tenant(n, trained)
        host.evaluate(names[0], 0, feats)       # one live batcher to wire
        audit_host(host, audit)
        errors = []

        def submitter(k):
            try:
                for i in range(8):
                    host.evaluate(names[(k + i) % len(names)], i % 4, feats)
            except Exception as e:  # orp: noqa[ORP009] -- re-raised via the errors list assertion below
                errors.append(e)

        def prefetcher():
            try:
                for i in range(6):
                    host.prefetch([names[i % len(names)]])
            except Exception as e:  # orp: noqa[ORP009] -- re-raised via the errors list assertion below
                errors.append(e)

        def observer():
            try:
                for _ in range(12):
                    st = host.stats()
                    assert all(v["pending"] >= 0 for v in st.values())
            except Exception as e:  # orp: noqa[ORP009] -- re-raised via the errors list assertion below
                errors.append(e)

        with ThreadPoolExecutor(max_workers=5) as pool:
            for k in range(3):
                pool.submit(submitter, k)
            pool.submit(prefetcher)
            pool.submit(observer)
        assert errors == []
    audit.check()
    rep = audit.report()
    assert rep["violations"] == []
    assert rep["acquires"]["ServeHost._lock"] > 20
    assert rep["acquires"]["ServeHost._pending_lock"] > 20
    assert any(k.startswith("MicroBatcher._cv[") for k in rep["acquires"])
    edges = {(e["from"], e["to"]) for e in rep["edges"]}
    for a, b in edges:
        assert (b, a) not in edges, f"inverted pair {a} <-> {b}"
    assert not any(a in ("ServeHost._pending_lock", "TierManager._lock")
                   and b == "ServeHost._lock" for a, b in edges), edges
