"""The port's single-host serve path on the CPU: the continuous batcher, the
columnar block lane, ragged planning, the guard (retries, shedding, the
watchdog), ``ServeHost`` (LRU eviction to the warm tier, quotas, the canary,
tier promotion through the quality band, the promotions chain), the export
with its baseline, and ``evaluate_quality`` against the JAX package.

Bitwise where the port promises bits: a block's served rows equal per-request
submits and solo evaluations of the same rows, coalesced and ragged dispatches
equal their blocks' own (the per-date forward runs in fixed row tiles, so no
row's result depends on the bucket it rode in). The mixed-date lane against
the per-date lane at ``rtol=1e-5, atol=1e-6`` (two forwards that sum in other
orders), and the quality record against the JAX package's at ``rtol=1e-5``
(f32 paths from two packages' Sobol pipelines)."""

import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from orp_tpu.obs import quality as jquality
from orp_tpu.serve import HedgeEngine as JHedgeEngine
from orp_tpu_torch import NORTH_STAR_POLICY, obs
from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu_torch.guard import (FaultPlan, GuardPolicy, InjectedFault, Rejection, WatchdogTrip,
                                 faults, is_rejection)
from orp_tpu_torch.obs import chain_verify, quality, read_chain
from orp_tpu_torch.serve import (SERVED, SHED_DEADLINE, SHED_QUOTA, SHED_WATERMARK,
                                 BucketPlanner, CanaryRejected, HedgeEngine, MicroBatcher,
                                 ServeHost, SloPolicy, export_bundle, load_bundle,
                                 loop_of_buckets, wire)
from orp_tpu_torch.utils import cuda_build

from test_torch_serve import TOL, _pair, _rows

CPU = {"device": "cpu"}


def _engine(policy, **kw):
    return HedgeEngine(policy, device="cpu", **kw)


class _Counting:
    """An engine wrapper counting dispatches (per-date and mixed)."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def evaluate_async(self, d, f, p=None):
        self.calls.append(("date", int(d), len(f)))
        return self.engine.evaluate_async(d, f, p)

    def evaluate_mixed_async(self, dates, f, p=None):
        self.calls.append(("mixed", len(np.unique(dates)), len(f)))
        return self.engine.evaluate_mixed_async(dates, f, p)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are a few thousand rows, and under
    the suite's parallel workers every worker's default pool oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b) if x is not None or y is not None)


@pytest.fixture(scope="module")
def policies():
    """A 1-feature mse_only policy and a 3-feature ``shared`` dual one."""
    return {"mse": _pair(n_features=1, n_dates=4, seed=3)[1],
            "dual": _pair(n_features=3, n_dates=5, dual_mode="shared", holdings_combine="py",
                          seed=7)[1]}


@pytest.mark.parametrize("which", ["mse", "dual"])
def test_per_request_block_coalesced_and_ragged_are_bitwise(policies, which):
    pol = policies[which]
    eng = _Counting(_engine(pol))
    k = eng.n_instruments
    states, prices = _rows(1040, pol.model.n_features, k, seed=11)
    d = 2
    whole = eng.engine.evaluate(d, states, prices)
    # solo evaluations of single rows and of odd slices: other buckets, same bits
    for lo, hi in ((0, 1), (5, 12), (100, 357), (1000, 1040)):
        assert _bits(eng.engine.evaluate(d, states[lo:hi], prices[lo:hi]),
                     [c[lo:hi] for c in whole])
    # per-request submits through the batcher (coalesced into few dispatches)
    with MicroBatcher(eng, max_batch=512, max_wait_us=2000.0) as mb:
        futs = [mb.submit(d, states[i:i + 7], prices[i:i + 7]) for i in range(0, 1040, 7)]
        got = [f.result(timeout=60) for f in futs]
    assert _bits([np.concatenate([g[j] for g in got]) for j in range(3)], whole)
    # one block; then three blocks coalesced into one dispatch (the worker is
    # held off by the batcher's condition while they queue)
    eng.calls.clear()
    with MicroBatcher(eng, max_batch=1 << 16) as mb:
        blk = mb.submit_block(d, states, prices).result(timeout=60)
        assert blk.n_served == 1040 and blk.shed_counts() == {}
        assert _bits((blk.phi, blk.psi, blk.value), whole)
        n_before = len(eng.calls)
        cuts = (0, 300, 301, 1040)
        with mb._cv:
            futs = [mb.submit_block(d, states[a:b], prices[a:b]) for a, b in zip(cuts, cuts[1:])]
        parts = [f.result(timeout=60) for f in futs]
        assert len(eng.calls) == n_before + 1  # one dispatch for three blocks
    assert _bits([np.concatenate([getattr(p, c) for p in parts]) for c in ("phi", "psi", "value")],
                 whole)
    # ragged: 1040 rows shatter into [1024, 16] under the proxy cost model
    eng.calls.clear()
    with MicroBatcher(eng, ragged=True, max_batch=1 << 16) as mb:
        blk = mb.submit_block(d, states, prices).result(timeout=60)
        with mb._cv:
            futs = [mb.submit_block(d, states[a:b], prices[a:b]) for a, b in
                    zip((0, 8, 1030), (8, 1030, 1040))]
        parts = [f.result(timeout=60) for f in futs]
    assert [c[2] for c in eng.calls[:2]] == [1024, 16]
    assert _bits((blk.phi, blk.psi, blk.value), whole)
    assert _bits([np.concatenate([getattr(p, c) for p in parts]) for c in ("phi", "psi", "value")],
                 whole)
    assert BucketPlanner().split_rows(1040) == [1024, 16]


def test_mixed_date_lane_against_the_per_date_lane(policies):
    pol = policies["dual"]
    eng = _Counting(_engine(pol))
    states, prices = _rows(64, 3, eng.n_instruments, seed=2)
    dates = np.arange(64) % eng.n_dates
    with MicroBatcher(eng, mixed_dates=True, max_batch=1024) as mb:
        with mb._cv:
            futs = [mb.submit(int(dates[i]), states[i:i + 1], prices[i:i + 1]) for i in range(64)]
        got = [f.result(timeout=60) for f in futs]
    assert eng.calls == [("mixed", eng.n_dates, 64)]
    assert eng.engine.cache_info()["mixed_buckets"] == [64]
    want = loop_of_buckets(eng.engine, dates, states, prices)  # one per-date call a date
    for j, col in enumerate(want):
        np.testing.assert_allclose(np.concatenate([g[j] for g in got]), col, **TOL)
    # one date only: the per-date lane, bitwise a solo evaluation
    with MicroBatcher(eng, mixed_dates=True) as mb:
        one = mb.submit(1, states[:5], prices[:5]).result(timeout=60)
    assert eng.calls[-1] == ("date", 1, 5)
    assert _bits(one, eng.engine.evaluate(1, states[:5], prices[:5]))


def test_retries_and_block_time_faults(policies):
    pol = policies["mse"]
    eng = _engine(pol)
    states, _ = _rows(40, 1, 2, seed=4)
    want = eng.evaluate(0, states)
    with obs.telemetry(None) as st, faults(FaultPlan(fail={"serve/dispatch": 2})) as inj:
        with MicroBatcher(eng, policy=GuardPolicy(max_retries=3, backoff_ms=0.5)) as mb:
            got = mb.submit(0, states).result(timeout=30)
        rows = st.registry.collect()
    assert _bits(got, want) and [s for s, _ in inj.log] == ["serve/dispatch"] * 2
    # a retried transient fault counts its rows once
    assert sum(v["value"] for k, v in rows.items() if k.startswith("serve/rows")) == 40
    # without retries the fault reaches the future; a block-time fault retries once
    with faults(FaultPlan(fail={"serve/dispatch": 1})):
        with MicroBatcher(eng) as mb:
            with pytest.raises(InjectedFault):
                mb.submit(0, states).result(timeout=30)
    with faults(FaultPlan(fail={"serve/execute": 1, "serve/dispatch": 0})) as inj:
        with MicroBatcher(eng, policy=GuardPolicy(max_retries=1, backoff_ms=0.5)) as mb:
            blk = mb.submit_block(0, states).result(timeout=30)
    assert _bits((blk.phi, blk.psi), want[:2]) and inj.log[0][0] == "serve/execute"


def test_watchdog_trips_a_hung_launch_and_retries(policies):
    eng = _engine(policies["mse"])
    states, _ = _rows(9, 1, 2, seed=5)
    want = eng.evaluate(3, states)
    # a hang past the wall trips, the block-time retry serves the same bits,
    # and the completed retry breaks the hang streak
    pol = GuardPolicy(hard_wall_ms=40.0, max_retries=1, backoff_ms=0.5)
    with obs.telemetry(None) as st, faults(FaultPlan(delay={"serve/execute": (1, 0.25)})):
        with MicroBatcher(eng, policy=pol) as mb:
            got = mb.submit(3, states).result(timeout=30)
            assert mb._watchdog.trips == 1
        reg = st.registry.collect()
    assert _bits(got, want) and eng._breaker.open_keys == []
    assert any(k.startswith("guard/watchdog_trip") for k in reg)
    assert any("aot_exec_failure" in k and "hang" in k for k in reg)
    # without a retry each hang reaches its future; three in a row open the circuit
    pol = GuardPolicy(hard_wall_ms=40.0)
    with faults(FaultPlan(delay={"serve/execute": (3, 0.25)})), \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with MicroBatcher(eng, policy=pol) as mb:
            for _ in range(3):
                with pytest.raises(WatchdogTrip):
                    mb.submit(3, states).result(timeout=30)
            assert _bits(mb.submit(3, states).result(timeout=30), want)
    assert eng._breaker.open_keys == ["hang:16"]
    assert any("circuit opened" in str(x.message) for x in w)


def test_deadline_and_watermark_statuses(policies):
    eng = _engine(policies["mse"])
    states, _ = _rows(60, 1, 2, seed=6)
    want = eng.evaluate(1, states)
    budgets = np.where(np.arange(60) % 3 == 0, -1.0, 30.0)  # every third row already late
    pol = GuardPolicy(queue_watermark=100, deadline_ms=30_000.0)
    with MicroBatcher(eng, policy=pol) as mb:
        with mb._cv:
            a = mb.submit_block(1, states, deadlines=budgets)
            b = mb.submit_block(1, states)  # 40 of 60 fit under the watermark
        ra, rb = a.result(timeout=30), b.result(timeout=30)
        late = mb.submit(1, states[:2], deadline_s=-1.0).result(timeout=30)
    assert np.array_equal(ra.status, np.where(np.arange(60) % 3 == 0, SHED_DEADLINE, SERVED))
    assert np.array_equal(rb.status, np.r_[np.full(40, SERVED), np.full(20, SHED_WATERMARK)])
    live = ra.status == SERVED
    assert np.array_equal(ra.phi[live], want[0][live]) and not ra.phi[~live].any()
    assert np.array_equal(rb.phi[:40], want[0][:40])
    assert is_rejection(late) and late.reason == "deadline"


@pytest.fixture
def host_trio(policies):
    """Three tenants on a 2-engine host (CPU), the third a copy of the first."""
    with ServeHost(max_live_engines=2, engine_kwargs=CPU,
                   batcher_kwargs={"mixed_dates": True, "coalesce_blocks": True}) as host:
        host.add_tenant("a", policies["mse"])
        host.add_tenant("b", policies["dual"], max_pending=50)
        host.add_tenant("c", dataclasses.replace(policies["mse"]))
        yield host


def test_lru_eviction_to_warm_copies_and_builds_nothing(host_trio, policies):
    host = host_trio
    s1, _ = _rows(16, 1, 2, seed=8)
    s3, p3 = _rows(16, 3, 2, seed=8)
    first = host.evaluate("a", 2, s1)
    ptr = host._tenants["a"].engine._p1["w0"].data_ptr()
    host.evaluate("b", 2, s3, p3)
    host.evaluate("c", 2, s1)  # over the cap: "a" (least recently used) goes warm
    st = host.stats()
    assert (st["a"]["live"], st["a"]["tier"]) == (False, "warm")
    assert host.tiers.counts() == {"hot": 2, "warm": 1, "cold": 0}
    builds = dict(cuda_build.BUILD_STATS)
    again = host.evaluate("a", 2, s1)
    t = host._tenants["a"]
    assert _bits(again, first) and t.activations == 2
    assert t.engine._p1["w0"].data_ptr() == ptr  # the params never left the device
    assert cuda_build.BUILD_STATS == builds
    assert host.stats()["b"]["tier"] == "warm"
    # quotas: the block's tail past max_pending sheds as quota rows
    s, p = _rows(80, 3, 2, seed=9)
    blk = host.submit_block("b", 0, s, p).result(timeout=30)
    assert np.array_equal(blk.status, np.r_[np.full(50, SERVED), np.full(30, SHED_QUOTA)])
    assert _bits((blk.phi[:50],), (_engine(policies["dual"]).evaluate(0, s[:50], p[:50])[0],))
    slo = host.slo_report(SloPolicy(latency_slo_ms=60_000.0))
    assert set(slo) == {"a", "b", "c"} and not any(v["burning"] for v in slo.values())


def test_quota_sheds_per_request_submits(policies):
    with ServeHost(engine_kwargs=CPU) as host:
        host.add_tenant("q", policies["mse"], max_pending=1)
        s, _ = _rows(3, 1, 2)
        t, batcher = host._claim_batcher("q")
        host._release_claim(t)
        with batcher._cv:  # the first request stays pending while the second arrives
            f1 = host.submit("q", 0, s)
            f2 = host.submit("q", 0, s)
        r2 = f2.result(timeout=30)
        assert isinstance(r2, Rejection) and r2.reason == "quota"
        assert not is_rejection(f1.result(timeout=30))


def test_canary_promotes_rejects_and_gates_tiers(policies, tmp_path):
    chain = tmp_path / "promotions.jsonl"
    spec = quality.ValidationSpec(kind="gbm", n_steps=8, rebalance_every=2, n_paths=256,
                                  replicates=2)
    pol = dataclasses.replace(policies["mse"], validation=spec)
    s, _ = _rows(8, 1, 2, seed=12)
    with ServeHost(engine_kwargs=CPU, promotion_chain=chain) as host:
        host.add_tenant("t", pol)
        before = host.evaluate("t", 1, s)
        out = host.reload_tenant("t")  # the same bundle: the probe bits hold
        assert out["swapped"] and out["version"] == 2
        assert _bits(host.evaluate("t", 1, s), before)
        with faults(FaultPlan(corrupt_reload=1)) as inj, pytest.warns(UserWarning):
            with pytest.raises(CanaryRejected, match="probe bits diverged"):
                host.reload_tenant("t")
        assert inj.log and inj.log[0][0] == "serve/bundle_reload"
        assert _bits(host.evaluate("t", 1, s), before)  # the incumbent's bits untouched
        assert host.stats()["t"]["version"] == 2
        with pytest.raises(ValueError, match="changes the serving tier"):
            host.reload_tenant("t", precision="bf16")
        out = host.reload_tenant("t", require_same_bits=False, quality_band=0.05,
                                 precision="bf16")
        assert out["precision"] == "bf16" and abs(out["quality"]["regression"]) < 0.05
        assert host._tenants["t"].engine.precision.tier == "bf16"
        # a retrained candidate that over-hedges (a constant phi of 5 against
        # the incumbent's 0.6) regresses past the band: rejected at the
        # quality stage, the incumbent untouched
        def const(phi):
            p1 = {k: v * 0.0 for k, v in pol.backward.params1_by_date.items()}
            p1["b2"][:, 0] = phi
            return dataclasses.replace(pol, backward=dataclasses.replace(
                pol.backward, params1_by_date=p1))
        host.add_tenant("g", const(0.6))
        good = host.evaluate("g", 0, s)
        with pytest.warns(UserWarning, match="REJECTED"):
            with pytest.raises(CanaryRejected, match="hedge-error regression"):
                host.reload_tenant("g", const(5.0), require_same_bits=False, quality_band=0.05)
        assert _bits(host.evaluate("g", 0, s), good) and np.all(good[0] == np.float32(0.6))
    verdicts = read_chain(chain)
    assert [v["action"] for v in verdicts] == ["promote", "reject", "promote", "reject"]
    assert chain_verify(chain)["ok"]


def test_export_bundle_round_trip_with_baseline(tmp_path):
    sim = SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2)
    train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=3,
                        gn_iters_warm=2)
    res = european_hedge(EuropeanConfig(), sim, train, device="cpu", export_dir=tmp_path / "b")
    pol = load_bundle(tmp_path / "b")
    assert pol.fingerprint.startswith("orp-policy-v1 model=HedgeMLP(n_features=1")
    assert pol.feature_sketch == res.feature_sketch and pol.validation == res.validation
    assert pol.validation.n_dates == 4 and pol.validation.n_paths == 256
    assert pol.hedge_error_baseline == pytest.approx(res.report.cv_std / 100.0, rel=1e-12)
    s, _ = _rows(33, 1, 2, seed=13)
    assert _bits(_engine(pol).evaluate(2, s), _engine(res).evaluate(2, s))
    # a re-export of the same config overwrites; another config refuses
    export_bundle(res, tmp_path / "b")
    other = dataclasses.replace(res, cost_of_capital=0.5)
    with pytest.raises(ValueError, match="belongs to a different run config"):
        export_bundle(other, tmp_path / "b")
    # a committed bundle (no fingerprint file, no baseline) loads as before
    ns = load_bundle(NORTH_STAR_POLICY)
    assert (ns.fingerprint, ns.feature_sketch, ns.validation, ns.hedge_error_baseline) == \
        (None, None, None, None)


@pytest.mark.parametrize("kind", ["gbm", "heston-qe"])
def test_quality_record_against_the_jax_package(kind):
    nf = 1 if kind == "gbm" else 2
    jpol, tpol = _pair(n_features=nf, n_dates=4, seed=21)
    spec = quality.ValidationSpec(kind=kind, n_steps=8, rebalance_every=2, n_paths=256,
                                  replicates=3)
    got = quality.evaluate_quality(tpol, spec, device="cpu")
    again = quality.evaluate_quality(engine=_engine(tpol), spec=spec)
    assert got == again  # deterministic: bitwise the same record
    want = jquality.evaluate_quality(engine=JHedgeEngine(jpol),
                                     spec=jquality.ValidationSpec(**spec.to_meta()))
    assert quality.validate_quality_record(want) == [] == jquality.validate_quality_record(got)
    assert {k: v for k, v in got.items() if not isinstance(v, (dict, list, float))} == \
        {k: v for k, v in want.items() if not isinstance(v, (dict, list, float))}

    def nums(r):
        return np.array([r["hedge_error"]["mean"], r["hedge_error"]["ci95"],
                         r["unhedged"]["mean"], *[x["mean"] for x in r["per_date"]]])
    np.testing.assert_allclose(nums(got), nums(want), rtol=1e-5)
    reg = obs.Registry()
    quality.publish_quality(got, reg, tenant="t")
    assert reg.gauge("quality/hedge_error", {"tenant": "t", "date": "all"}).value == \
        got["hedge_error"]["mean"]


def test_wire_frames_through_the_host(policies):
    """A client's request frame -> decode -> ``submit_block`` -> reply frame ->
    decode: the served rows bitwise the tenant's engine."""
    s, p = _rows(20, 3, 2, seed=14)
    with ServeHost(engine_kwargs=CPU) as host:
        host.add_tenant("desk", policies["dual"])
        frame = wire.encode_request("desk", 3, s, p, seq=5, trace=obs.new_trace())
        req = wire.decode_request(frame)
        res = host.submit_block(req["tenant"], req["date_idx"], req["states"], req["prices"],
                                req["deadlines"], trace=req["trace"]).result(timeout=30)
        back = wire.decode_reply(wire.encode_reply(res, date_idx=3, seq=req["seq"],
                                                   timing=(req["trace"][0], *res.timing)))
    assert back.timing is not None and back.n_served == 20
    assert _bits((back.phi, back.psi, back.value), _engine(policies["dual"]).evaluate(3, s, p))


def test_batcher_closed_and_slim_future():
    eng = _engine(_pair(n_dates=2)[1])
    mb = MicroBatcher(eng)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(0, np.ones((1, 1), np.float32))
    from orp_tpu_torch.serve import SlimFuture

    f, seen = SlimFuture(), []
    f.add_done_callback(lambda x: seen.append(x.result()))
    threading.Timer(0.01, lambda: f.set_result(7)).start()
    assert f.result(timeout=5) == 7 and seen == [7]
    with pytest.raises(RuntimeError, match="already resolved"):
        f.set_result(8)
    g = SlimFuture()
    with pytest.raises(TimeoutError):
        g.result(timeout=0.01)
    g.set_exception(ValueError("x"))
    assert isinstance(g.exception(), ValueError)
    t0 = time.perf_counter()
    with pytest.raises(ValueError):
        g.result()
    assert time.perf_counter() - t0 < 1.0
