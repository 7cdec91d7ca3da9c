"""``serve/bench.serve_bench`` and the phases it drives, against the JAX
package's ``orp_tpu/serve/bench.py`` on the CPU: the record and sweep keys at
the same small arguments (no mesh, no degrade, no AOT bundle) less the named
JAX-only and port-only keys; the histogram and request-stream helpers equal;
the overhead lanes' records; the ragged, density and precision phases; the
warm-up contract; the record writer's required path; the ledger rows under
both packages' schema; the pilot refusal."""

import json

import numpy as np
import pytest
import torch

from orp_tpu.obs import perf as jperf
from orp_tpu.serve import bench as jbench
from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu_torch.obs import perf
from orp_tpu_torch.serve import bench

from test_torch_serve import _pair

#: the JAX package's record key with no counterpart in the port (the port
#: compiles no XLA programs)
JAX_ONLY = {"xla_compiles"}
#: the port's counterparts of it: nvcc runs and CUDA-graph captures, since
#: the engine was built and inside the measured window
PORT_ONLY = {"nvcc_runs", "graph_captures", "nvcc_runs_after_warmup",
             "graph_captures_after_warmup"}
SMALL = dict(n_requests=8, batch_sizes=(1, 7), batcher_requests=8, sweep_concurrency=(1, 2),
             sweep_requests=8, sweep_max_batch=8, repeats=2, seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _pair(n_dates=4, seed=13)


@pytest.fixture(scope="module")
def small_policy():
    """A policy trained by the port at the reference's precision-test
    configuration, whose holdings sit inside ``PRECISION_BANDS``."""
    return european_hedge(EuropeanConfig(),
                          SimConfig(n_paths=512, T=1.0, dt=1 / 8, rebalance_every=2),
                          TrainConfig(dual_mode="mse_only", epochs_first=20, epochs_warm=10),
                          device="cpu")


def test_record_keys_equal_the_reference(pair):
    jpol, pol = pair
    ours = bench.serve_bench(pol, prewarm=True, device="cpu", **SMALL)
    theirs = jbench.serve_bench(jpol, prewarm=True, **SMALL)
    assert set(ours) - PORT_ONLY == set(theirs) - JAX_ONLY
    assert PORT_ONLY <= set(ours) and not JAX_ONLY & set(ours)
    for a, b in zip(ours["sweep"], theirs["sweep"]):
        assert set(a) == set(b) and a["concurrency"] == b["concurrency"]
    assert set(ours["roofline"]) == set(theirs["roofline"])
    assert set(ours["device_seconds"]) == set(theirs["device_seconds"])
    for key in ("n_requests", "batch_sizes", "n_dates", "cache_buckets", "prewarm",
                "batcher_requests", "mesh_devices", "cache_misses_after_warmup",
                "aot_buckets", "aot_hits", "platform", "metric", "unit"):
        assert ours[key] == theirs[key], key
    assert ours["nvcc_runs_after_warmup"] == ours["graph_captures_after_warmup"] == 0
    assert ours["roofline"]["bucket"] == 8 and ours["roofline"]["frac_peak_flops"] > 0


def test_helpers_equal_the_reference():
    walls = list(np.random.default_rng(0).exponential(3.0, 97))
    assert bench._lat_hist(walls) == jbench._lat_hist(walls)
    assert bench._lat_hist([]) == jbench._lat_hist([]) == {"count": 0}
    ours = list(bench._request_stream(np.random.default_rng(5), 7, (1, 7, 64), 3, 2))
    theirs = list(jbench._request_stream(np.random.default_rng(5), 7, (1, 7, 64), 3, 2))
    for (d1, f1), (d2, f2) in zip(ours, theirs, strict=True):
        assert d1 == d2 and np.array_equal(f1, f2)
    feats = np.ones((64, 2), np.float32)
    assert set(bench._drift_overhead(feats, 100.0)) == set(jbench._drift_overhead(feats, 100.0))
    assert set(bench._profile_overhead(100.0, block=64)) == \
        set(jbench._profile_overhead(100.0, block=64))
    assert bench.STICKY_PHASES == jbench.STICKY_PHASES


def test_write_bench_record_needs_a_path_and_ledger_rows_validate(pair, tmp_path):
    _, pol = pair
    rec = bench.serve_bench(pol, device="cpu", degrade_at=2, degrade_requests=6, **SMALL)
    with pytest.raises(TypeError):
        bench.write_bench_record(rec)  # no default BENCH_serve.json
    out = tmp_path / "bench.json"
    bench.write_bench_record(rec, out)
    assert json.loads(out.read_text())["degrade"]["failed_during_window"] == 0
    assert rec["mttr_ms"] == rec["degrade"]["mttr_ms"] > 0
    rows = bench.ledger_records(rec)
    assert {r["phase"] for r in rows} == {"sweep_requests_per_s"}
    for r in rows:
        assert perf.validate_perf_record(r) == [] and jperf.validate_perf_record(r) == []
    # a re-run carries the blocks it did not measure
    again = bench.serve_bench(pol, device="cpu", previous=rec, **SMALL)
    assert again["degrade"] == rec["degrade"] and again["carried_forward"] == ["degrade"]
    assert again["mttr_ms"] == rec["mttr_ms"]


def test_pilot_refuses_naming_its_roadmap_item(pair, monkeypatch):
    """``pilot=True`` runs the closed-loop drill now that ``pilot/`` is ported
    (``tests/test_torch_pilot.py`` runs it whole); the record is refused,
    naming the broken contract, when the drill's contract fields fail: a
    lost row here."""
    calls = []

    def drill(*, quick, seed, device):
        calls.append((quick, seed, device))
        return {"rows_lost": 1, "chain": {"ok": True}, "reject_left_incumbent": True,
                "resume": {"bits_equal": True}, "drift_trips": 1, "time_to_promote_s": 1.0,
                "cycles": [{"outcome": "rejected"}, {"outcome": "promoted"}]}

    monkeypatch.setattr(bench, "_pilot_phase", drill)
    with pytest.raises(RuntimeError, match="pilot drill contract violated: rows_lost=1"):
        bench.serve_bench(pair[1], pilot=True, pilot_quick=True, device="cpu", **SMALL)
    assert calls == [(True, SMALL["seed"], "cpu")]


def test_precision_matrix_phases(small_policy):
    rec = bench.serve_bench(small_policy, device="cpu", precision=True, precision_rows=64,
                            megakernel_rows=64, ragged_counts=(40, 9), **SMALL)
    assert {lv["tier"] for lv in rec["precision_tiers"]["tiers"]} == {"f32", "bf16", "int8"}
    for lv in rec["precision_tiers"]["tiers"]:
        assert lv["roofline"]["frac_peak_flops"] > 0
    assert set(rec["precision_fraction_of_peak"]) == {"f32", "bf16", "int8"}
    assert rec["megakernel_speedup"] > 0 and rec["ragged"]["bitwise_equal"]
    assert rec["pad_waste_saved_rows"] >= 0
    phases = {r["phase"] for r in bench.ledger_records(rec)}
    assert {"precision_rows_per_s", "megakernel_on_rows_per_s", "megakernel_off_rows_per_s",
            "ragged_ragged_rows_per_s", "ragged_pow2_rows_per_s"} <= phases


def test_density_phase(pair):
    _, pol = pair
    dn = bench._density_phase(pol, tenants=6, rows=4, max_live=2, repeats=2, seed=0,
                              budget_ms=10_000.0, device="cpu")
    assert dn["tenants"] == 6 and dn["dedup_ratio"] > 1
    assert dn["warm_xla_compiles"] == 0 and dn["tenants_within_budget"] == 6
    assert dn["activation_ms"]["cold"]["count"] == 6 and "warm_activation_ms" in dn
    assert [lv["tenants"] for lv in dn["levels"]] == [1, 2, 6]


def test_mesh_sweep_runs_one_rank_and_refuses_more_than_the_group(pair):
    _, pol = pair
    [row] = bench._mesh_sweep_phase(pol, (1,), rows=64, repeats=2, seed=0, device="cpu")
    assert row["n_devices"] == 1 and row["bitwise_equal_to_first"] and row["rows"] == 64
    with pytest.raises(ValueError, match="more ranks than the current group"):
        bench._mesh_sweep_phase(pol, (1, 2), rows=64, repeats=1, seed=0, device="cpu")
