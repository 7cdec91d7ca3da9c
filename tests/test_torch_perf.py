"""The port's perf plane (``orp_tpu_torch/obs/perf.py`` and devprof's profile
workloads) against the JAX package's (``orp_tpu/obs/perf.py``,
``orp_tpu/obs/devprof.py``): the same inputs give the same summaries, history
and gate verdicts; each package's records validate under the other's schema;
the roofline on the H100's row and the measured fallback; the ledger's torn
tail and the refusal of the checkout's root ledger; the gate driver on a CPU
engine; the north-star profile's stage record against the JAX package's."""

import math
import pathlib
import warnings

import numpy as np
import pytest
import torch

from orp_tpu.obs import devprof as jdevprof
from orp_tpu.obs import perf as jperf
from orp_tpu_torch import guard
from orp_tpu_torch.obs import devprof, perf
from orp_tpu_torch.serve.engine import HedgeEngine
from orp_tpu_torch.utils import flops

from test_torch_serve import _pair

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and under the suite's
    parallel workers every worker's default pool oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def policy():
    return _pair(n_dates=4, seed=3)[1]


@pytest.mark.parametrize("samples", [[1.0], [3.0, 1.0, 2.0], [0.5, 0.25, 0.125, 2.0, 8.0],
                                     list(np.linspace(1e-3, 2e-3, 17))])
def test_summarize_repeats_equals_the_reference(samples):
    assert perf.summarize_repeats(samples) == jperf.summarize_repeats(samples)
    with pytest.raises(ValueError, match="no samples"):
        perf.summarize_repeats([])


def _hist(medians, iqr=0.02, **kw):
    return [{"workload": "w", "phase": "p", "unit": "s", "direction": "lower", "repeats": 5,
             "median": m, "iqr": iqr, "fingerprint": {"f": 1}, **kw} for m in medians]


def test_matching_history_equals_the_reference():
    a = {**_hist([1.0])[0], "ts_unix": 1.0}
    b = {**a, "ts_unix": 2.0, "fingerprint": {"f": 2}}
    c = {**a, "ts_unix": 3.0, "phase": "q"}
    cur = {**a, "ts_unix": 4.0}
    recs = [a, b, c, cur]
    assert perf.matching_history(recs, cur) == jperf.matching_history(recs, cur) == [a]


FLAT = [1.00, 1.01, 0.99, 1.00, 1.02, 0.98]

#: the four verdicts of the reference's gate tests: noisy but flat, a true
#: regression (and the same move as an improvement), too few repeats (the
#: current run's, a thin history's, no history), zero IQR
GATE_CASES = {
    "noisy_flat": (_hist([1.03])[0], _hist(FLAT), "ok"),
    "regression": (_hist([1.20])[0], _hist(FLAT), "regression"),
    "improvement": (_hist([1.20], direction="higher")[0], _hist(FLAT, direction="higher"), "ok"),
    "few_repeats": ({**_hist([1.0])[0], "repeats": 2}, _hist(FLAT), "refused"),
    "thin_history": (_hist([1.0])[0], [{**h, "repeats": 1} for h in _hist(FLAT)], "refused"),
    "no_history": (_hist([1.0])[0], [], "no_history"),
    "zero_iqr_wobble": (_hist([1.02], iqr=0.0)[0], _hist([1.0] * 5, iqr=0.0), "ok"),
    "zero_iqr_move": (_hist([1.20], iqr=0.0)[0], _hist([1.0] * 5, iqr=0.0), "regression"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_verdicts_equal_the_reference(case):
    cur, hist, want = GATE_CASES[case]
    got = perf.gate(cur, hist)
    assert got == jperf.gate(cur, hist)
    assert got["verdict"] == want
    if want == "refused":
        assert "--repeats" in got["reason"]
    if want == "regression":
        assert "REAL regression" in got["reason"]


def test_records_validate_under_either_package():
    ours = perf.make_record("serve_engine", "evaluate", [1.0, 1.1, 0.9],
                            fingerprint_extra={"rows": 8})
    theirs = jperf.make_record("serve_engine", "evaluate", [1.0, 1.1, 0.9],
                               fingerprint_extra={"rows": 8})
    summarized = perf.make_record_from_summary("w", "p", repeats=3, median=2.0, iqr=0.1)
    for rec in (ours, theirs, summarized):
        assert perf.validate_perf_record(rec) == []
        assert jperf.validate_perf_record(rec) == []
    # the fingerprints never pool: the port's carries torch/cuda, no jax key
    assert "jax" not in ours["fingerprint"] and "torch" in ours["fingerprint"]
    assert ours["fingerprint"]["platform"] == "cpu" and ours["fingerprint"]["rows"] == 8
    assert ours["fingerprint"] != theirs["fingerprint"]
    bad = {**ours, "repeats": True}
    assert perf.validate_perf_record(bad) == jperf.validate_perf_record(bad) != []


def test_roofline_on_the_h100_row_by_hand():
    """3e9 FLOPs and 2e6 bytes in 0.5 s on the H100: 6e9 FLOP/s of the 67T f32
    ceiling, 4e6 B/s of HBM3's 3.35 TB/s; the bf16 tier prices at 989T and
    int8 at the f32 ceiling."""
    kind = "NVIDIA H100 80GB HBM3"
    out = perf.roofline(3e9, 2e6, 0.5, device_kind=kind)
    assert out["peak_source"] == "table"
    assert math.isclose(out["achieved_flops_per_s"], 6e9)
    assert math.isclose(out["frac_peak_flops"], 6e9 / 67e12, rel_tol=1e-6)
    assert math.isclose(out["achieved_bytes_per_s"], 4e6)
    assert math.isclose(out["frac_peak_bytes"], 4e6 / 3.35e12, rel_tol=1e-4)
    assert perf.peak_for(kind, "bf16")[0]["flops_per_s"] == pytest.approx(989e12)
    assert perf.peak_for(kind, "int8")[0]["flops_per_s"] == pytest.approx(67e12)
    # one source for the card's ceilings
    assert perf.PEAK_TABLE[kind]["flops_per_s"] == flops.PEAK_F32_H100
    assert perf.PEAK_TABLE[kind]["bytes_per_s"] == flops.HBM_BYTES_H100
    assert list(perf.PEAK_TABLE) == [kind]
    with pytest.raises(ValueError, match="wall_s"):
        perf.roofline(1.0, 1.0, 0.0)


def test_roofline_unknown_kind_falls_back_to_the_measured_peak():
    out = perf.roofline(1e9, 1e6, 0.1, device_kind="totally-new-chip")
    assert out["peak_source"] == "measured_matmul"
    assert out["peak_flops_per_s"] > 0 and out["achieved_flops_per_s"] == 1e10
    assert out["peak_bytes_per_s"] is None and out["frac_peak_bytes"] is None
    perf._PEAK_WARNED.discard(("weird-chip", "bf16"))
    with pytest.warns(UserWarning, match="no published bf16 peak"):
        ent, src = perf.peak_for("weird-chip", "bf16")
    assert src == "measured_matmul" and ent["bytes_per_s"] is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        perf.peak_for("weird-chip", "bf16")  # warned once
    perf._PEAK_WARNED.discard(("NVIDIA H100 80GB HBM3", "fp4"))
    with pytest.warns(UserWarning, match="not in TIER_PEAK_FACTOR"):
        ent, _ = perf.peak_for("NVIDIA H100 80GB HBM3", "fp4")
    assert ent["flops_per_s"] == 67e12
    # the port's process reads its own kind: the CPU here
    assert perf.roofline(1e9, None, 0.1)["peak_source"] == "measured_matmul"


def test_torn_tail_tolerated_healed_and_read_by_either_package(tmp_path):
    led = tmp_path / "led.jsonl"
    perf.ledger_append(led, perf.make_record("u", "p", [1.0, 1.0, 1.0]))
    with open(led, "a") as f:
        f.write('{"schema": "orp-perf-v1", "workl')  # a run killed mid-append
    for reader in (perf.read_ledger, jperf.read_ledger):
        recs, problems = reader(led)
        assert len(recs) == 1 and "torn tail" in problems[0]
    perf.ledger_append(led, perf.make_record("u", "p", [2.0, 2.0, 2.0]))
    for reader in (perf.read_ledger, jperf.read_ledger):
        recs, problems = reader(led)
        assert [r["median"] for r in recs] == [1.0, 2.0] and problems == []
    # a torn line anywhere but the tail is corruption
    led.write_text(led.read_text().replace('"schema"', '"sch', 1))
    with pytest.raises(ValueError, match="not the torn tail"):
        perf.read_ledger(led)
    with pytest.raises(ValueError, match="invalid perf record"):
        perf.ledger_append(tmp_path / "x.jsonl", {"schema": "orp-perf-v1"})


def test_root_ledger_is_refused(policy, tmp_path):
    root = ROOT / "PERF_LEDGER.jsonl"
    before = root.read_bytes() if root.exists() else None
    rec = perf.make_record("u", "p", [1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="--ledger a path of your own"):
        perf.ledger_append(root, rec)
    with pytest.raises(ValueError, match="--ledger a path of your own"):
        perf.gate_cli(ledger=str(root), bundle=policy, device="cpu")
    assert (root.read_bytes() if root.exists() else None) == before


def test_gate_cli_on_a_cpu_engine_green_twice_then_trips(policy, tmp_path):
    """The reference's gate pin: the same code twice is green, an engine slowed
    through the ``serve/execute`` fault site by several times the trip
    threshold of the history it measured trips a regression."""
    led = tmp_path / "led.jsonl"
    outs = [perf.gate_cli(ledger=led, bundle=policy, repeats=5, evals=6, rows=32,
                          device="cpu") for _ in range(2)]
    assert outs[0]["verdict"] == "no_history" and outs[1]["verdict"] == "ok"
    assert all(o["ok"] and o["appended"] for o in outs), [o["reason"] for o in outs]
    records, _ = perf.read_ledger(led)
    assert len(records) == 2
    meds = sorted(r["median"] for r in records)
    iqrs = sorted(r["iqr"] for r in records)
    scale = max(iqrs[-1], meds[-1] - meds[0])
    need_s = 4.0 * max(perf.GATE_K * scale, perf.GATE_REL_FLOOR * meds[-1])
    delay_s = max(0.02, need_s / 6)
    with guard.faults(guard.FaultPlan(delay={"serve/execute": (10_000, delay_s)})):
        slow = perf.gate_cli(ledger=led, bundle=policy, repeats=5, evals=6, rows=32,
                             device="cpu")
    assert slow["verdict"] == "regression" and not slow["ok"] and not slow["appended"]
    assert len(perf.read_ledger(led)[0]) == 2  # a regressed run never enters the history
    # the newest record gated against its own history, no measurement
    assert perf.gate_cli(ledger=led, workload="serve_engine")["verdict"] == "ok"
    with pytest.raises(ValueError, match="no ledger records match"):
        perf.gate_cli(ledger=led, workload="nothing")


def test_program_cost_feeds_the_roofline(policy):
    engine = HedgeEngine(policy, device="cpu")
    cost = engine.program_cost(16)
    # one forward of the 1-8-8-2 MLP: 2 * (8 + 64 + 16) FLOPs a row
    assert cost["bucket"] == 16 and cost["flops"] == 16 * 2 * (8 + 64 + 16)
    assert cost["bytes_accessed"] > 16 * 4
    out = perf.roofline(cost["flops"], cost["bytes_accessed"], 1e-3)
    assert out["achieved_flops_per_s"] == pytest.approx(cost["flops"] / 1e-3)


def test_profile_serve_on_a_cpu_engine(policy):
    out = devprof.profile_serve(policy, quick=True, device="cpu")
    assert out["workload"] == "serve" and out["platform"] == "cpu"
    assert out["buckets"]
    for st in out["buckets"].values():
        assert st["count"] > 0 and st["device_s_median"] >= 0
    rf = out["roofline"]
    assert rf is not None and "error" not in rf and rf["frac_peak_flops"] > 0


#: the JAX package's profile keys the port has no counterpart of: none at the
#: record and stage level
PROFILE_JAX_ONLY: set = set()


def test_profile_north_star_quick_keys_equal_the_reference(monkeypatch):
    """The same small arguments through both packages: the same record keys,
    stage names and stage keys, the port's compile bill (nvcc and captures)
    under the reference's ``compile_s``; every fraction of peak <= 1."""
    import jax

    ours = devprof.profile_north_star(6, quick=True, device="cpu")
    # the reference's profile enables its persistent compile cache at the
    # default directory: keep this process's cache where the harness put it
    cache = jax.config.jax_compilation_cache_dir
    if cache:
        monkeypatch.setenv("ORP_JAX_CACHE_DIR", str(cache))
    else:
        monkeypatch.setenv("ORP_TESTS_NO_COMPILE_CACHE", "1")
    theirs = jdevprof.profile_north_star(6, quick=True)
    assert set(ours) == set(theirs) - PROFILE_JAX_ONLY
    assert list(ours["stages"]) == list(theirs["stages"]) == ["sim", "prep", "adam_walk",
                                                             "gn_walk"]
    for name in ours["stages"]:
        assert set(ours["stages"][name]) == set(theirs["stages"][name])
        rl = ours["stages"][name].get("roofline")
        if rl is not None:
            assert set(rl) == set(theirs["stages"][name]["roofline"])
            assert rl["frac_peak_flops"] <= 1.0
    for key in ("n_paths", "n_dates", "quick", "workload", "platform"):
        assert ours[key] == theirs[key]
    assert ours["stages"]["sim"]["flops"] == theirs["stages"]["sim"]["flops"]


def test_profile_run_emits_the_record_and_refuses_a_serve_run_without_a_bundle():
    from orp_tpu_torch import obs
    from orp_tpu_torch.obs.sink import ListSink

    sink = ListSink()
    with obs.active(sink=sink):
        out = devprof.profile_run(n_log2=6, quick=True, device="cpu")
    assert out["workload"] == "north_star"
    assert any(e.get("name") == "profile" for e in sink.events)
    with pytest.raises(ValueError, match="needs bundle="):
        devprof.profile_run(workload="serve", quick=True, device="cpu")
