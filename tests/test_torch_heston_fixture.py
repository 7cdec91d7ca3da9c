"""The committed JAX Heston walk (``orp_tpu_torch/_data/heston_walk``) against the JAX package and the port on the CPU.

The fixture against what the JAX package computes today, its bundle, the
port's ``heston_hedge`` at the fixture's 4,096 paths x 364 steps from the
stored JAX initial params on each engine (inside the walk's band), and the
stored walk's per-date params replayed by ``heston_oos``.
``tests/test_torch_fixture.py`` makes the fixture (``--write heston_walk``)
and says why the band; these tests were there, and a file of their own lets
``--dist loadfile`` run them beside the rest of the fixture tests.
"""

import json

import numpy as np
import pytest
import torch

from orp_tpu_torch import HESTON_WALK
from orp_tpu_torch import api as tapi
from orp_tpu_torch.serve import load_bundle
from test_torch_fixture import (HESTON_N, REPORT_KEYS, assert_heston_band, heston_configs,
                                heston_jax_run, heston_report, load_heston_init)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: their tensors are a few
    thousand rows, and under the suite's parallel workers every worker's
    default pool (one thread a core) oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_heston_fixture_matches_jax_today():
    """The JAX package, run today from the stored initial params, reproduces
    the stored scan-engine walk at ``rtol=1e-6`` (same programs, same
    backend). The stored Pallas-engine run (what the card is held to) lies
    inside the walk's band of it: the two JAX engines' paths agree to ~2e-6
    on S, and the trained trajectories part."""
    report = json.loads((HESTON_WALK / "reference.json").read_text())
    got = heston_report(heston_jax_run(load_heston_init(), "scan"))
    for k in (*REPORT_KEYS, "var_overall", "train_loss"):
        np.testing.assert_allclose(got[k], report["scan"][k], rtol=1e-6, err_msg=k)
    assert_heston_band(report, got)


def test_heston_fixture_bundle_and_provenance():
    policy = load_bundle(HESTON_WALK)
    meta = json.loads((HESTON_WALK / "bundle.json").read_text())
    assert policy.n_dates == 52 and policy.dual_mode == "mse_only"
    assert policy.model.n_features == 2 and policy.model.n_params() == 114
    assert meta["trained_with"]["n_paths"] == HESTON_N
    init = load_heston_init()
    assert sorted(init) == ["b0", "b1", "b2", "w0", "w1", "w2"] and init["w0"].shape == (2, 8)
    assert sum(p.stat().st_size for p in HESTON_WALK.iterdir()) < 1 << 20


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_port_heston_walk_matches_stored_report_on_cpu(engine):
    """The port's ``heston_hedge`` (the QE kernel's plain twin, or the scan
    engine, and the GN walk on the CPU) from the stored JAX initial params,
    against the stored JAX report of the same engine, inside the walk's band
    (measured: pallas 2.21bp / 10.93bp / 1.81%; scan 0.04bp / 0.03bp / 0.41%
    on v0_cv / v0_acv / v0). The first fitted date runs the same 30
    iterations from the same params: its loss at rtol 1e-3."""
    report = json.loads((HESTON_WALK / "reference.json").read_text())
    want = report if engine == "pallas" else report["scan"]
    h, sim, train = heston_configs()
    res = tapi.heston_hedge(
        tapi.HestonConfig(),
        tapi.SimConfig(n_paths=sim.n_paths, T=sim.T, dt=sim.dt,
                       rebalance_every=sim.rebalance_every, engine=engine),
        tapi.TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"),
        warm_start=(load_heston_init(), None), device="cpu")
    assert_heston_band({k: getattr(res.report, k) for k in REPORT_KEYS}, want)
    np.testing.assert_allclose(res.report.train_loss[-1], want["train_loss"][-1], rtol=1e-3)
    np.testing.assert_allclose(res.report.v0_plain, want["v0_plain"], rtol=1e-5)
    assert res.backward.values.shape == (HESTON_N, 53)


def test_port_replays_stored_heston_walk_on_cpu():
    """The stored JAX walk's own per-date params replayed by the port's
    ``heston_oos`` on the same in-sample paths (the QE kernel's plain twin):
    no training, so no chaos, and the report lands where the JAX walk's did.
    Tolerances as for the north star's replay: prices within 0.05bp, report
    fields at ``rtol=1e-4`` (measured 0.0009bp / 0.013bp on v0_cv / v0_acv,
    2e-6 on v0, 4.4e-5 on acv_std). ``chip_smoke.py`` holds the card's
    replay to the same report."""
    report = json.loads((HESTON_WALK / "reference.json").read_text())
    policy = load_bundle(HESTON_WALK)
    _, sim, _ = heston_configs()
    res = tapi.heston_oos(
        policy, tapi.HestonConfig(),
        tapi.SimConfig(n_paths=sim.n_paths, T=sim.T, dt=sim.dt,
                       rebalance_every=sim.rebalance_every, seed_fund=policy.sim_seed,
                       engine="pallas"),
        tapi.TrainConfig(dual_mode="mse_only"), allow_in_sample=True, device="cpu")
    for k in ("v0_cv", "v0_acv"):
        assert abs(getattr(res.report, k) - report[k]) / report[k] * 1e4 <= 0.05, k
    for k in ("v0", "phi0", "psi0", "v0_plain", "cv_std", "acv_std"):
        np.testing.assert_allclose(getattr(res.report, k), report[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(res.report.var_overall, report["var_overall"], rtol=1e-4)
