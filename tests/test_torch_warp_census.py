"""``tools/torch_warp_census.py`` against a direct count on the same paths.

The census runs the plain pension and QE-M steps with instrumented draws and
thinning; here the same quantities are counted straight from
``pension_plain`` / ``heston_qe_plain`` stored at every step and from the
Sobol uniforms, in numpy, at 256 paths (8 warps of 32 consecutive paths)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from orp_tpu_torch.qmc import fused_mf
from orp_tpu_torch.qmc.sobol import sobol_uniform
from orp_tpu_torch.sde.kernels import _INVERSION_K, _INVERSION_MEAN_MAX

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_PATHS, WARP = 256, 32
PENSION_STEPS, HESTON_STEPS = 40, 28


def _tool():
    spec = importlib.util.spec_from_file_location("torch_warp_census",
                                                  ROOT / "tools" / "torch_warp_census.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def census():
    return _tool()


def _uniforms(n_steps: int, n_factors: int, seed: int) -> np.ndarray:
    """``(n_paths, n_steps, n_factors)`` scrambled Sobol uniforms of the paths."""
    dims = torch.arange(n_steps * n_factors)
    u = sobol_uniform(torch.arange(N_PATHS), dims, seed).numpy()
    return u.reshape(N_PATHS, n_steps, n_factors)


def _mixed_share(tail: np.ndarray) -> float:
    """Share of (warp, step) draws whose 32 lanes hold both values of ``tail``."""
    w = tail.reshape(N_PATHS // WARP, WARP, -1)
    return float((w.any(1) & ~w.all(1)).mean())


def _tail(u: np.ndarray) -> np.ndarray:
    return np.abs(u - np.float32(0.5)) > np.float32(0.425)


def test_pension_census_matches_a_direct_count(census):
    got = census.pension_census(N_PATHS, PENSION_STEPS, torch.device("cpu"))
    dt = 10.0 / PENSION_STEPS
    out = fused_mf.pension_plain(N_PATHS, PENSION_STEPS, dt=dt, seed=1234, store_every=1,
                                 binomial_mode="inversion", **census.PENSION)
    pop, lam = out["N"][:, :-1], out["lam"][:, 1:]
    walking = (pop * (1.0 - torch.exp(-lam * dt)) <= _INVERSION_MEAN_MAX).numpy()
    deaths = (pop - out["N"][:, 1:]).numpy().astype(np.float64)
    trips = np.where(walking, deaths, 0.0)
    sat = walking & (deaths == _INVERSION_K)
    w = trips.reshape(N_PATHS // WARP, WARP, PENSION_STEPS)
    w_rest = np.where(sat, 0.0, trips).reshape(w.shape)
    assert got["walk_trips_per_lane_step"] == pytest.approx(trips.mean(), rel=1e-12)
    assert got["walk_trips_per_warp_step"] == pytest.approx(w.max(1).mean(), rel=1e-12)
    assert got["walk_trips_per_warp_step_from_saturating_lanes"] == pytest.approx(
        (w.max(1) - w_rest.max(1)).mean(), abs=1e-12)
    assert got["saturating_lane_steps"] == int(sat.sum())
    assert got["clt_lane_steps"] == int((~walking).sum()) > 0
    # the stuck exit only shortens saturating lanes' walks
    exit_ = got["with_stuck_exit"]
    assert exit_["walk_trips_per_warp_step"] <= got["walk_trips_per_warp_step"]
    if not sat.any():
        assert exit_["walk_trips_per_lane_step"] == got["walk_trips_per_lane_step"]
    assert got["mean_N_T"] == pytest.approx(float(out["N"][:, -1].double().mean()), rel=1e-12)
    # the fund's and the mortality's AS241: every warp of 32 consecutive Sobol
    # points holds lanes in both branches on every draw (one point per 1/32 of
    # (0, 1) in every dimension, and the tail covers 0.15 of it)
    u = _uniforms(PENSION_STEPS, 4, 1234)
    for f in (0, 1):
        assert _mixed_share(_tail(u[:, :, f])) == 1.0
        assert got["as241_warp_draws_mixed_by_factor"][str(f)] == 1.0


def _direct_stuck_trip(u, n, q, pmf0) -> np.ndarray:
    """The first trip ``k`` of the f32 CDF walk whose ``pmf_k`` leaves the cdf
    unchanged while ``(n-k)/(k+1) q/(1-q) <= 1/2``; 128 where there is none."""
    one, ratio = np.float32(1.0), q / np.maximum(np.float32(1.0) - q, np.float32(1e-30))
    cdf = pmf = pmf0
    at = np.full(n.shape, float(_INVERSION_K))
    found = np.zeros(n.shape, dtype=bool)
    for k in range(1, _INVERSION_K + 1):
        pmf = np.maximum(pmf * (n - np.float32(k - 1)) / np.float32(k) * ratio, np.float32(0))
        moved = cdf + pmf
        now = (moved == cdf) & ((n - np.float32(k)) / np.float32(k + 1) * ratio <= 0.5 * one)
        at[now & ~found] = k
        found |= now
        cdf = moved
    return at


def test_stuck_exit_trips_match_a_direct_count(census):
    """The census's trips with the stuck exit: a saturating lane (128 deaths)
    stops at its first stuck trip, counted here straight from the f32 walk, on
    the samplers' own f32 inputs with half the uniforms within 1e-3 of 1."""
    rng = np.random.default_rng(5)
    m = 20_000
    n = rng.integers(0, 12_001, m).astype(np.float32)
    lam = rng.uniform(1e-4, 0.2, m).astype(np.float32)
    dt = rng.choice(np.array([0.001, 0.01, 0.1, 0.25], np.float32), m)
    q = (np.float32(1.0) - np.exp(-lam * dt)).astype(np.float32)
    pmf0 = np.exp(-n * lam * dt).astype(np.float32)
    u = np.where(rng.random(m) < 0.5, 1.0 - 1e-3 * rng.random(m), rng.random(m))
    u = u.astype(np.float32)
    z = rng.standard_normal(m).astype(np.float32)
    deaths, trips, exit_trips, sat = (t.numpy() for t in census.walk_trips(
        *(torch.from_numpy(a) for a in (u, n, q, pmf0, z))))
    walking = n * q <= np.float32(_INVERSION_MEAN_MAX)
    np.testing.assert_array_equal(trips, np.where(walking, deaths, 0.0))
    np.testing.assert_array_equal(sat, walking & (deaths == _INVERSION_K))
    stuck = _direct_stuck_trip(u, n, q, pmf0)
    np.testing.assert_array_equal(exit_trips, np.where(sat, stuck, trips))
    assert sat.sum() > 100 and (stuck[sat] < _INVERSION_K).mean() > 0.5


def test_heston_census_matches_a_direct_count(census):
    got = census.heston_census(N_PATHS, HESTON_STEPS, torch.device("cpu"))
    dt = 1.0 / HESTON_STEPS
    out = fused_mf.heston_qe_plain(N_PATHS, HESTON_STEPS, s0=100.0, dt=dt, seed=4321,
                                   store_every=1, psi_c=census.PSI_C, **census.HESTON)
    from orp_tpu_torch.sde.kernels import qe_step_constants

    h = census.HESTON
    C = qe_step_constants(h["kappa"], h["theta"], h["xi"], h["rho"], dt)
    v = out["v"][:, :-1].numpy().astype(np.float64)
    m = h["theta"] + (v - h["theta"]) * C["E"]
    quad = (v * C["c1"] + C["c2"]) / np.maximum(m * m, 1e-12) <= census.PSI_C
    assert got["quadratic_share_of_lane_steps"] == pytest.approx(quad.mean(), rel=1e-12)
    assert got["warp_steps_with_both_qe_branches"] == _mixed_share(quad)
    u = _uniforms(HESTON_STEPS, 2, 4321)
    assert quad.all()  # dt = 1/28: every variance draw is quadratic, so both AS241s run
    assert _mixed_share(_tail(u[:, :, 0])) == _mixed_share(_tail(u[:, :, 1])) == 1.0
    assert got["as241_warp_draws_mixed"] == 1.0
    assert got["as241_warp_draws"] == 2 * HESTON_STEPS * N_PATHS // WARP


def test_census_counts_a_partial_warp():
    """A warp of fewer than 32 lanes counts only its live lanes."""
    tool = _tool()
    flag = torch.tensor([True] * 20 + [False] * 20)
    assert tool.mixed_warps(flag, torch.ones(40, dtype=torch.bool), 40) == (1, 2)
    assert tool.warp_groups(torch.arange(40.0), 40, 0.0).shape == (2, 32)
