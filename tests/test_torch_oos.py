"""Port parity: out-of-sample replay, the report, the OLS-martingale price and
``european_oos`` end to end (``orp_tpu_torch/train/replay.py``, ``risk``,
``api``) against the JAX package.

Tolerances and why:
- ledgers from identical inputs: ``rtol=1e-5, atol=1e-6`` (f32 matmuls
  summed in another order);
- quantiles of identical ledgers: ``rtol=1e-6`` (same sort, same f32 rule);
- report fields end to end: ``rtol=1e-4`` (paths agree to ~3e-5, then f32
  reductions over paths run in another order);
- the OLS-martingale price within 0.05bp: a per-date ``eigh`` of a 6x6 Gram
  whose near-null directions are projected out at a relative threshold."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu import api as japi
from orp_tpu.risk.analytics import build_report as jbuild_report
from orp_tpu.risk.controls import martingale_ols_price as jmartingale_ols_price
from orp_tpu.parallel.quantiles import quantile as jquantile
from orp_tpu.train.backward import BackwardConfig as JBackwardConfig
from orp_tpu.train.backward import BackwardResult as JBackwardResult
from orp_tpu.train.replay import replay_walk as jreplay_walk
from orp_tpu_torch import api as tapi
from orp_tpu_torch.parallel import quantile
from orp_tpu_torch.risk import build_report, martingale_ols_price
from orp_tpu_torch.serve import policy_from_numpy
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import BackwardConfig, BackwardResult, replay_walk

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_SIM = japi.SimConfig(n_paths=512, T=1.0, dt=1 / 8, rebalance_every=2)  # 4 dates
REPORT_KEYS = ("v0", "phi0", "psi0", "v0_plain", "v0_cv", "cv_std", "acv_std")


@pytest.fixture(scope="module")
def trained():
    res = japi.european_hedge(japi.EuropeanConfig(), TRAIN_SIM,
                              japi.TrainConfig(dual_mode="mse_only", epochs_first=20,
                                               epochs_warm=10))
    model = HedgeMLP(n_features=1, constrain_self_financing=True)
    meta = {"model": model_meta(model), "times": np.asarray(res.times).tolist(),
            "adjustment_factor": 100.0, "dual_mode": "mse_only",
            "holdings_combine": "single", "cost_of_capital": 0.1,
            "sim_seed": res.sim_seed}
    p1 = {k: np.asarray(v, np.float32) for k, v in res.backward.params1_by_date.items()}
    return res, policy_from_numpy(meta, p1)


@pytest.fixture(scope="module")
def paths():
    s = np.asarray(japi.pipelines._simulate_euro_paths(
        japi.EuropeanConfig(), dataclasses.replace(TRAIN_SIM, n_paths=1024, seed_fund=77),
        None, japi.pipelines.TimeGrid(1.0, 8), "t"))
    return s.astype(np.float32)


def _replays(trained, paths):
    res, tpol = trained
    s = paths / 100.0
    b = np.exp(0.08 * np.asarray(res.times, np.float32)).astype(np.float32) / 100.0
    term = np.maximum(paths[:, -1] - 100.0, 0.0).astype(np.float32) / 100.0
    j = jreplay_walk(res.model, res.backward, jnp.asarray(s)[:, :, None], jnp.asarray(s),
                     jnp.asarray(b), jnp.asarray(term), JBackwardConfig(dual_mode="mse_only"))
    t = replay_walk(tpol.model, tpol.backward, torch.from_numpy(s)[:, :, None],
                    torch.from_numpy(s), torch.from_numpy(b), torch.from_numpy(term),
                    BackwardConfig(dual_mode="mse_only"))
    return j, t, term


def test_replay_ledgers_match_jax(trained, paths):
    j, t, _ = _replays(trained, paths)
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["sort", "histogram"])
def test_build_report_matches_jax_on_identical_ledgers(trained, paths, method):
    j, _, term = _replays(trained, paths)
    led = {k: np.asarray(getattr(j, k)) for k in ("values", "phi", "psi", "var_residuals")}
    metrics = dict(train_loss=np.zeros(4), train_mae=np.zeros(4), train_mape=np.zeros(4),
                   epochs_ran=np.zeros(4, np.int64))
    jres = JBackwardResult(**{k: jnp.asarray(v) for k, v in led.items()}, **metrics)
    tres = BackwardResult(**{k: torch.from_numpy(v.copy()) for k, v in led.items()}, **metrics)
    times = np.linspace(0, 1, 5).astype(np.float32)
    kw = dict(r=0.08, times=times, adjustment_factor=100.0, holdings_adjustment=1.0,
              quantile_method=method)
    want = jbuild_report(jres, terminal_payoff=jnp.asarray(term), **kw)
    got = build_report(tres, terminal_payoff=torch.from_numpy(term), **kw)
    for k in ("v0", "phi0", "psi0", "discounted_payoff"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-6, err_msg=k)
    for k in ("var_by_date", "var_overall"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got.fan.bands, want.fan.bands, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.fan.mean, want.fan.mean, rtol=1e-6)
    for k, v in want.residual_stats.items():
        np.testing.assert_allclose(got.residual_stats[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert got.var_qs == want.var_qs


def test_sort_quantile_beyond_torch_quantile_limit():
    """``torch.quantile`` refuses > 2^24 elements; the port's sort rule does not,
    and follows ``jnp.quantile``'s linear rule (here on a smaller input)."""
    x = np.random.default_rng(3).standard_normal(10_001).astype(np.float32)
    qs = (0.01, 0.5, 0.98, 0.99, 0.995)
    np.testing.assert_allclose(quantile(torch.from_numpy(x), qs).numpy(),
                               np.asarray(jquantile(jnp.asarray(x), qs)), rtol=1e-6)
    big = torch.zeros((1 << 24) + 1)
    big[-(1 << 17):] = 1.0  # the top ~0.8%
    assert quantile(big, (0.5, 0.995)).tolist() == [0.0, 1.0]
    with pytest.raises(ValueError, match="quantile method"):
        quantile(big[:4], 0.5, method="tdigest")


@pytest.mark.parametrize("with_phi", [True, False])
@pytest.mark.parametrize("n_assets", [1, 2])
def test_martingale_ols_price_matches_jax(trained, paths, with_phi, n_assets):
    rng = np.random.default_rng(n_assets)
    s = paths if n_assets == 1 else np.stack(
        [paths, paths * np.exp(0.01 * rng.standard_normal(paths.shape))], -1).astype(np.float32)
    payoff = np.maximum(s[:, -1].reshape(len(s), -1).mean(1) - 100.0, 0.0).astype(np.float32)
    phi = None
    if with_phi:
        phi = (0.5 + 0.1 * rng.standard_normal(s[:, :-1].shape)).astype(np.float32)
    times = np.linspace(0, 1, 5).astype(np.float32)
    jv, jstd = jmartingale_ols_price(jnp.asarray(s), jnp.asarray(payoff), 0.08, times,
                                     phi=None if phi is None else jnp.asarray(phi))
    tv, tstd = martingale_ols_price(torch.from_numpy(s), torch.from_numpy(payoff), 0.08, times,
                                    phi=None if phi is None else torch.from_numpy(phi))
    assert abs(tv - jv) / jv * 1e4 <= 0.05
    np.testing.assert_allclose(tstd, jstd, rtol=1e-4)


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_european_oos_end_to_end_matches_jax(trained, engine):
    res, tpol = trained
    jsim = japi.SimConfig(n_paths=2048, T=1.0, dt=1 / 8, rebalance_every=2, seed_fund=999,
                          engine=engine)
    want = japi.european_oos(res, japi.EuropeanConfig(), jsim,
                             japi.TrainConfig(dual_mode="mse_only"))
    got = tapi.european_oos(tpol, tapi.EuropeanConfig(),
                            tapi.SimConfig(n_paths=2048, T=1.0, dt=1 / 8, rebalance_every=2,
                                           seed_fund=999, engine=engine),
                            tapi.TrainConfig(dual_mode="mse_only"), device="cpu")
    for k in REPORT_KEYS:
        np.testing.assert_allclose(getattr(got.report, k), getattr(want.report, k),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.report.var_overall, want.report.var_overall, rtol=1e-4)
    np.testing.assert_allclose(got.report.var_by_date, want.report.var_by_date,
                               rtol=1e-4, atol=1e-5)
    assert abs(got.report.v0_acv - want.report.v0_acv) / want.report.v0_acv * 1e4 <= 0.05
    np.testing.assert_allclose(got.times, want.times, rtol=1e-6)
    assert got.backward.values.shape == (2048, 5) and got.sim_seed == 999


def test_european_oos_refusals(trained):
    _, tpol = trained
    sim = tapi.SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2, seed_fund=999)
    euro, train = tapi.EuropeanConfig(), tapi.TrainConfig(dual_mode="mse_only")
    with pytest.raises(ValueError, match="TRAINING seed"):
        tapi.european_oos(tpol, euro, dataclasses.replace(sim, seed_fund=tpol.sim_seed),
                          train, device="cpu")
    with pytest.raises(ValueError, match="dual_mode"):
        tapi.european_oos(tpol, euro, sim, tapi.TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        tapi.european_oos(tpol, euro, dataclasses.replace(sim, rebalance_every=1), train,
                          device="cpu")
    with pytest.raises(ValueError, match="quantile_method"):
        tapi.european_oos(tpol, euro, sim, train, quantile_method="exact", device="cpu")
    with pytest.raises(ValueError, match="Owen-scrambled float32"):
        tapi.european_oos(tpol, euro, dataclasses.replace(sim, engine="pallas",
                                                          scramble="shift"),
                          train, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tapi.SimConfig(engine="xla")
