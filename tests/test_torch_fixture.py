"""The committed JAX fixtures (``orp_tpu_torch/_data/north_star_policy``,
``orp_tpu_torch/_data/heston_walk`` and ``orp_tpu_torch/_data/pension_walk``).

The card's machine has no JAX, so the smoke run holds the card to outputs of
the JAX package stored in the repository. This file holds each fixture
against what the JAX package computes today, holds the port's CPU path
against the stored JAX outputs (the Heston walk's tests are in
``tests/test_torch_heston_fixture.py``, which imports the helpers here), and
is the fixtures' generator::

    python tests/test_torch_fixture.py --write [north_star | heston_walk | pension_walk]

(no name writes both).

The generator trains the north-star configuration at 65,536 paths with the
default Gauss-Newton settings (``european_hedge``), writes ``bundle.json`` +
``policy.npz``, then stores ``reference.npz`` (a 4,096-row request block with
the JAX ``HedgeEngine``'s ``(phi, psi, v)``) and ``reference.json`` (the JAX
``european_oos`` report at 4,096 fresh paths on the Pallas engine, and under
``"scan"`` the same report on the scan engine).

The Heston generator simulates 4,096 paths x 364 steps with the QE-M
scheme, draws the walk's initial params the way ``backward_induction`` does
(``model.init`` on the first split of ``key(seed)``, output bias at the mean
normalised payoff), and runs ``heston_hedge`` (Gauss-Newton, ``mse_only``)
from them with ``warm_start``: it stores ``init.npz``, the per-date params
as a bundle (``bundle.json`` + ``policy.npz``) and ``reference.json``, the
report of the Pallas-engine run and, under ``"scan"``, of the scan-engine
run from the same params.

The pension generator runs ``pension_hedge`` at 4,096 paths of the
reference's multi-step pension under the Gauss-Newton dual walk
(``tools/parity_runs.seeds3_gn_cfg(1234)``: ``shared`` mode, ``py`` combine,
60/30 iterations) on the Pallas engine with ``binomial_mode="inversion"``:
it stores the walk's initial params as JAX draws them (``init.npz``), the
per-date params as a bundle, and ``reference.json``: the report, under
``"oos"`` the ``pension_oos(..., allow_in_sample=True)`` replay of those
params on the same paths, and under ``"scan"`` the same walk on the scan
engine.

The in-suite recomputes run the scan engine: the Pallas interpreter takes
~25 s (GBM) and ~35 s (Heston) on a CPU for 4,096 paths x 364 steps, the
scan engine about one.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from orp_tpu import api as japi  # noqa: E402
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP  # noqa: E402
from orp_tpu.serve import HedgeEngine as JHedgeEngine  # noqa: E402
from orp_tpu.serve.bundle import PolicyBundle as JPolicyBundle  # noqa: E402
from orp_tpu.train.backward import BackwardResult as JBackwardResult  # noqa: E402
from orp_tpu_torch import HESTON_WALK, NORTH_STAR_POLICY, PENSION_WALK  # noqa: E402
from orp_tpu_torch import api as tapi  # noqa: E402
from orp_tpu_torch.serve import HedgeEngine, load_bundle, save_bundle  # noqa: E402
from orp_tpu_torch.serve.bundle import model_meta  # noqa: E402
from orp_tpu_torch.models.mlp import HedgeMLP  # noqa: E402

N_TRAIN = 1 << 16
N_OOS = 4096
N_BLOCK = 4096
OOS_SEED = 4321
BLOCK_SEED = 20261016
REPORT_KEYS = ("v0", "phi0", "psi0", "v0_plain", "v0_cv", "cv_std", "v0_acv", "acv_std")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: their tensors are a few
    thousand rows, and under the suite's parallel workers every worker's
    default pool (one thread a core) oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
HESTON_N = 4096
# The 4,096-path x 52-date f32 walk is chaotic: one-ulp changes of the paths
# flip Levenberg-Marquardt accept/reject steps and part the trajectory. Over
# 16 such runs (tools/torch_walk_spread.py, CPU) the largest gaps to the
# stored JAX report were 2.21bp (v0_cv), 13.76bp (v0_acv) and 1.81% (the
# network's v0); the two JAX engines part by 1.81bp, 12.67bp and 1.02%.
# The bands are about twice the largest gap measured.
HESTON_BAND_BP = {"v0_cv": 5.0, "v0_acv": 30.0}
HESTON_V0_RTOL = 5e-2


def _jax_policy(directory) -> JPolicyBundle:
    """The committed bundle as the JAX package's PolicyBundle (same numpy params)."""
    meta = json.loads((pathlib.Path(directory) / "bundle.json").read_text())
    with np.load(pathlib.Path(directory) / "policy.npz") as z:
        p1 = {k.split("/", 1)[1]: jnp.asarray(z[k], jnp.float32)
              for k in z.files if k.startswith("params1/")}
        metrics = {k: z[k] for k in ("train_loss", "train_mae", "train_mape", "epochs_ran")}
    m = meta["model"]
    model = JHedgeMLP(n_features=m["n_features"], hidden=tuple(m["hidden"]),
                      negative_slope=m["negative_slope"],
                      constrain_self_financing=m["constrain_self_financing"],
                      init_scale=m["init_scale"], dtype=jnp.float32,
                      n_hedge_assets=m["n_hedge_assets"])
    return JPolicyBundle(
        model=model, backward=JBackwardResult.from_policy_state(
            {"params1_by_date": p1, **metrics}),
        times=np.asarray(meta["times"]), adjustment_factor=meta["adjustment_factor"],
        dual_mode=meta["dual_mode"], holdings_combine=meta["holdings_combine"],
        cost_of_capital=meta["cost_of_capital"], sim_seed=meta["sim_seed"], fingerprint="")


def request_block(times, r: float = 0.08, sigma: float = 0.15, n: int = N_BLOCK):
    """Seeded rows over every date: ``dates``, states ``S/S0`` and prices
    ``(S/S0, B_t/S0)`` with ``S`` drawn from the risk-neutral lognormal at
    the date's time and ``B_t = exp(r t)``."""
    rng = np.random.default_rng(BLOCK_SEED)
    n_dates = len(times) - 1
    dates = rng.integers(0, n_dates, size=n).astype(np.int32)
    t = np.asarray(times, np.float64)[dates]
    s = np.exp((r - 0.5 * sigma**2) * t + sigma * np.sqrt(t) * rng.standard_normal(n))
    states = s.astype(np.float32)[:, None]
    prices = np.stack([states[:, 0], (np.exp(r * t) / 100.0).astype(np.float32)], axis=1)
    return dates, states, prices


def oos_configs():
    euro = japi.EuropeanConfig(constrain_self_financing=False)
    sim = japi.SimConfig(n_paths=N_OOS, T=1.0, dt=1 / 364, rebalance_every=7,
                         seed_fund=OOS_SEED, engine="pallas")
    return euro, sim, japi.TrainConfig(dual_mode="mse_only")


def jax_reference(directory, engine: str = "pallas"):
    """What the JAX package computes from the bundle in ``directory``: the
    engine's outputs on the request block and the ``european_oos`` report on
    the given path engine."""
    policy = _jax_policy(directory)
    dates, states, prices = request_block(policy.times)
    phi, psi, v = JHedgeEngine(policy, use_aot=False).evaluate_mixed_async(
        dates, states, prices).result()
    euro, sim, train = oos_configs()
    res = japi.european_oos(policy, euro, dataclasses.replace(sim, engine=engine), train)
    report = {k: float(getattr(res.report, k)) for k in REPORT_KEYS}
    report["var_overall"] = [float(x) for x in res.report.var_overall]
    block = {"dates": dates, "states": states, "prices": prices,
             "phi": np.asarray(phi), "psi": np.asarray(psi), "v": np.asarray(v)}
    return block, report


def write_fixture(directory=NORTH_STAR_POLICY) -> dict:
    """Train the north-star policy with the JAX package and store it with its outputs."""
    directory = pathlib.Path(directory)
    euro = japi.EuropeanConfig(constrain_self_financing=False)
    sim = japi.SimConfig(n_paths=N_TRAIN, T=1.0, dt=1 / 364, rebalance_every=7)
    train = japi.TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    t0 = time.perf_counter()
    res = japi.european_hedge(euro, sim, train)
    train_s = time.perf_counter() - t0
    state = res.backward.policy_state()
    model = HedgeMLP(n_features=1, hidden=tuple(res.model.hidden),
                     negative_slope=res.model.negative_slope,
                     constrain_self_financing=res.model.constrain_self_financing,
                     init_scale=res.model.init_scale)
    meta = {
        "model": model_meta(model),
        "times": np.asarray(res.times, np.float64).tolist(),
        "adjustment_factor": float(res.adjustment_factor),
        "dual_mode": res.dual_mode, "holdings_combine": res.holdings_combine,
        "cost_of_capital": float(res.cost_of_capital), "sim_seed": res.sim_seed,
        "trained_with": {"pipeline": "orp_tpu.api.european_hedge", "n_paths": N_TRAIN,
                         "optimizer": train.optimizer, "gn_iters_first": train.gn_iters_first,
                         "gn_iters_warm": train.gn_iters_warm, "T": sim.T, "dt": sim.dt,
                         "rebalance_every": sim.rebalance_every, "seed_fund": sim.seed_fund,
                         "train_seconds_cpu": round(train_s, 1),
                         "in_sample_v0_acv": float(res.report.v0_acv)},
    }
    params1 = {k: np.asarray(v, np.float32) for k, v in state["params1_by_date"].items()}
    metrics = {k: np.asarray(state[k]) for k in
               ("train_loss", "train_mae", "train_mape", "epochs_ran")}
    save_bundle(directory, meta, params1, None, metrics)
    block, report = jax_reference(directory)
    np.savez(directory / "reference.npz", **block)
    report["oos"] = {"n_paths": N_OOS, "seed_fund": OOS_SEED, "engine": "pallas"}
    report["scan"] = jax_reference(directory, engine="scan")[1]
    (directory / "reference.json").write_text(json.dumps(report, indent=1, sort_keys=True))
    return {"train_seconds_cpu": train_s, **report}


def heston_configs(engine: str = "pallas"):
    sim = japi.SimConfig(n_paths=HESTON_N, T=1.0, dt=1 / 364, rebalance_every=7,
                         engine=engine)
    return japi.HestonConfig(), sim, japi.TrainConfig(dual_mode="mse_only",
                                                      optimizer="gauss_newton")


def heston_jax_init(h, sim, train) -> dict:
    """The walk's cold-start params as ``backward_induction`` draws them."""
    grid = japi.pipelines.TimeGrid(sim.T, sim.n_steps)
    s = japi.pipelines._simulate_heston_paths(h, sim, None, grid, "fixture")["S"]
    e_payoff_n = float(jnp.mean(jnp.maximum(s[:, -1] - h.strike, 0.0))) / h.s0
    k1 = jax.random.split(jax.random.key(train.seed), 3)[0]
    params = JHedgeMLP(n_features=2, dtype=jnp.float32).init(k1, bias_init=(e_payoff_n, 0.0))
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def heston_report(res) -> dict:
    report = {k: float(getattr(res.report, k)) for k in REPORT_KEYS}
    report["var_overall"] = [float(x) for x in res.report.var_overall]
    report["train_loss"] = [float(x) for x in res.report.train_loss]
    report["epochs_ran"] = [int(x) for x in res.report.epochs_ran]
    return report


def heston_jax_run(init: dict, engine: str):
    h, sim, train = heston_configs(engine)
    return japi.heston_hedge(h, sim, train, warm_start=(init, None))


def write_heston_fixture(directory=HESTON_WALK) -> dict:
    """Run the JAX Heston walk from its cold-start params and store it."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    h, sim, train = heston_configs()
    init = heston_jax_init(h, sim, train)
    t0 = time.perf_counter()
    res = heston_jax_run(init, "pallas")
    train_s = time.perf_counter() - t0
    state = res.backward.policy_state()
    meta = {"model": model_meta(HedgeMLP(n_features=2)),
            "times": np.asarray(res.times, np.float64).tolist(),
            "adjustment_factor": float(res.adjustment_factor), "dual_mode": res.dual_mode,
            "holdings_combine": res.holdings_combine,
            "cost_of_capital": float(res.cost_of_capital), "sim_seed": res.sim_seed,
            "trained_with": {"pipeline": "orp_tpu.api.heston_hedge", "n_paths": HESTON_N,
                             "engine": "pallas", "scheme": "qe", "T": sim.T, "dt": sim.dt,
                             "rebalance_every": sim.rebalance_every,
                             "seed_fund": sim.seed_fund, "optimizer": train.optimizer,
                             "gn_iters_first": train.gn_iters_first,
                             "gn_iters_warm": train.gn_iters_warm,
                             "warm_start": "init.npz",
                             "train_seconds_cpu": round(train_s, 1)}}
    params1 = {k: np.asarray(v, np.float32) for k, v in state["params1_by_date"].items()}
    metrics = {k: np.asarray(state[k]) for k in
               ("train_loss", "train_mae", "train_mape", "epochs_ran")}
    save_bundle(directory, meta, params1, None, metrics)
    np.savez(directory / "init.npz", **init)
    report = heston_report(res)
    report["scan"] = heston_report(heston_jax_run(init, "scan"))
    (directory / "reference.json").write_text(json.dumps(report, indent=1, sort_keys=True))
    return {"train_seconds_cpu": train_s, **report}


def load_heston_init(directory=HESTON_WALK) -> dict:
    with np.load(pathlib.Path(directory) / "init.npz") as z:
        return {k: z[k] for k in z.files}


PENSION_N = 4096
PENSION_KEYS = ("v0", "phi0", "psi0", "discounted_payoff")
# The 4,096-path pension dual walk is chaotic like the Heston one; over 16
# runs with the fund's knots moved by one ulp (tools/torch_walk_spread.py
# --walk pension, CPU) the largest gaps to the stored JAX report, as shares
# of V0, were 0.40% (V0), 1.20% (phi0) and 1.48% (psi0). The bands are about
# twice the largest gap measured.
PENSION_BAND = {"v0": 0.01, "phi0": 0.03, "psi0": 0.03}


def pension_config(engine: str = "pallas"):
    """``seeds3_gn_cfg(1234)`` at 4,096 paths on ``engine`` with inversion thinning."""
    from tools.parity_runs import seeds3_gn_cfg

    cfg = seeds3_gn_cfg(1234)
    return dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, n_paths=PENSION_N, engine=engine, binomial_mode="inversion"))


def port_pension_config(cfg):
    """The JAX config's twin in the port's config classes."""
    t, s = cfg.train, cfg.sim
    return tapi.HedgeRunConfig(
        market=tapi.MarketConfig(**dataclasses.asdict(cfg.market)),
        actuarial=tapi.ActuarialConfig(**dataclasses.asdict(cfg.actuarial)),
        sim=tapi.SimConfig(n_paths=s.n_paths, T=s.T, dt=s.dt,
                           rebalance_every=s.rebalance_every, seed=s.seed,
                           seed_fund=s.seed_fund, engine=s.engine,
                           binomial_mode=s.binomial_mode),
        train=tapi.TrainConfig(dual_mode=t.dual_mode, holdings_combine=t.holdings_combine,
                               optimizer=t.optimizer, gn_iters_first=t.gn_iters_first,
                               gn_iters_warm=t.gn_iters_warm, seed=t.seed,
                               cost_of_capital=t.cost_of_capital, quantile=t.quantile))


def pension_jax_init(cfg) -> dict:
    """The walk's cold-start params as ``backward_induction`` draws them: the
    first split of ``key(seed)``, output bias ``(1 - otm, otm)``."""
    grid = japi.pipelines.TimeGrid(cfg.sim.T, cfg.sim.n_steps)
    y_t = japi.pipelines._simulate_pension_paths(cfg, None, grid, "fixture")["Y"][:, -1]
    otm = float(jnp.mean(y_t < cfg.market.y0))
    k1 = jax.random.split(jax.random.key(cfg.train.seed), 3)[0]
    params = JHedgeMLP(n_features=3, dtype=jnp.float32).init(k1, bias_init=(1.0 - otm, otm))
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def pension_report(report) -> dict:
    out = {k: float(getattr(report, k)) for k in PENSION_KEYS}
    out["var_overall"] = [float(x) for x in report.var_overall]
    out["train_loss"] = [float(x) for x in report.train_loss]
    out["epochs_ran"] = [int(x) for x in report.epochs_ran]
    return out


def write_pension_fixture(directory=PENSION_WALK) -> dict:
    """Run the JAX pension walk (Pallas engine, interpret mode) and store it."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    cfg = pension_config()
    init = pension_jax_init(cfg)
    t0 = time.perf_counter()
    res = japi.pension_hedge(cfg)
    train_s = time.perf_counter() - t0
    state = res.backward.policy_state()
    s, t = cfg.sim, cfg.train
    meta = {"model": model_meta(HedgeMLP(n_features=3)),
            "times": np.asarray(res.times, np.float64).tolist(),
            "adjustment_factor": float(res.adjustment_factor), "dual_mode": res.dual_mode,
            "holdings_combine": res.holdings_combine,
            "cost_of_capital": float(res.cost_of_capital), "sim_seed": res.sim_seed,
            "trained_with": {"pipeline": "orp_tpu.api.pension_hedge",
                             "config": "tools/parity_runs.seeds3_gn_cfg(1234)",
                             "n_paths": PENSION_N, "engine": s.engine,
                             "binomial_mode": s.binomial_mode, "T": s.T, "dt": s.dt,
                             "rebalance_every": s.rebalance_every, "seed": s.seed,
                             "optimizer": t.optimizer, "gn_iters_first": t.gn_iters_first,
                             "gn_iters_warm": t.gn_iters_warm, "initial_params": "init.npz",
                             "train_seconds_cpu": round(train_s, 1)}}
    params1 = {k: np.asarray(v, np.float32) for k, v in state["params1_by_date"].items()}
    metrics = {k: np.asarray(state[k]) for k in
               ("train_loss", "train_mae", "train_mape", "epochs_ran")}
    save_bundle(directory, meta, params1, None, metrics)
    np.savez(directory / "init.npz", **init)
    report = pension_report(res.report)
    oos = japi.pension_oos(res, cfg, allow_in_sample=True)
    report["oos"] = {k: float(getattr(oos.report, k)) for k in PENSION_KEYS}
    report["scan"] = pension_report(japi.pension_hedge(pension_config("scan")).report)
    (directory / "reference.json").write_text(json.dumps(report, indent=1, sort_keys=True))
    return {"train_seconds_cpu": train_s, **report}


@pytest.fixture(scope="module")
def stored():
    with np.load(NORTH_STAR_POLICY / "reference.npz") as z:
        block = {k: z[k] for k in z.files}
    report = json.loads((NORTH_STAR_POLICY / "reference.json").read_text())
    return block, report


def test_fixture_matches_jax_today(stored):
    """The JAX package, run today on the committed params, reproduces the
    stored outputs: the engine block bitwise and the scan-engine report at
    ``rtol=1e-6`` (same programs, same backend); the stored Pallas-engine
    report agrees with today's scan-engine report at ``rtol=1e-5`` and within
    0.05bp on ``v0_acv`` (the two JAX engines' paths agree to ~3e-5)."""
    block, report = stored
    got_block, got_scan = jax_reference(NORTH_STAR_POLICY, engine="scan")
    for k in ("dates", "states", "prices", "phi", "psi", "v"):
        np.testing.assert_array_equal(got_block[k], block[k], err_msg=k)
    for k in (*REPORT_KEYS, "var_overall"):
        np.testing.assert_allclose(got_scan[k], report["scan"][k], rtol=1e-6, err_msg=k)
    for k in (*REPORT_KEYS, "var_overall"):
        np.testing.assert_allclose(report[k], got_scan[k], rtol=1e-5, err_msg=k)
    assert abs(report["v0_acv"] - got_scan["v0_acv"]) / report["v0_acv"] * 1e4 <= 0.05


def test_fixture_bundle_shape_and_provenance():
    policy = load_bundle(NORTH_STAR_POLICY)
    assert policy.n_dates == 52 and policy.dual_mode == "mse_only"
    assert policy.model.n_outputs == 2 and policy.model.hidden == (8, 8)
    assert policy.backward.params1_by_date["w1"].shape == (52, 8, 8)
    meta = json.loads((NORTH_STAR_POLICY / "bundle.json").read_text())
    assert meta["trained_with"]["n_paths"] == N_TRAIN
    assert policy.sim_seed == meta["trained_with"]["seed_fund"] != OOS_SEED


def test_port_serves_fixture_block_on_cpu(stored):
    """The port's mixed-date path and its bucketed path reproduce the stored
    JAX engine outputs. Tolerance rtol 1e-5 / atol 1e-6: the same f32 ops,
    reduced in another order by another library."""
    block, _ = stored
    engine = HedgeEngine(load_bundle(NORTH_STAR_POLICY), device="cpu")
    phi, psi, v = engine.evaluate_mixed_async(
        block["dates"], block["states"], block["prices"]).result()
    for got, k in ((phi, "phi"), (psi, "psi"), (v, "v")):
        np.testing.assert_allclose(got, block[k], rtol=1e-5, atol=1e-6, err_msg=k)
    d = int(block["dates"][0])
    m = block["dates"] == d
    phi_d, psi_d, v_d = engine.evaluate(d, block["states"][m], block["prices"][m])
    np.testing.assert_allclose(phi_d, block["phi"][m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v_d, block["v"][m], rtol=1e-5, atol=1e-6)


def test_port_oos_matches_stored_report_on_cpu(stored):
    """The port's ``european_oos`` (plain path on the CPU) against the stored
    JAX report at 4,096 paths. Tolerances: ``rtol 1e-4`` on the report fields
    (f32 reductions in another order; paths agree to ~3e-5); the
    OLS-martingale price within 0.05bp (``eigh`` on 6x6 Grams per date)."""
    _, report = stored
    euro, sim, train = oos_configs()
    res = tapi.european_oos(
        load_bundle(NORTH_STAR_POLICY),
        tapi.EuropeanConfig(constrain_self_financing=euro.constrain_self_financing),
        tapi.SimConfig(n_paths=sim.n_paths, T=sim.T, dt=sim.dt,
                       rebalance_every=sim.rebalance_every, seed_fund=sim.seed_fund,
                       engine="pallas"),
        tapi.TrainConfig(dual_mode=train.dual_mode), device="cpu")
    for k in ("v0", "phi0", "v0_plain", "v0_cv", "cv_std", "acv_std"):
        np.testing.assert_allclose(getattr(res.report, k), report[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(res.report.psi0, report["psi0"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.report.var_overall, report["var_overall"], rtol=1e-4)
    assert abs(res.report.v0_acv - report["v0_acv"]) / report["v0_acv"] * 1e4 <= 0.05


def assert_heston_band(got: dict, want: dict) -> None:
    for k, bp in HESTON_BAND_BP.items():
        assert abs(got[k] - want[k]) / want[k] * 1e4 <= bp, (k, got[k], want[k])
    np.testing.assert_allclose(got["v0"], want["v0"], rtol=HESTON_V0_RTOL)


def load_pension_init(directory=PENSION_WALK) -> dict:
    with np.load(pathlib.Path(directory) / "init.npz") as z:
        return {k: z[k] for k in z.files}


def assert_pension_band(got: dict, want: dict) -> None:
    """V0 relative, phi0 and psi0 as shares of V0 (the split is weakly identified)."""
    for k, lim in PENSION_BAND.items():
        gap = (got[k] - want[k]) / want["v0"]
        assert abs(gap) <= lim, (k, got[k], want[k], gap)


def test_pension_fixture_matches_jax_today():
    """The JAX package, run today, reproduces the stored scan-engine walk at
    ``rtol=1e-6`` (same programs, same backend); the stored Pallas-engine run
    (what the card is held to) lies inside the walk's band of it."""
    report = json.loads((PENSION_WALK / "reference.json").read_text())
    got = pension_report(japi.pension_hedge(pension_config("scan")).report)
    for k in (*PENSION_KEYS, "var_overall", "train_loss"):
        np.testing.assert_allclose(got[k], report["scan"][k], rtol=1e-6, err_msg=k)
    assert_pension_band(report, got)


def test_pension_fixture_bundle_and_provenance():
    policy = load_bundle(PENSION_WALK)
    meta = json.loads((PENSION_WALK / "bundle.json").read_text())
    assert policy.n_dates == 40 and policy.dual_mode == "shared"
    assert policy.holdings_combine == "py" and policy.backward.params2_by_date is None
    assert policy.model.n_features == 3 and policy.model.n_params() == 122
    assert meta["trained_with"]["n_paths"] == PENSION_N
    assert meta["trained_with"]["binomial_mode"] == "inversion"
    init = load_pension_init()
    assert sorted(init) == ["b0", "b1", "b2", "w0", "w1", "w2"] and init["w0"].shape == (3, 8)
    assert sum(p.stat().st_size for p in PENSION_WALK.iterdir()) < 1 << 20


def test_port_pension_walk_matches_stored_report_on_cpu():
    """The port's pension dual walk (the K3c plain twin's paths, the GN walk on
    the CPU) from the stored JAX initial params, against the stored JAX report
    inside the walk's band. The discounted liability at rtol 1e-3: the paths
    agree to f32 roundoff except where one ulp of q = 1 - p moves the
    reference's saturating CDF walk to 128 deaths in a step (measured 1.4e-4)."""
    report = json.loads((PENSION_WALK / "reference.json").read_text())
    cfg = port_pension_config(pension_config())
    inp = tapi.pipelines.pension_inputs(cfg, "fixture", "cpu")
    res = tapi.pipelines.backward_induction(
        HedgeMLP(n_features=3), inp.features, inp.y, inp.b, inp.terminal,
        tapi.pipelines._backward_cfg(cfg.train), initial_params=(load_pension_init(), None))
    rep = tapi.pipelines._pension_result(cfg, inp, res, HedgeMLP(n_features=3), "sort").report
    assert_pension_band({k: getattr(rep, k) for k in PENSION_KEYS}, report)
    np.testing.assert_allclose(rep.discounted_payoff, report["discounted_payoff"], rtol=1e-3)
    assert res.values.shape == (PENSION_N, 41) and res.quantile_epochs_ran.shape == (40,)


def test_port_replays_stored_pension_walk_on_cpu():
    """The stored JAX walk's own per-date params replayed by the port's
    ``pension_oos`` on the same in-sample paths: no training, so no chaos.
    V0, phi0 and psi0 within 1e-5 of the stored JAX replay (t=0 features are
    the same on every path, so they are one forward pass each); the
    discounted liability at rtol 1e-3, as above."""
    report = json.loads((PENSION_WALK / "reference.json").read_text())
    cfg = port_pension_config(pension_config())
    with pytest.warns(UserWarning, match="dual_mode='shared'"):
        res = tapi.pension_oos(load_bundle(PENSION_WALK), cfg, allow_in_sample=True,
                               device="cpu")
    for k in ("v0", "phi0", "psi0"):
        np.testing.assert_allclose(getattr(res.report, k), report["oos"][k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(res.report.discounted_payoff, report["oos"]["discounted_payoff"],
                               rtol=1e-3)


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_fixture.py --write "
                 "[north_star | heston_walk | pension_walk]")
    which = ([a for a in sys.argv[1:] if a != "--write"]
             or ["north_star", "heston_walk", "pension_walk"])
    # the suite's JAX settings (tests/conftest.py), so the in-suite recompute
    # runs the same programs as the generator
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    writers = {"north_star": write_fixture, "heston_walk": write_heston_fixture,
               "pension_walk": write_pension_fixture}
    for name in which:
        print(json.dumps({name: writers[name]()}, indent=1, default=float))
