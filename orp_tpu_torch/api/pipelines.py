"""The European and Heston pipelines (counterpart of ``orp_tpu/api/pipelines.py``).

Each pipeline simulates (``engine="pallas"`` -> the fused CUDA kernels,
``"scan"`` -> the plain per-step simulators), trains (``*_hedge``: the
Gauss-Newton backward walk) or replays a trained policy on FRESH paths
(``*_oos``), builds the report and attaches the unbiased prices: the plain
discounted payoff mean, the learned-hedge control variate and the
OLS-martingale price.

- :func:`european_hedge` / :func:`european_oos`: GBM paths (K1), one feature
  ``S/S0``;
- :func:`heston_hedge` / :func:`heston_oos`: Heston paths (K3, the QE-M or
  Euler scheme), features ``(S/S0, v)``.

The JAX package's ops-plane hooks (run manifest, telemetry spans, the
model-health baseline, ``export_dir``) change no number and are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orp_tpu_torch.api.config import EuropeanConfig, HestonConfig, SimConfig, TrainConfig
from orp_tpu_torch.models.mlp import HedgeMLP
from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused
from orp_tpu_torch.qmc.fused_mf import heston_log_fused, heston_qe_fused
from orp_tpu_torch.risk.analytics import HedgeReport, build_report
from orp_tpu_torch.risk.controls import martingale_ols_price
from orp_tpu_torch.sde import (TimeGrid, bond_curve, payoffs, simulate_gbm_log,
                               simulate_heston_log, simulate_heston_qe)
from orp_tpu_torch.train.backward import (BackwardConfig, BackwardResult, backward_induction,
                                          params_to)
from orp_tpu_torch.train.replay import replay_walk
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.fingerprint import verify_policy_compat
from orp_tpu_torch.utils.precision import full_f32

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _check_pallas(sim: SimConfig, name: str) -> None:
    """The fused kernel generates Owen-scrambled float32 paths only."""
    if sim.scramble != "owen" or sim.dtype != "float32":
        raise ValueError(
            f"{name}: engine='pallas' generates Owen-scrambled float32 paths only; "
            f"got scramble={sim.scramble!r} dtype={sim.dtype!r}")


def _check_quantile_method(quantile_method: str) -> None:
    if quantile_method not in ("sort", "histogram"):
        raise ValueError(
            f"quantile_method={quantile_method!r}: expected 'sort' or 'histogram'")


def _simulate_euro_paths(euro: EuropeanConfig, sim: SimConfig, grid: TimeGrid, name: str,
                         device: torch.device) -> torch.Tensor:
    """The European path sim, ``(n_paths, n_knots)``, on the engine ``sim`` names."""
    if sim.engine == "pallas":
        _check_pallas(sim, name)
        return gbm_log_fused(
            sim.n_paths, sim.n_steps, s0=euro.s0, drift=euro.r, sigma=euro.sigma,
            dt=grid.dt, seed=sim.seed_fund, store_every=sim.rebalance_every, device=device)
    idx = torch.arange(sim.n_paths, dtype=torch.int64, device=device)
    return simulate_gbm_log(idx, grid, euro.s0, euro.r, euro.sigma, sim.seed_fund,
                            scramble=sim.scramble, store_every=sim.rebalance_every,
                            dtype=_DTYPES[sim.dtype])


def resolve_heston_scheme(scheme: str | None, name: str = "heston") -> str:
    """``HestonConfig.scheme=None`` is ``"qe"``; an explicit scheme must be known."""
    if scheme is None:
        return "qe"
    if scheme not in ("qe", "euler"):
        raise ValueError(f"{name}: unknown HestonConfig.scheme {scheme!r}")
    return scheme


def _simulate_heston_paths(h: HestonConfig, sim: SimConfig, grid: TimeGrid, name: str,
                           device: torch.device) -> dict[str, torch.Tensor]:
    """The Heston path sim, ``{"S", "v"}`` of ``(n_paths, n_knots)``, on the
    engine x scheme ``sim`` and ``h`` name."""
    qe = resolve_heston_scheme(h.scheme, name) == "qe"
    kw = dict(s0=h.s0, mu=h.r, v0=h.v0, kappa=h.kappa, theta=h.theta, xi=h.xi, rho=h.rho)
    if sim.engine == "pallas":
        _check_pallas(sim, name)
        return (heston_qe_fused if qe else heston_log_fused)(
            sim.n_paths, sim.n_steps, dt=grid.dt, seed=sim.seed_fund,
            store_every=sim.rebalance_every, device=device, **kw)
    idx = torch.arange(sim.n_paths, dtype=torch.int64, device=device)
    return (simulate_heston_qe if qe else simulate_heston_log)(
        idx, grid, seed=sim.seed_fund, scramble=sim.scramble,
        store_every=sim.rebalance_every, dtype=_DTYPES[sim.dtype], **kw)


def _attach_cv_price(report: HedgeReport, res: BackwardResult, s: torch.Tensor,
                     payoff: torch.Tensor, r: float, times,
                     strike_over_s0: float = 1.0) -> None:
    """Unbiased QMC price plus the learned-hedge control variate: ``disc_t S_t``
    is a martingale, so subtracting ``sum_t phi_t (disc_{t+1} S_{t+1} - disc_t S_t)``
    changes no mean and removes the delta-hedgeable variance."""
    disc = torch.exp(-r * torch.as_tensor(times, dtype=s.dtype).to(s.device))
    d = disc.reshape((1, -1) + (1,) * (s.ndim - 2))
    d_mart = d[:, 1:] * s[:, 1:] - d[:, :-1] * s[:, :-1]
    plain = disc[-1] * payoff
    cv = plain - torch.sum(res.phi * d_mart, dim=tuple(range(1, s.ndim)))
    report.v0_plain = float(torch.mean(plain))
    report.v0_cv = float(torch.mean(cv))
    report.cv_std = float(torch.std(cv, correction=0))
    report.v0_acv, report.acv_std = martingale_ols_price(
        s, payoff, r, times, strike_over_s0=strike_over_s0, phi=res.phi)


def _check_oos_args(name, trained, seed, train: TrainConfig, allow_in_sample: bool,
                    seed_field: str = "seed_fund") -> None:
    """Refuse the training seed (in-sample paths) and combine-semantics drift."""
    if not allow_in_sample and trained.sim_seed is not None and seed == trained.sim_seed:
        raise ValueError(
            f"{name}: sim.{seed_field}={seed} is the TRAINING seed — these are the "
            f"in-sample paths, not out-of-sample. Pass a different {seed_field}, or "
            "allow_in_sample=True for a replay-identity check")
    if trained.dual_mode is not None and train.dual_mode != trained.dual_mode:
        raise ValueError(
            f"{name}: train.dual_mode={train.dual_mode!r} does not match the training "
            f"run's {trained.dual_mode!r} — the replay would apply the wrong "
            "value-combine to the stored params")
    if (trained.holdings_combine is not None
            and train.holdings_combine != trained.holdings_combine):
        raise ValueError(
            f"{name}: train.holdings_combine={train.holdings_combine!r} does not "
            f"match the training run's {trained.holdings_combine!r}")
    if (trained.cost_of_capital is not None
            and train.cost_of_capital != trained.cost_of_capital):
        raise ValueError(
            f"{name}: train.cost_of_capital={train.cost_of_capital!r} does not match "
            f"the training run's {trained.cost_of_capital!r}")


def _check_policy_compat(name, trained, model: HedgeMLP, n_dates: int) -> HedgeMLP:
    """The trained per-date params must be exactly ``model`` over ``n_dates``;
    returns the trained model when the policy carries one (its slope and dtype
    are properties of the policy, not of the evaluation config)."""
    params = trained.backward.params1_by_date
    if params is None:
        raise ValueError(
            f"{name}: trained result has no per-date params (params1_by_date is None)")
    verify_policy_compat(name, model, n_dates, params)
    trained_model = getattr(trained, "model", None)
    return model if trained_model is None else trained_model


def _backward_on(bw: BackwardResult, device, dtype) -> BackwardResult:
    return dataclasses.replace(
        bw, params1_by_date=params_to(bw.params1_by_date, device, dtype),
        params2_by_date=params_to(bw.params2_by_date, device, dtype))


def _backward_cfg(t: TrainConfig) -> BackwardConfig:
    return BackwardConfig(**{f.name: getattr(t, f.name)
                             for f in dataclasses.fields(BackwardConfig)})


def _report(res: BackwardResult, s: torch.Tensor, payoff: torch.Tensor, r: float,
            strike: float, s0: float, times: np.ndarray, quantile_method: str) -> HedgeReport:
    """The report of a walk or replay with the unbiased prices attached."""
    report = build_report(res, terminal_payoff=payoff / s0, r=r, times=times,
                          adjustment_factor=s0, holdings_adjustment=1.0,
                          quantile_method=quantile_method)
    _attach_cv_price(report, res, s, payoff, r, times, strike_over_s0=strike / s0)
    return report


@dataclasses.dataclass
class PipelineResult:
    """Report, replayed ledgers and the combine semantics of one run."""

    report: HedgeReport
    backward: BackwardResult
    times: np.ndarray
    adjustment_factor: float
    sim_seed: int | None = None
    dual_mode: str | None = None
    holdings_combine: str | None = None
    cost_of_capital: float | None = None
    model: HedgeMLP | None = None

    @property
    def v0(self) -> float:
        return self.report.v0

    @property
    def phi0(self) -> float:
        return self.report.phi0

    @property
    def psi0(self) -> float:
        return self.report.psi0


def _result(report, res, times, s0, sim: SimConfig, train: TrainConfig, model) -> PipelineResult:
    return PipelineResult(report=report, backward=res, times=times, adjustment_factor=s0,
                          sim_seed=sim.seed_fund, dual_mode=train.dual_mode,
                          holdings_combine=train.holdings_combine,
                          cost_of_capital=train.cost_of_capital, model=model)


def european_hedge(euro: EuropeanConfig = EuropeanConfig(),
                   sim: SimConfig = SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                              rebalance_every=7),
                   train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                   quantile_method: str = "sort", warm_start=None,
                   device=None) -> PipelineResult:
    """Weekly-rebalanced European option hedge, trained by the backward walk.

    Features, prices and values are in units of ``S0``; the output bias starts
    at the normalised mean payoff. ``warm_start``: optional ``(params1,
    params2)`` for ``backward_induction(initial_params=...)``. The walk trains
    with ``train.optimizer="gauss_newton"`` and ``dual_mode="mse_only"`` and
    refuses other settings. ``device=None`` is the card."""
    dev = resolve_device(device)
    full_f32()
    _check_quantile_method(quantile_method)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    s = _simulate_euro_paths(euro, sim, grid, "european_hedge", dev)
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, euro.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], euro.strike, euro.option_type)
    s0 = euro.s0
    model = HedgeMLP(n_features=1, constrain_self_financing=euro.constrain_self_financing)
    e_payoff_n = float(torch.mean(payoff)) / s0
    bias = (e_payoff_n,) if euro.constrain_self_financing else (e_payoff_n, 0.0)
    res = backward_induction(model, (s / s0)[:, :, None], s / s0, b / s0, payoff / s0,
                             _backward_cfg(train), bias_init=bias, initial_params=warm_start)
    times = coarse.times().numpy()
    report = _report(res, s, payoff, euro.r, euro.strike, s0, times, quantile_method)
    return _result(report, res, times, s0, sim, train, model)


def european_oos(trained, euro: EuropeanConfig = EuropeanConfig(),
                 sim: SimConfig = SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                            rebalance_every=7),
                 train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                 quantile_method: str = "sort", allow_in_sample: bool = False,
                 device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained European hedge on FRESH paths.

    ``trained`` is a policy bundle (``serve.load_bundle`` /
    ``serve.bundle.policy_from_numpy``) or any result carrying ``backward``,
    ``model`` and the combine-semantics fields. ``sim.seed_fund`` must differ
    from the training seed unless ``allow_in_sample``. ``device=None`` is the
    card; the tests pass ``device="cpu"``.
    """
    dev = resolve_device(device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("european_oos", trained, sim.seed_fund, train, allow_in_sample)
    model = HedgeMLP(n_features=1, constrain_self_financing=euro.constrain_self_financing)
    model = _check_policy_compat("european_oos", trained, model, sim.n_rebalance)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    s = _simulate_euro_paths(euro, sim, grid, "european_oos", dev)
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, euro.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], euro.strike, euro.option_type)
    s0 = euro.s0
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype),
                      (s / s0)[:, :, None], s / s0, b / s0, payoff / s0,
                      _backward_cfg(train))
    times = coarse.times().numpy()
    report = _report(res, s, payoff, euro.r, euro.strike, s0, times, quantile_method)
    return _result(report, res, times, s0, sim, train, model)


def heston_hedge(heston: HestonConfig | None = None,
                 sim: SimConfig = SimConfig(n_paths=1 << 16, T=1.0, dt=1 / 364,
                                            rebalance_every=7),
                 train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                 quantile_method: str = "sort", warm_start=None,
                 device=None) -> PipelineResult:
    """European hedge under risk-neutral Heston stochastic vol. The network sees
    ``(S_t/S0, v_t)``; the report carries the unbiased CV and OLS-martingale
    prices (discounted S is still a Q-martingale). Training as in
    :func:`european_hedge`. ``device=None`` is the card."""
    dev = resolve_device(device)
    full_f32()
    _check_quantile_method(quantile_method)
    h = heston or HestonConfig()
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    traj = _simulate_heston_paths(h, sim, grid, "heston_hedge", dev)
    s, v = traj["S"], traj["v"]
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, h.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], h.strike, h.option_type)
    s0 = h.s0
    model = HedgeMLP(n_features=2)
    e_payoff_n = float(torch.mean(payoff)) / s0
    res = backward_induction(model, torch.stack([s / s0, v], dim=-1), s / s0, b / s0,
                             payoff / s0, _backward_cfg(train), bias_init=(e_payoff_n, 0.0),
                             initial_params=warm_start)
    times = coarse.times().numpy()
    report = _report(res, s, payoff, h.r, h.strike, s0, times, quantile_method)
    return _result(report, res, times, s0, sim, train, model)


def heston_oos(trained, heston: HestonConfig | None = None,
               sim: SimConfig = SimConfig(n_paths=1 << 16, T=1.0, dt=1 / 364,
                                          rebalance_every=7),
               train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
               quantile_method: str = "sort", allow_in_sample: bool = False,
               device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained Heston hedge on fresh scrambles
    (the contract of :func:`european_oos`). ``device=None`` is the card."""
    dev = resolve_device(device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("heston_oos", trained, sim.seed_fund, train, allow_in_sample)
    h = heston or HestonConfig()
    model = _check_policy_compat("heston_oos", trained, HedgeMLP(n_features=2),
                                 sim.n_rebalance)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    traj = _simulate_heston_paths(h, sim, grid, "heston_oos", dev)
    s, v = traj["S"], traj["v"]
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, h.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], h.strike, h.option_type)
    s0 = h.s0
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype),
                      torch.stack([s / s0, v], dim=-1), s / s0, b / s0, payoff / s0,
                      _backward_cfg(train))
    times = coarse.times().numpy()
    report = _report(res, s, payoff, h.r, h.strike, s0, times, quantile_method)
    return _result(report, res, times, s0, sim, train, model)
