"""The European, Heston, basket and pension pipelines (counterpart of ``orp_tpu/api/pipelines.py``).

Each pipeline simulates (``engine="pallas"`` -> the fused CUDA kernels,
``"scan"`` -> the plain per-step simulators), trains (``*_hedge``: the
backward walk, Adam or Gauss-Newton) or replays a trained policy on FRESH paths
(``*_oos``), builds the report and attaches the unbiased prices: the plain
discounted payoff mean, the learned-hedge control variate and the
OLS-martingale price.

- :func:`european_hedge` / :func:`european_oos`: GBM paths (K1), one feature
  ``S/S0``;
- :func:`heston_hedge` / :func:`heston_oos`: Heston paths (K3, the QE-M or
  Euler scheme), features ``(S/S0, v)``;
- :func:`basket_hedge` / :func:`basket_oos`: the A-asset correlated-GBM basket
  call (BASELINE.json config 5) on the scan path only, as in the JAX package,
  features ``S_i/S0_i``, hedged by the basket itself (``instruments="basket"``)
  or asset by asset (``"assets"``, the vector head); the report carries the
  moment-matched oracle price ``oracle_mm``;
- :func:`pension_hedge` / :func:`pension_oos`: the pension liability
  (``Replicating_Portfolio``, RP.py:29-235, and with ``cfg.sv`` its SV
  variant, :237-459) on the coupled fund-mortality-population paths (K3c),
  features ``(Y_t, N_t/N0, lambda_t)``, prices ``(Y_t, B_t)``, usually with
  the dual walk; no martingale prices (the fund drifts at ``mu``, not ``r``).
  :func:`sigma_sweep`, :func:`replicating_portfolio` and
  :func:`replicating_portfolio_sv` are the reference's entry points on top.

Every entry point takes ``mesh=`` (a built paths mesh, a rank count or a
``parallel.mesh.MeshSpec``; ``parallel/mesh.py``), as in the JAX package:
each rank generates its own contiguous block of the paths from
``path_indices`` on its device, trains on it with the path reductions summed
across the ranks, and returns the replicated report beside its block of the
ledgers. Like the JAX package, a mesh runs ``engine="scan"`` only
(:func:`_check_pallas`).

Under a telemetry session (``obs/``) each ``*_hedge`` binds its run
manifest (:func:`_bind_run_manifest`: the pipeline, the config fingerprint
and, under a mesh, the mesh's shape) and spans ``pipeline/simulate`` and
``pipeline/report`` around the regions the JAX package spans. The
model-health baseline and ``export_dir`` wait for the serve path's
``obs/quality.py`` and ``serve/bundle.export_bundle``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orp_tpu_torch.api.config import (ActuarialConfig, BasketConfig, EuropeanConfig,
                                      HedgeRunConfig, HestonConfig, MarketConfig, SimConfig,
                                      StochVolConfig, TrainConfig)
from orp_tpu_torch.models.mlp import HedgeMLP
from orp_tpu_torch.obs import bind_manifest, config_fingerprint
from orp_tpu_torch.obs import enabled as obs_enabled
from orp_tpu_torch.obs import span as obs_span
from orp_tpu_torch.parallel.mesh import (as_mesh, describe_mesh, mesh_device, path_indices,
                                         path_mean)
from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused
from orp_tpu_torch.qmc.fused_mf import heston_log_fused, heston_qe_fused, pension_fused
from orp_tpu_torch.risk.analytics import HedgeReport, build_report
from orp_tpu_torch.risk.controls import martingale_ols_price, path_std
from orp_tpu_torch.sde import (TimeGrid, bond_curve, payoffs, simulate_gbm_basket,
                               simulate_gbm_log, simulate_heston_log, simulate_heston_qe,
                               simulate_pension)
from orp_tpu_torch.train.backward import (BackwardConfig, BackwardResult, backward_induction,
                                          params_to)
from orp_tpu_torch.train.replay import replay_walk
from orp_tpu_torch.utils.basket import basket_call_mm
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.fingerprint import verify_policy_compat
from orp_tpu_torch.utils.precision import full_f32

_DTYPES = {"float32": torch.float32, "float64": torch.float64}  # orp: noqa[ORP001] -- the walk's dtype table must name every dtype a config may ask for


def _check_pallas(sim: SimConfig, mesh, name: str) -> None:
    """The fused kernels are single-device and generate Owen-scrambled
    float32 paths only."""
    if mesh is not None:
        raise ValueError(
            f"{name}: engine='pallas' is single-chip; use engine='scan' with a mesh")
    if sim.scramble != "owen" or sim.dtype != "float32":
        raise ValueError(
            f"{name}: engine='pallas' generates Owen-scrambled float32 paths only; "
            f"got scramble={sim.scramble!r} dtype={sim.dtype!r}")


def _check_quantile_method(quantile_method: str) -> None:
    if quantile_method not in ("sort", "histogram"):
        raise ValueError(
            f"quantile_method={quantile_method!r}: expected 'sort' or 'histogram'")


def _placement(mesh, device):
    """``(mesh, device)``: the built mesh (or None) and the device the run's
    paths live on, this rank's under a mesh, else ``resolve_device(device)``."""
    mesh = as_mesh(mesh, device)
    return mesh, (mesh_device(mesh) if mesh is not None else resolve_device(device))


def _simulate_euro_paths(euro: EuropeanConfig, sim: SimConfig, grid: TimeGrid, name: str,
                         device: torch.device, mesh=None) -> torch.Tensor:
    """The European path sim, ``(n_paths, n_knots)`` (this rank's block under
    ``mesh``), on the engine ``sim`` names."""
    if sim.engine == "pallas":
        _check_pallas(sim, mesh, name)
        return gbm_log_fused(
            sim.n_paths, sim.n_steps, s0=euro.s0, drift=euro.r, sigma=euro.sigma,
            dt=grid.dt, seed=sim.seed_fund, store_every=sim.rebalance_every, device=device)
    idx = path_indices(sim.n_paths, mesh, device)
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
                           device: torch.device, mesh=None) -> dict[str, torch.Tensor]:
    """The Heston path sim, ``{"S", "v"}`` of ``(n_paths, n_knots)``, on the
    engine x scheme ``sim`` and ``h`` name."""
    qe = resolve_heston_scheme(h.scheme, name) == "qe"
    kw = dict(s0=h.s0, mu=h.r, v0=h.v0, kappa=h.kappa, theta=h.theta, xi=h.xi, rho=h.rho)
    if sim.engine == "pallas":
        _check_pallas(sim, mesh, name)
        return (heston_qe_fused if qe else heston_log_fused)(
            sim.n_paths, sim.n_steps, dt=grid.dt, seed=sim.seed_fund,
            store_every=sim.rebalance_every, device=device, **kw)
    idx = path_indices(sim.n_paths, mesh, device)
    return (simulate_heston_qe if qe else simulate_heston_log)(
        idx, grid, seed=sim.seed_fund, scramble=sim.scramble,
        store_every=sim.rebalance_every, dtype=_DTYPES[sim.dtype], **kw)


def _attach_cv_price(report: HedgeReport, res: BackwardResult, s: torch.Tensor,
                     payoff: torch.Tensor, r: float, times,
                     strike_over_s0: float = 1.0, mesh=None) -> None:
    """Unbiased QMC price plus the learned-hedge control variate: ``disc_t S_t``
    is a martingale, so subtracting ``sum_t phi_t (disc_{t+1} S_{t+1} - disc_t S_t)``
    changes no mean and removes the delta-hedgeable variance. Means and stds
    over the global paths under ``mesh``."""
    disc = torch.exp(-r * torch.as_tensor(times, dtype=s.dtype).to(s.device))
    d = disc.reshape((1, -1) + (1,) * (s.ndim - 2))
    d_mart = d[:, 1:] * s[:, 1:] - d[:, :-1] * s[:, :-1]
    plain = disc[-1] * payoff
    cv = plain - torch.sum(res.phi * d_mart, dim=tuple(range(1, s.ndim)))
    report.v0_plain = float(path_mean(torch.mean(plain), mesh))
    report.v0_cv = float(path_mean(torch.mean(cv), mesh))
    report.cv_std = path_std(cv, mesh)
    report.v0_acv, report.acv_std = martingale_ols_price(
        s, payoff, r, times, strike_over_s0=strike_over_s0, phi=res.phi, mesh=mesh)


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


def _bind_run_manifest(pipeline: str, *configs, mesh=None) -> None:
    """Bind this run's identity to the active telemetry session (a no-op when
    telemetry is off): the manifest records the pipeline and the CONFIG
    FINGERPRINT of the run (``obs.config_fingerprint``; the port's configs
    have the JAX package's reprs, so both packages write the same string for
    the same configs). ``configs`` holds every run-shaping argument: the
    config objects and the bare keyword knobs (``quantile_method``, the
    basket's ``instruments``). ``device=`` is not one (the JAX package has no
    such argument). ``mesh``, the mesh the run already built, adds its shape
    and device kind (``parallel.mesh.describe_mesh``, read from the mesh
    object: no group is formed and no collective entered, so a rank with
    telemetry on does no group work that a rank without skips)."""
    if not obs_enabled():
        return
    fields = {"pipeline": pipeline, "run_fingerprint": config_fingerprint(*configs)}
    if mesh is not None:
        fields["mesh"] = describe_mesh(mesh)
    bind_manifest(**fields)


def _backward_on(bw: BackwardResult, device, dtype) -> BackwardResult:
    return dataclasses.replace(
        bw, params1_by_date=params_to(bw.params1_by_date, device, dtype),
        params2_by_date=params_to(bw.params2_by_date, device, dtype))


def _backward_cfg(t: TrainConfig) -> BackwardConfig:
    """The walk's config from ``t``; ``warm_lr``, which ``TrainConfig`` does not
    carry (as in the JAX package), keeps its default."""
    return BackwardConfig(**{f.name: getattr(t, f.name)
                             for f in dataclasses.fields(BackwardConfig) if hasattr(t, f.name)})


def _report(res: BackwardResult, s: torch.Tensor, payoff: torch.Tensor, r: float,
            strike: float, s0: float, times: np.ndarray, quantile_method: str,
            mesh=None) -> HedgeReport:
    """The report of a walk or replay with the unbiased prices attached."""
    report = build_report(res, terminal_payoff=payoff / s0, r=r, times=times,
                          adjustment_factor=s0, holdings_adjustment=1.0,
                          quantile_method=quantile_method, mesh=mesh)
    _attach_cv_price(report, res, s, payoff, r, times, strike_over_s0=strike / s0, mesh=mesh)
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
    # the model-health baseline the export bakes (obs/quality.py, _attach_baseline)
    feature_sketch: object | None = None
    validation: object | None = None
    hedge_error_baseline: float | None = None

    @property
    def v0(self) -> float:
        return self.report.v0

    @property
    def phi0(self) -> float:
        return self.report.phi0

    @property
    def psi0(self) -> float:
        return self.report.psi0


def _maybe_export(result: PipelineResult, export_dir) -> PipelineResult:
    """The ``export_dir`` hook: persist the trained policy as a serve bundle
    right after training (``serve/bundle.export_bundle``)."""
    if export_dir is not None:
        from orp_tpu_torch.serve.bundle import export_bundle

        export_bundle(result, export_dir)
    return result


def _attach_baseline(result: PipelineResult, features, validation=None) -> PipelineResult:
    """Attach the model-health baseline (``obs/quality.py``) the export bakes
    into the bundle: the per-feature sketch of the TRAINING features, taken
    on their device (this rank's block under a mesh), the pinned validation
    set when the pipeline has one, and the training hedge-error level
    (``cv_std`` in the walk's normalised units, else the residual-P&L std)."""
    from orp_tpu_torch.obs.quality import FeatureSketch

    result.feature_sketch = FeatureSketch.from_features(features)
    result.validation = validation
    rep = result.report
    if getattr(rep, "cv_std", None) is not None:
        result.hedge_error_baseline = float(rep.cv_std) / float(result.adjustment_factor)
    else:
        stats = getattr(rep, "residual_stats", None) or {}
        if stats.get("std") is not None:
            # residual_stats are adjusted by the report: divide back to the
            # normalised units of the cv_std branch and the validation estimate
            result.hedge_error_baseline = float(stats["std"]) / float(result.adjustment_factor)
    return result


def _result(report, res, times, s0, sim: SimConfig, train: TrainConfig, model) -> PipelineResult:
    return PipelineResult(report=report, backward=res, times=times, adjustment_factor=s0,
                          sim_seed=sim.seed_fund, dual_mode=train.dual_mode,
                          holdings_combine=train.holdings_combine,
                          cost_of_capital=train.cost_of_capital, model=model)


def european_hedge(euro: EuropeanConfig = EuropeanConfig(),
                   sim: SimConfig = SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                              rebalance_every=7),
                   train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                   quantile_method: str = "sort", warm_start=None, mesh=None,
                   device=None, export_dir=None) -> PipelineResult:
    """Weekly-rebalanced European option hedge, trained by the backward walk.

    Features, prices and values are in units of ``S0``; the output bias starts
    at the normalised mean payoff. ``warm_start``: optional ``(params1,
    params2)`` for ``backward_induction(initial_params=...)``. ``device=None``
    is the card. ``mesh``: this rank's block of the paths (module docstring).
    The result carries its model-health baseline (a ``gbm`` validation set);
    ``export_dir``: also export it as a serve bundle there."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _bind_run_manifest("european_hedge", euro, sim, train, f"quantile_method={quantile_method}",
                       mesh=mesh)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    with obs_span("pipeline/simulate") as sp:
        s = sp.set_result(_simulate_euro_paths(euro, sim, grid, "european_hedge", dev, mesh))
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, euro.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], euro.strike, euro.option_type)
    s0 = euro.s0
    model = HedgeMLP(n_features=1, constrain_self_financing=euro.constrain_self_financing)
    e_payoff_n = float(path_mean(torch.mean(payoff), mesh)) / s0
    bias = (e_payoff_n,) if euro.constrain_self_financing else (e_payoff_n, 0.0)
    features = (s / s0)[:, :, None]
    res = backward_induction(model, features, s / s0, b / s0, payoff / s0,
                             _backward_cfg(train), bias_init=bias, initial_params=warm_start,
                             mesh=mesh)
    times = coarse.times().numpy()
    with obs_span("pipeline/report"):
        report = _report(res, s, payoff, euro.r, euro.strike, s0, times, quantile_method, mesh)
    from orp_tpu_torch.obs.quality import ValidationSpec

    result = _attach_baseline(_result(report, res, times, s0, sim, train, model), features,
                              ValidationSpec(kind="gbm", s0=euro.s0, r=euro.r, sigma=euro.sigma,
                                             strike=euro.strike, option_type=euro.option_type,
                                             T=sim.T, n_steps=sim.n_steps,
                                             rebalance_every=sim.rebalance_every,
                                             n_paths=min(sim.n_paths, 2048)))
    return _maybe_export(result, export_dir)


def european_oos(trained, euro: EuropeanConfig = EuropeanConfig(),
                 sim: SimConfig = SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                            rebalance_every=7),
                 train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                 quantile_method: str = "sort", allow_in_sample: bool = False, mesh=None,
                 device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained European hedge on FRESH paths.

    ``trained`` is a policy bundle (``serve.load_bundle`` /
    ``serve.bundle.policy_from_numpy``) or any result carrying ``backward``,
    ``model`` and the combine-semantics fields. ``sim.seed_fund`` must differ
    from the training seed unless ``allow_in_sample``. ``device=None`` is the
    card; the tests pass ``device="cpu"``. ``mesh``: as :func:`european_hedge`.
    """
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("european_oos", trained, sim.seed_fund, train, allow_in_sample)
    model = HedgeMLP(n_features=1, constrain_self_financing=euro.constrain_self_financing)
    model = _check_policy_compat("european_oos", trained, model, sim.n_rebalance)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    s = _simulate_euro_paths(euro, sim, grid, "european_oos", dev, mesh)
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, euro.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], euro.strike, euro.option_type)
    s0 = euro.s0
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype),
                      (s / s0)[:, :, None], s / s0, b / s0, payoff / s0,
                      _backward_cfg(train))
    times = coarse.times().numpy()
    report = _report(res, s, payoff, euro.r, euro.strike, s0, times, quantile_method, mesh)
    return _result(report, res, times, s0, sim, train, model)


def heston_hedge(heston: HestonConfig | None = None,
                 sim: SimConfig = SimConfig(n_paths=1 << 16, T=1.0, dt=1 / 364,
                                            rebalance_every=7),
                 train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                 quantile_method: str = "sort", warm_start=None, mesh=None,
                 device=None, export_dir=None) -> PipelineResult:
    """European hedge under risk-neutral Heston stochastic vol. The network sees
    ``(S_t/S0, v_t)``; the report carries the unbiased CV and OLS-martingale
    prices (discounted S is still a Q-martingale). Training, ``mesh``, the
    baseline (a ``heston-<scheme>`` validation set) and ``export_dir`` as in
    :func:`european_hedge`. ``device=None`` is the card."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    h = heston or HestonConfig()
    _bind_run_manifest("heston_hedge", h, sim, train, f"quantile_method={quantile_method}",
                       mesh=mesh)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    with obs_span("pipeline/simulate") as sp:
        traj = sp.set_result(_simulate_heston_paths(h, sim, grid, "heston_hedge", dev, mesh))
    s, v = traj["S"], traj["v"]
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, h.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], h.strike, h.option_type)
    s0 = h.s0
    model = HedgeMLP(n_features=2)
    e_payoff_n = float(path_mean(torch.mean(payoff), mesh)) / s0
    features = torch.stack([s / s0, v], dim=-1)
    res = backward_induction(model, features, s / s0, b / s0,
                             payoff / s0, _backward_cfg(train), bias_init=(e_payoff_n, 0.0),
                             initial_params=warm_start, mesh=mesh)
    times = coarse.times().numpy()
    with obs_span("pipeline/report"):
        report = _report(res, s, payoff, h.r, h.strike, s0, times, quantile_method, mesh)
    from orp_tpu_torch.obs.quality import ValidationSpec

    scheme = resolve_heston_scheme(h.scheme, "heston_hedge")
    result = _attach_baseline(_result(report, res, times, s0, sim, train, model), features,
                              ValidationSpec(kind=f"heston-{scheme}", s0=h.s0, r=h.r, v0=h.v0,
                                             kappa=h.kappa, theta=h.theta, xi=h.xi, rho=h.rho,
                                             strike=h.strike, option_type=h.option_type,
                                             T=sim.T, n_steps=sim.n_steps,
                                             rebalance_every=sim.rebalance_every,
                                             n_paths=min(sim.n_paths, 2048)))
    return _maybe_export(result, export_dir)


def heston_oos(trained, heston: HestonConfig | None = None,
               sim: SimConfig = SimConfig(n_paths=1 << 16, T=1.0, dt=1 / 364,
                                          rebalance_every=7),
               train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
               quantile_method: str = "sort", allow_in_sample: bool = False, mesh=None,
               device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained Heston hedge on fresh scrambles
    (the contract of :func:`european_oos`). ``device=None`` is the card."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("heston_oos", trained, sim.seed_fund, train, allow_in_sample)
    h = heston or HestonConfig()
    model = _check_policy_compat("heston_oos", trained, HedgeMLP(n_features=2),
                                 sim.n_rebalance)
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    traj = _simulate_heston_paths(h, sim, grid, "heston_oos", dev, mesh)
    s, v = traj["S"], traj["v"]
    coarse = grid.reduced(sim.rebalance_every)
    b = bond_curve(coarse, h.r, dtype, dev)
    payoff = payoffs.european(s[:, -1], h.strike, h.option_type)
    s0 = h.s0
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype),
                      torch.stack([s / s0, v], dim=-1), s / s0, b / s0, payoff / s0,
                      _backward_cfg(train))
    times = coarse.times().numpy()
    report = _report(res, s, payoff, h.r, h.strike, s0, times, quantile_method, mesh)
    return _result(report, res, times, s0, sim, train, model)


# ---------------------------------------------------------------------------
# Basket pipeline (BASELINE.json config 5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasketInputs:
    """What both basket entry points build from one path sim."""

    s: torch.Tensor            # (n, knots, A) asset paths
    bkt: torch.Tensor          # (n, knots) the basket sum_i w_i S_i
    features: torch.Tensor     # (n, knots, A) moneyness S_i / S0_i
    hedge_prices: torch.Tensor  # (n, knots) basket or (n, knots, A) assets, over the strike
    b: torch.Tensor            # (knots,) the bond curve over the strike
    payoff: torch.Tensor       # (n,) the basket call's payoff
    terminal: torch.Tensor     # (n,) the payoff over the strike
    norm: float                # the strike: prices, values and payoff are in its units
    vector: bool               # the per-asset hedge (``instruments="assets"``, A > 1)
    model: HedgeMLP
    bias_init: tuple[float, ...]  # the output bias: E[payoff]/norm spread over the risky legs
    times: np.ndarray


def basket_inputs(basket: BasketConfig, sim: SimConfig, instruments: str, name: str,
                  device: torch.device, mesh=None) -> BasketInputs:
    """Simulate the basket and build the walk's inputs. The scan engine only,
    as in the JAX package; ``instruments="assets"`` with one asset is the
    basket hedge. The normalisations divide by device tensors: on a card a
    division by a Python scalar becomes a multiplication by its rounded
    reciprocal. ``mesh``: this rank's block of the paths."""
    if sim.engine == "pallas":
        raise ValueError(f"{name}: engine='pallas' not available; use 'scan'")
    if instruments not in ("basket", "assets"):
        raise ValueError(f"instruments={instruments!r}: expected 'basket' or 'assets'")
    dtype = _DTYPES[sim.dtype]
    grid = TimeGrid(sim.T, sim.n_steps)
    n_assets = len(basket.s0)
    idx = path_indices(sim.n_paths, mesh, device)
    s = simulate_gbm_basket(idx, grid, s0=basket.s0, drift=[basket.r] * n_assets,
                            sigma=basket.sigmas, corr=basket.corr(), seed=sim.seed_fund,
                            scramble=sim.scramble, store_every=sim.rebalance_every, dtype=dtype)
    w = torch.tensor(basket.weights, dtype=dtype, device=device)
    bkt = s @ w  # full f32 (full_f32()): a TF32 weighting tilts the whole basket
    coarse = grid.reduced(sim.rebalance_every)
    payoff = payoffs.basket_call(s[:, -1], w, basket.strike)
    norm = float(basket.strike)
    norm_t = torch.tensor(norm, dtype=dtype, device=device)
    vector = instruments == "assets" and n_assets > 1
    e_payoff_n = float(path_mean(torch.mean(payoff), mesh)) / norm
    if vector:
        # the normalised prices are ~s0_i/norm at t=0: the expected payoff
        # spread evenly over the A risky legs
        bias = tuple(e_payoff_n / (n_assets * s0_i / norm) for s0_i in basket.s0) + (0.0,)
        model = HedgeMLP(n_features=n_assets, n_hedge_assets=n_assets)
    else:
        bias = (e_payoff_n, 0.0)
        model = HedgeMLP(n_features=n_assets)
    return BasketInputs(
        s=s, bkt=bkt, features=s / torch.tensor(basket.s0, dtype=dtype, device=device),
        hedge_prices=(s if vector else bkt) / norm_t,
        b=bond_curve(coarse, basket.r, dtype, device) / norm_t, payoff=payoff,
        terminal=payoff / norm_t, norm=norm,
        vector=vector, model=model, bias_init=bias, times=coarse.times().numpy())


def _basket_result(basket: BasketConfig, sim: SimConfig, train: TrainConfig,
                   inp: BasketInputs, res: BackwardResult,
                   quantile_method: str, mesh=None) -> PipelineResult:
    """The report of a basket walk or replay: under the vector hedge the
    report's scalar phi is the value-equivalent basket holding ``sum_i phi_i
    S_i / B_t`` and the prices' controls are the per-asset martingales; the
    OLS basis kink sits at ``strike / (s0 . w)``; ``oracle_mm`` is
    :func:`~orp_tpu_torch.utils.basket.basket_call_mm`'s price."""
    view = res
    if inp.vector:
        norm_t = torch.tensor(inp.norm, dtype=inp.s.dtype, device=inp.s.device)
        phi_eq = (torch.sum(res.phi * (inp.s[:, :-1] / norm_t), dim=-1)
                  / (inp.bkt[:, :-1] / norm_t))
        view = dataclasses.replace(res, phi=phi_eq)
    report = build_report(view, terminal_payoff=inp.terminal, r=basket.r,
                          times=inp.times, adjustment_factor=inp.norm, holdings_adjustment=1.0,
                          quantile_method=quantile_method, mesh=mesh)
    b0 = float(torch.tensor(basket.s0, dtype=inp.s.dtype)
               @ torch.tensor(basket.weights, dtype=inp.s.dtype))
    _attach_cv_price(report, res, inp.s if inp.vector else inp.bkt, inp.payoff, basket.r,
                     inp.times, strike_over_s0=basket.strike / b0, mesh=mesh)
    report.oracle_mm = basket_call_mm(basket.s0, basket.weights, basket.strike, basket.r,
                                      basket.sigmas, basket.corr(), sim.T)[0]
    return PipelineResult(report=report, backward=res, times=inp.times,
                          adjustment_factor=inp.norm, sim_seed=sim.seed_fund,
                          dual_mode=train.dual_mode, holdings_combine=train.holdings_combine,
                          cost_of_capital=train.cost_of_capital, model=inp.model)


def basket_hedge(basket: BasketConfig = BasketConfig(),
                 sim: SimConfig = SimConfig(n_paths=1 << 17, T=1.0, dt=1 / 52,
                                            rebalance_every=1),
                 train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
                 quantile_method: str = "sort", instruments: str = "basket", mesh=None,
                 device=None, export_dir=None) -> PipelineResult:
    """A-asset basket-call hedge (BASELINE.json config 5), trained by the
    backward walk. The network sees the A moneyness features ``S_i/S0_i``.

    - ``instruments="basket"``: the basket ``B_t = sum_i w_i S_i`` and the bond
      (the 2-instrument head);
    - ``instruments="assets"``: the vector hedge, one phi per asset and the
      bond (``HedgeMLP(n_hedge_assets=A)``); ``backward.phi`` is ``(n, dates,
      A)``, and it cuts the control variate's std below the basket hedge's
      where the sigmas differ.

    Prices, values and payoff are in units of the strike. Scan engine only
    (``engine="pallas"`` is refused, as in the JAX package). ``device=None`` is
    the card; ``mesh`` and ``export_dir`` as in :func:`european_hedge` (the
    baseline is the feature sketch alone: there is no basket validation kind)."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _bind_run_manifest("basket_hedge", basket, sim, train, f"instruments={instruments}",
                       f"quantile_method={quantile_method}", mesh=mesh)
    with obs_span("pipeline/simulate") as sp:
        inp = basket_inputs(basket, sim, instruments, "basket_hedge", dev, mesh)
        sp.set_result(inp.s)
    res = backward_induction(inp.model, inp.features, inp.hedge_prices, inp.b, inp.terminal,
                             _backward_cfg(train), bias_init=inp.bias_init, mesh=mesh)
    with obs_span("pipeline/report"):
        result = _basket_result(basket, sim, train, inp, res, quantile_method, mesh)
    return _maybe_export(_attach_baseline(result, inp.features), export_dir)


def basket_oos(trained, basket: BasketConfig = BasketConfig(),
               sim: SimConfig = SimConfig(n_paths=1 << 17, T=1.0, dt=1 / 52,
                                          rebalance_every=1),
               train: TrainConfig = TrainConfig(dual_mode="mse_only"), *,
               quantile_method: str = "sort", instruments: str = "basket",
               allow_in_sample: bool = False, mesh=None, device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained basket hedge on fresh scrambles
    (the contract of :func:`european_oos`); ``instruments`` must be the
    training run's, whose head shape the stored per-date params carry.
    ``device=None`` is the card."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("basket_oos", trained, sim.seed_fund, train, allow_in_sample)
    inp = basket_inputs(basket, sim, instruments, "basket_oos", dev, mesh)
    # the head depends on the instruments mode, so the guard runs after the sim
    model = _check_policy_compat("basket_oos", trained, inp.model, sim.n_rebalance)
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype), inp.features,
                      inp.hedge_prices, inp.b, inp.terminal, _backward_cfg(train))
    return _basket_result(basket, sim, train, dataclasses.replace(inp, model=model), res,
                          quantile_method, mesh)


# ---------------------------------------------------------------------------
# Pension-liability pipeline (Replicating_Portfolio / _SV)
# ---------------------------------------------------------------------------


def _simulate_pension_paths(cfg: HedgeRunConfig, grid: TimeGrid, name: str,
                            device: torch.device, mesh=None) -> dict[str, torch.Tensor]:
    """The pension path sim, ``{"Y", "lam", "N"}`` (+ ``"v"``) of
    ``(n_paths, n_knots)``; every factor draws from ``sim.seed``'s stream."""
    m, a, s, sv = cfg.market, cfg.actuarial, cfg.sim, cfg.sv
    kw = dict(y0=m.y0, mu=m.mu, sigma=None if sv else m.sigma, l0=a.l0, mort_c=a.mort_c,
              eta=a.eta, n0=float(a.n0), seed=s.seed, store_every=s.rebalance_every,
              sv=sv is not None, v0=sv.v0 if sv else 0.0, cir_a=sv.a if sv else 0.0,
              cir_b=sv.b if sv else 0.0, cir_c=sv.c if sv else 0.0,
              cir_drift_times_dt=sv.drift_times_dt if sv else False,
              binomial_mode=s.binomial_mode)
    if s.engine == "pallas":
        _check_pallas(s, mesh, name)
        return pension_fused(s.n_paths, s.n_steps, dt=grid.dt, device=device, **kw)
    idx = path_indices(s.n_paths, mesh, device)
    return simulate_pension(idx, grid, scramble=s.scramble, dtype=_DTYPES[s.dtype], **kw)


@dataclasses.dataclass
class PensionInputs:
    """What both pension entry points build from one path sim."""

    features: torch.Tensor     # (n, knots, 3): Y_t, N_t/N0, lambda_t
    y: torch.Tensor            # (n, knots) the fund, the risky price
    b: torch.Tensor            # (knots,) the bond curve
    terminal: torch.Tensor     # (n,) max(Y_T, K) N_T/N0, the normalised liability
    bias_init: tuple[float, float]  # (1 - otm, otm), otm = P(Y_T < Y0) (RP.py:89, :150)
    adjustment: float          # N0 * P (RP.py:46, :230)
    times: np.ndarray


def pension_inputs(cfg: HedgeRunConfig, name: str, device: torch.device,
                   paths: dict | None = None, mesh=None) -> PensionInputs:
    """Simulate the pension paths (or take ``paths``, ``{"Y", "lam", "N"}`` on
    ``device`` in ``cfg.sim.dtype``) and build the walk's inputs (RP.py:182-184).

    ``N / N0`` divides by a device tensor: on a card a division by a Python
    scalar becomes a multiplication by its rounded reciprocal."""
    m, a, s = cfg.market, cfg.actuarial, cfg.sim
    dtype = _DTYPES[s.dtype]
    grid = TimeGrid(s.T, s.n_steps)
    traj = paths if paths is not None else _simulate_pension_paths(cfg, grid, name, device,
                                                                   mesh)
    y, lam, pop = traj["Y"], traj["lam"], traj["N"]
    coarse = grid.reduced(s.rebalance_every)
    pop_n = pop / torch.tensor(float(a.n0), dtype=pop.dtype, device=pop.device)
    terminal = payoffs.pension_floor(y[:, -1], a.guarantee) * pop_n[:, -1]
    otm = float(path_mean(payoffs.out_of_money_prob(y[:, -1], m.y0), mesh))
    return PensionInputs(features=torch.stack([y, pop_n, lam], dim=-1), y=y,
                         b=bond_curve(coarse, m.r, dtype, device), terminal=terminal,
                         bias_init=(1.0 - otm, otm), adjustment=a.n0 * a.premium,
                         times=coarse.times().numpy())


def _pension_result(cfg: HedgeRunConfig, inp: PensionInputs, res: BackwardResult, model,
                    quantile_method: str, mesh=None) -> PipelineResult:
    report = build_report(res, terminal_payoff=inp.terminal, r=cfg.market.r, times=inp.times,
                          adjustment_factor=inp.adjustment, quantile_method=quantile_method,
                          mesh=mesh)
    t = cfg.train
    return PipelineResult(report=report, backward=res, times=inp.times,
                          adjustment_factor=inp.adjustment, sim_seed=cfg.sim.seed,
                          dual_mode=t.dual_mode, holdings_combine=t.holdings_combine,
                          cost_of_capital=t.cost_of_capital, model=model)


def pension_hedge(cfg: HedgeRunConfig = HedgeRunConfig(), *, quantile_method: str = "sort",
                  mesh=None, device=None, export_dir=None) -> PipelineResult:
    """Dynamic pension-liability hedge (RP.py:29-235; the SV variant, :237-459,
    when ``cfg.sv`` is set), trained by the backward walk.

    The model ``HedgeMLP(n_features=3)`` sees ``(Y_t, N_t/N0, lambda_t)`` and
    prices ``(Y_t, B_t)``; the terminal value is ``max(Y_T, K) N_T/N0`` and the
    output bias starts at ``(1 - otm, otm)``; the reported phi/psi/V0 are
    scaled by ``N0 * premium``. ``engine="pallas"`` with
    ``binomial_mode="exact"`` is refused before the kernel runs (its thinning
    is ``normal`` or ``inversion``, as the JAX package's Pallas engine's).
    ``device=None`` is the card; ``mesh`` as in :func:`european_hedge` (exact
    thinning draws each path's deaths by its global index, so a sharded run's
    paths are the single-device run's). ``export_dir`` as in
    :func:`european_hedge`; the baseline is the feature sketch alone (there
    is no pension validation kind, so the quality gate needs an explicit
    spec)."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _bind_run_manifest("pension_hedge", cfg, f"quantile_method={quantile_method}", mesh=mesh)
    bcfg = _backward_cfg(cfg.train)
    with obs_span("pipeline/simulate") as sp:
        paths = sp.set_result(_simulate_pension_paths(
            cfg, TimeGrid(cfg.sim.T, cfg.sim.n_steps), "pension_hedge", dev, mesh))
    inp = pension_inputs(cfg, "pension_hedge", dev, paths=paths, mesh=mesh)
    model = HedgeMLP(n_features=3)
    res = backward_induction(model, inp.features, inp.y, inp.b, inp.terminal, bcfg,
                             bias_init=inp.bias_init, mesh=mesh)
    with obs_span("pipeline/report"):
        result = _pension_result(cfg, inp, res, model, quantile_method, mesh)
    return _maybe_export(_attach_baseline(result, inp.features), export_dir)


def pension_oos(trained, cfg: HedgeRunConfig = HedgeRunConfig(), *,
                quantile_method: str = "sort", allow_in_sample: bool = False, mesh=None,
                device=None) -> PipelineResult:
    """Out-of-sample evaluation of a trained pension hedge on fresh paths.

    ``cfg.sim.seed`` must differ from the training run's (it seeds every
    factor's stream) unless ``allow_in_sample``; everything else in ``cfg``
    must match the training run. In ``shared`` mode the replayed values carry
    the post-quantile snapshot caveat of ``train/replay.py`` (it warns).
    ``device=None`` is the card."""
    mesh, dev = _placement(mesh, device)
    full_f32()
    _check_quantile_method(quantile_method)
    _check_oos_args("pension_oos", trained, cfg.sim.seed, cfg.train, allow_in_sample,
                    seed_field="seed")
    model = _check_policy_compat("pension_oos", trained, HedgeMLP(n_features=3),
                                 cfg.sim.n_rebalance)
    inp = pension_inputs(cfg, "pension_oos", dev, mesh=mesh)
    res = replay_walk(model, _backward_on(trained.backward, dev, model.dtype), inp.features,
                      inp.y, inp.b, inp.terminal, _backward_cfg(cfg.train))
    return _pension_result(cfg, inp, res, model, quantile_method, mesh)


def sigma_sweep(sigmas, base: HedgeRunConfig = HedgeRunConfig(), *, mesh=None,
                device=None) -> list[dict[str, float]]:
    """Volatility sweep (``Multi Time Step.ipynb#29-30``): the pension hedge per
    sigma, tabulating ``(sigma, phi0, psi0, phi0 + psi0)``."""
    if base.sv is not None:
        raise ValueError("sigma_sweep varies the constant vol, which the SV fund ignores; "
                         "sweep StochVolConfig fields instead")
    rows = []
    for sg in sigmas:
        cfg = dataclasses.replace(base, market=dataclasses.replace(base.market, sigma=sg))
        res = pension_hedge(cfg, mesh=mesh, device=device)
        rows.append({"sigma": sg, "phi": res.phi0, "psi": res.psi0,
                     "total": res.phi0 + res.psi0})
    return rows


def _cfg_from_params(params: dict, sv_c: float | None = None) -> HedgeRunConfig:
    """The reference's flat params dict (``Multi Time Step.ipynb#28``) as
    namespaced configs. ``rebalancing`` is the rebalance interval in years;
    ``n_paths`` is the Sobol log2 exponent (RP.py:49). SV mode is selected by
    ``sv_c`` alone (set by the SV shim); extra keys are ignored, like the
    reference's positional unpacking. ``'c'`` is the mortality drift."""
    T, dt = float(params["T"]), float(params["dt"])
    n_steps = int(np.ceil(T / dt - 1e-9))
    # epsilon: quotients like 364/(1/(3/365)) land at 2.9999999999999996
    reduction = int(np.floor(n_steps / (T / params["rebalancing"]) + 1e-9))
    if reduction < 1:
        raise ValueError(f"rebalancing interval {params['rebalancing']} is shorter than dt={dt}")
    n_steps -= n_steps % reduction  # keep the coarse grid exact
    sv = None
    if sv_c is not None:
        sv = StochVolConfig(
            a=float(params.get("a", StochVolConfig.a)),
            b=float(params.get("b", StochVolConfig.b)),
            c=float(sv_c),
            # the SV notebook names the initial vol 's0' (Multi#32)
            v0=float(params.get("v0", params.get("s0", params.get("sigma",
                                                                  StochVolConfig.v0)))))
    return HedgeRunConfig(
        market=MarketConfig(
            y0=float(params["Y"]), mu=float(params["mu"]), r=float(params["r"]),
            # the SV dict carries no 'sigma' (unused under SV); constant vol needs it
            sigma=float(params.get("sigma", MarketConfig.sigma) if sv_c is not None
                        else params["sigma"])),
        actuarial=ActuarialConfig(
            n0=int(params["N"]), premium=float(params["P"]), guarantee=float(params["K"]),
            age=int(params.get("x", 55)), l0=float(params["l0"]),
            mort_c=float(params["c"]), eta=float(params["ita"])),
        sv=sv,
        sim=SimConfig(n_paths=2 ** int(params["n_paths"]), T=n_steps * dt, dt=dt,
                      rebalance_every=reduction))


def _shim_cfg(cfg: HedgeRunConfig, train: TrainConfig | None,
              binomial_mode: str) -> HedgeRunConfig:
    """``train=None`` is the JAX default ``TrainConfig()`` (Adam 500/100, ``separate``)."""
    return dataclasses.replace(cfg, train=TrainConfig() if train is None else train,
                               sim=dataclasses.replace(cfg.sim, binomial_mode=binomial_mode))


def replicating_portfolio(params: dict, train: TrainConfig | None = None, *,
                          binomial_mode: str = "exact", device=None) -> tuple[float, float]:
    """Reference entry point ``Replicating_Portfolio(params) -> (phi, psi)``
    (RP.py:29-235), on the key set of ``Multi Time Step.ipynb#28``.

    ``train=None`` trains at the JAX package's defaults (Adam, 500/100
    epochs, ``separate``); ``train`` overrides them. The survivors are exact
    binomial draws on the scan path, as the reference's (``binomial_mode``
    selects another thinning)."""
    res = pension_hedge(_shim_cfg(_cfg_from_params(params), train, binomial_mode),
                        device=device)
    return res.phi0, res.psi0


def replicating_portfolio_sv(params: dict, sv_c: float | None = None,
                             train: TrainConfig | None = None, *, binomial_mode: str = "exact",
                             device=None) -> tuple[float, float]:
    """SV-variant entry point (RP.py:237-459). The reference read the CIR
    vol-of-vol from ``params['c']`` and then overwrote it with the mortality
    drift (RP.py:249 vs :257), so its SV runs used c = 0.075. Pass ``sv_c``
    for the intended vol-of-vol, or omit it for the calibrated default
    0.01583; the mortality drift stays ``params['c']``. ``train`` (None: the
    JAX defaults) and ``binomial_mode`` as for :func:`replicating_portfolio`."""
    cfg = _cfg_from_params(params, sv_c=sv_c if sv_c is not None else StochVolConfig.c)
    res = pension_hedge(_shim_cfg(cfg, train, binomial_mode), device=device)
    return res.phi0, res.psi0
