"""Risk analytics: VaR ledgers, residual P&L, fan charts, holdings (counterpart of
``orp_tpu/risk/analytics.py``).

Reductions run on the ledgers' device; the report holds host numpy arrays and
Python floats, exactly the JAX package's ``HedgeReport``. Under a paths mesh
(``build_report(..., mesh=)``) the ledgers are each rank's block of the paths:
means are path sums across the ranks, and the quantiles (VaR, fan chart) and
the residual stats gather the global ledger and apply the single-device rule,
so every rank holds the same report. ``to_frames`` is the
optional pandas edge; pandas is imported inside it only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orp_tpu_torch.parallel.mesh import path_gather, path_mean
from orp_tpu_torch.parallel.quantiles import quantile, sort_quantile

DEFAULT_VAR_QS = (0.98, 0.99, 0.995)
DEFAULT_FAN_QS = (0.01, 0.05, 0.10, 0.90, 0.95, 0.99)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _columnwise_quantiles(x: torch.Tensor, qs, method: str) -> np.ndarray:
    """Quantiles per column of ``x (n_paths, n_cols)`` -> ``(n_cols, n_q)``."""
    qs_t = torch.as_tensor(qs, dtype=x.dtype)
    if method == "sort":
        return _np(sort_quantile(x, qs_t, dim=0).T)
    return np.stack([_np(quantile(x[:, j], qs_t, method=method))
                     for j in range(x.shape[1])])


def var_by_date(residuals: torch.Tensor, qs=DEFAULT_VAR_QS, method: str = "sort") -> np.ndarray:
    """Per-date VaR quantiles of ``(n_paths, n_dates)`` residuals -> ``(n_dates, n_q)``."""
    return _columnwise_quantiles(residuals, qs, method)


def var_overall(residuals: torch.Tensor, qs=DEFAULT_VAR_QS, method: str = "sort") -> np.ndarray:
    """Pooled VaR over all dates and paths."""
    return _np(quantile(residuals.reshape(-1), qs, method=method))


@dataclasses.dataclass
class FanChart:
    """Quantile bands of portfolio value over time."""

    qs: np.ndarray      # (n_q,)
    bands: np.ndarray   # (n_knots, n_q)
    mean: np.ndarray    # (n_knots,)


def fan_chart(values: torch.Tensor, qs=DEFAULT_FAN_QS, method: str = "sort") -> FanChart:
    """Per-knot quantile bands and mean of ``values (n_paths, n_knots)``."""
    return FanChart(qs=np.asarray(qs), bands=_columnwise_quantiles(values, qs, method),
                    mean=_np(torch.mean(values, dim=0)))


def residual_pnl_stats(residual: torch.Tensor) -> dict[str, float]:
    """Mean / std (population) / min / max of terminal hedge residuals."""
    return {
        "mean": float(torch.mean(residual)),
        "std": float(torch.std(residual, correction=0)),
        "min": float(torch.min(residual)),
        "max": float(torch.max(residual)),
    }


def holdings_summary(phi: torch.Tensor, psi: torch.Tensor,
                     adjustment_factor: float = 1.0, mesh=None) -> dict:
    """Per-date mean holdings x ``adjustment_factor`` and the t=0 answer
    (over the global paths under ``mesh``)."""
    phi_mean = _np(path_mean(torch.mean(phi, dim=0), mesh)) * adjustment_factor
    psi_mean = _np(path_mean(torch.mean(psi, dim=0), mesh)) * adjustment_factor
    return {"phi_by_date": phi_mean, "psi_by_date": psi_mean,
            "phi0": float(phi_mean[0]), "psi0": float(psi_mean[0])}


def discounted_payoff_compare(values: torch.Tensor, terminal_payoff: torch.Tensor, r: float,
                              times) -> dict[str, np.ndarray]:
    """Portfolio value vs discounted expected payoff per knot (the P_E_Values
    ledger, RP.py:227; the E^Q/E^P reference lines of the ``Euro#20`` fan
    chart). ``times`` are the knot times ``(n_knots,)``; discounting uses
    ``exp(-r (T - t))``."""
    times = torch.as_tensor(times).to(terminal_payoff.device)
    T = times[-1]
    e_payoff = torch.mean(terminal_payoff)
    disc = torch.exp(-r * (T - times)) * e_payoff
    return {"mean_value": _np(torch.mean(values, dim=0)), "discounted_payoff": _np(disc)}


@dataclasses.dataclass
class HedgeReport:
    """The outputs of one hedge run (field for field the JAX package's report)."""

    v0: float
    phi0: float
    psi0: float
    discounted_payoff: float
    var_by_date: np.ndarray
    var_overall: np.ndarray
    var_qs: tuple
    residual_stats: dict
    fan: FanChart
    holdings: dict
    train_loss: np.ndarray
    train_mae: np.ndarray
    train_mape: np.ndarray
    epochs_ran: np.ndarray
    v0_plain: float | None = None
    v0_cv: float | None = None
    cv_std: float | None = None
    v0_acv: float | None = None
    acv_std: float | None = None
    times: np.ndarray | None = None
    oracle_mm: float | None = None  # the basket's moment-matched oracle price

    def summary(self) -> str:
        """The text form of the report (the JAX package's words and layout)."""
        qs = ", ".join(f"{q:.1%}: {v:,.4f}" for q, v in zip(self.var_qs, self.var_overall))
        if self.discounted_payoff != 0.0:
            diff = f"diff {100 * (self.v0 / self.discounted_payoff - 1):+.3f}%"
        else:
            diff = "diff n/a (zero payoff)"
        cv = ""
        if self.v0_cv is not None:
            cv = (f"\nunbiased QMC price = {self.v0_plain:,.4f}, "
                  f"hedged-CV price = {self.v0_cv:,.4f} (per-path std {self.cv_std:,.4f})")
        if self.v0_acv is not None:
            cv += (f"\nOLS-martingale price = {self.v0_acv:,.4f} "
                   f"(per-path std {self.acv_std:,.4f})")
        return (f"V0 = {self.v0:,.4f} (discounted E[payoff] = {self.discounted_payoff:,.4f}, "
                f"{diff})\n"
                f"phi0 = {self.phi0:,.4f}, psi0 = {self.psi0:,.4f}\n"
                f"overall VaR  {qs}\n"
                f"residual P&L mean {self.residual_stats['mean']:+.4f} "
                f"std {self.residual_stats['std']:.4f}" + cv)


def build_report(result, *, terminal_payoff: torch.Tensor, r: float, times,
                 adjustment_factor: float = 1.0, holdings_adjustment: float | None = None,
                 var_qs=DEFAULT_VAR_QS, fan_qs=DEFAULT_FAN_QS,
                 quantile_method: str = "sort", mesh=None) -> HedgeReport:
    """Assemble a :class:`HedgeReport` from a replayed ``BackwardResult``.

    ``adjustment_factor`` scales values; ``holdings_adjustment`` scales phi/psi
    (defaults to the same factor; the European pipeline passes 1.0). ``mesh``:
    the ledgers are this rank's block of the paths (module docstring)."""
    if holdings_adjustment is None:
        holdings_adjustment = adjustment_factor
    holdings = holdings_summary(result.phi, result.psi, holdings_adjustment, mesh)
    T = float(np.asarray(times)[-1])
    adj = adjustment_factor
    disc = float(path_mean(torch.mean(terminal_payoff), mesh)) * float(np.exp(-r * T)) * adj
    values = path_gather(result.values, mesh)
    var_res = path_gather(result.var_residuals, mesh)
    fan = fan_chart(values, fan_qs, method=quantile_method)
    fan = FanChart(qs=fan.qs, bands=fan.bands * adj, mean=fan.mean * adj)
    resid = residual_pnl_stats(var_res[:, -1])
    return HedgeReport(
        v0=float(path_mean(torch.mean(result.v0), mesh)) * adj,
        phi0=holdings["phi0"],
        psi0=holdings["psi0"],
        discounted_payoff=disc,
        var_by_date=var_by_date(var_res, var_qs, method=quantile_method) * adj,
        var_overall=var_overall(var_res, var_qs, method=quantile_method) * adj,
        var_qs=tuple(var_qs),
        residual_stats={k: v * adj for k, v in resid.items()},
        fan=fan,
        holdings=holdings,
        train_loss=result.train_loss,
        train_mae=result.train_mae,
        train_mape=result.train_mape,
        epochs_ran=result.epochs_ran,
        times=np.asarray(times),
    )


def to_frames(report: HedgeReport) -> dict:
    """Pandas-frame edge for notebook-style consumers (the shapes of
    ``Multi Time Step.ipynb#22-26``): VaR-by-date, holdings-by-date, fan-chart
    bands, and per-date training errors, all indexed by rebalance time.

    Pandas is imported here only: the analytics path stays array-native.
    """
    import pandas as pd

    times = report.times
    date_times = times[:-1] if times is not None else np.arange(len(report.train_loss))
    knot_times = times if times is not None else np.arange(report.fan.bands.shape[0])
    var = pd.DataFrame(
        report.var_by_date,
        index=pd.Index(date_times, name="time"),
        columns=[f"VaR_{q:g}" for q in report.var_qs],
    )
    holdings = pd.DataFrame(
        {
            "phi": report.holdings["phi_by_date"],
            "psi": report.holdings["psi_by_date"],
        },
        index=pd.Index(date_times, name="time"),
    )
    fan = pd.DataFrame(
        np.column_stack([report.fan.bands, report.fan.mean]),
        index=pd.Index(knot_times, name="time"),
        columns=[f"q{q:g}" for q in report.fan.qs] + ["mean"],
    )
    errors = pd.DataFrame(
        {
            "loss": report.train_loss,
            "mae": report.train_mae,
            "mape": report.train_mape,
            "epochs": report.epochs_ran,
        },
        index=pd.Index(date_times, name="time"),
    )
    return {"var": var, "holdings": holdings, "fan": fan, "errors": errors}
