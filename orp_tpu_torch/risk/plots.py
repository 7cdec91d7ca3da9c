"""Matplotlib reporting: the reference notebooks' chart set from a HedgeReport
(counterpart of ``orp_tpu/risk/plots.py``, copied).

Parity targets (SURVEY.md §2 row 15):
- portfolio-value fan chart with quantile bands + discounted-payoff line
  (``European Options.ipynb#20``, ``Multi Time Step.ipynb#26``)
- phi/psi distributions over rebalance dates — violins (``Multi#25``, ``Euro#18``)
- residual P&L scatter vs terminal underlying (``Euro#15``)
- VaR-over-time curves with a zero line (``Multi#23``, ``Euro#16``)
- per-step training-error curve (``Multi#26``; the ``Errors`` ledger)

All functions take plain arrays, tensors (on any device: they are read
back with ``.detach().cpu().numpy()``) or report objects, draw on a provided
or fresh Axes, and never require pandas/seaborn (violin via
``Axes.violinplot``). Matplotlib is imported inside the drawing call only —
nothing else in the package touches it.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ax(ax):
    if ax is None:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(10, 5))
    return ax


def fan_chart(report, times, *, ax=None, payoff_line: bool = True):
    """Quantile-band fan of portfolio value over time (Euro#20 shape)."""
    ax = _ax(ax)
    fan = report.fan
    t = _host(times)
    n_q = fan.bands.shape[1]
    for i in range(n_q // 2):
        ax.fill_between(
            t, fan.bands[:, i], fan.bands[:, n_q - 1 - i],
            alpha=0.15, color="tab:blue", linewidth=0,
        )
    ax.plot(t, fan.mean, color="tab:blue", label="mean portfolio value")
    if payoff_line:
        ax.axhline(report.discounted_payoff, color="tab:orange", linestyle="--",
                   label="discounted E[payoff]")
    ax.set_xlabel("t (years)")
    ax.set_ylabel("V(t)")
    ax.legend()
    return ax


def holdings_violins(phi, psi, times, *, ax=None, max_dates: int = 20):
    """phi/psi per-date distributions as split violins (Multi#25 shape).

    ``phi``/``psi`` are ``(n_paths, n_dates)`` ledgers; ``times`` the date grid.
    Dates are subsampled to ``max_dates`` for readability.
    """
    ax = _ax(ax)
    phi = _host(phi)
    psi = _host(psi)
    t = _host(times)[: phi.shape[1]]
    stride = max(1, phi.shape[1] // max_dates)
    sel = np.arange(0, phi.shape[1], stride)
    width = 0.8 * (t[stride] - t[0]) if len(t) > stride else 0.5
    for data, color, label in ((phi, "tab:blue", "phi"), (psi, "tab:orange", "psi")):
        parts = ax.violinplot(
            [data[:, i] for i in sel], positions=t[sel], widths=width,
            showmeans=True, showextrema=False,
        )
        for body in parts["bodies"]:
            body.set_facecolor(color)
            body.set_alpha(0.4)
        parts["cmeans"].set_color(color)
        ax.plot([], [], color=color, label=label)
    ax.set_xlabel("rebalance date (years)")
    ax.set_ylabel("holdings")
    ax.legend()
    return ax


def residual_scatter(residuals_T, underlying_T, *, ax=None):
    """Terminal hedge-residual P&L vs underlying (Euro#15 shape)."""
    ax = _ax(ax)
    ax.scatter(_host(underlying_T), _host(residuals_T), s=2, alpha=0.3)
    ax.axhline(0.0, color="k", linewidth=0.8)
    ax.set_xlabel("S(T)")
    ax.set_ylabel("replication residual at T")
    return ax


def var_over_time(report, times, *, ax=None):
    """Per-date VaR quantile curves with a zero line (Multi#23 shape)."""
    ax = _ax(ax)
    t = _host(times)[: report.var_by_date.shape[0]]
    for j, q in enumerate(report.var_qs):
        ax.plot(t, report.var_by_date[:, j], label=f"VaR {q:.1%}")
    ax.axhline(0.0, color="k", linewidth=0.8)
    ax.set_xlabel("rebalance date (years)")
    ax.set_ylabel("residual quantile")
    ax.legend()
    return ax


def training_error_curve(report, times, *, ax=None):
    """Per-date fit MAE/MAPE (the Errors ledger plot, Multi#26 shape)."""
    ax = _ax(ax)
    t = _host(times)[: len(report.train_mae)]
    ax.plot(t, report.train_mae, label="MAE")
    ax.set_xlabel("rebalance date (years)")
    ax.set_ylabel("MAE", color="tab:blue")
    ax2 = ax.twinx()
    ax2.plot(t, report.train_mape, color="tab:orange", label="MAPE %")
    ax2.set_ylabel("MAPE %", color="tab:orange")
    return ax
