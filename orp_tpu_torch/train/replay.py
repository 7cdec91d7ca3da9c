"""Out-of-sample hedge replay (counterpart of ``orp_tpu/train/replay.py``).

Evaluates a trained walk's per-date params on fresh paths with no training:
each date's value is a direct prediction at that date's features and prices,
so the dates are independent (a Python loop here, a ``lax.scan`` in JAX);
the residual at date t is measured against the REPLAYED next-date value
(the terminal payoff at the last date), as in the training walk's ledger.
"""

from __future__ import annotations

import warnings

import torch

from orp_tpu_torch.train.backward import (
    BackwardConfig,
    BackwardResult,
    _date_outputs_core,
    _split_holdings,
    _stack_prices,
    date_params,
)


def replay_walk(model, result: BackwardResult, features: torch.Tensor,
                y_prices: torch.Tensor, b_prices: torch.Tensor,
                terminal_values: torch.Tensor, cfg: BackwardConfig) -> BackwardResult:
    """Replay ``result``'s per-date params on fresh paths.

    ``features (n, n_dates+1, n_features)``, ``y_prices (n, n_dates+1[, A])``,
    ``b_prices (n_dates+1,)``, ``terminal_values (n,)``, all on one device
    with ``result``'s params. Training metrics carry over unchanged.
    """
    if result.params1_by_date is None:
        raise ValueError("result has no per-date params (params1_by_date is None)")
    if cfg.dual_mode == "shared":
        warnings.warn(
            "replay_walk with dual_mode='shared': the stored per-date snapshot "
            "is the post-quantile-fit weights, so the replayed v_t collapses to "
            "the quantile model's value. Holdings and residuals are unaffected.",
            stacklevel=2)
    dt = model.dtype
    prices_all = _stack_prices(y_prices.to(dt), b_prices.to(dt))
    terminal = terminal_values.to(dt)
    p1_all = result.params1_by_date
    p2_all = p1_all if result.params2_by_date is None else result.params2_by_date
    n_dates = prices_all.shape[1] - 1
    v_cols, combs = [], []
    for t in range(n_dates):
        p1, p2 = date_params(p1_all, t), date_params(p2_all, t)
        feats_t, prices_t = features[:, t], prices_all[:, t]
        g_pre = (model.value(p1, feats_t, prices_t) if cfg.dual_mode == "shared"
                 else torch.zeros((), dtype=dt, device=features.device))
        v_t, comb, _ = _date_outputs_core(
            model, p1, p2, feats_t, prices_t, prices_all[:, t + 1], terminal,
            cfg.cost_of_capital, g_pre,
            dual_mode=cfg.dual_mode, holdings_combine=cfg.holdings_combine)
        v_cols.append(v_t)
        combs.append(comb)
    values = torch.stack(v_cols + [terminal], dim=1)
    combs = torch.stack(combs, dim=1)                       # (n, n_dates, k)
    gains = torch.sum(combs * prices_all[:, 1:], dim=-1)    # comb_t . prices_{t+1}
    var_resid = values[:, 1:] - gains
    phi, psi = _split_holdings(combs)
    return BackwardResult(
        values=values, phi=phi, psi=psi, var_residuals=var_resid,
        train_loss=result.train_loss, train_mae=result.train_mae,
        train_mape=result.train_mape, epochs_ran=result.epochs_ran,
        params1=result.params1, params2=result.params2,
        params1_by_date=result.params1_by_date,
        params2_by_date=result.params2_by_date)
