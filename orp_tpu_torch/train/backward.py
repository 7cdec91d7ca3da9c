"""Backward-walk result types and the per-date outputs, inference subset.

Counterpart of the parts of ``orp_tpu/train/backward.py`` that replay and
serving read: :func:`_stack_prices`, :func:`_date_outputs_core` (all three
``dual_mode`` combines and both ``holdings_combine`` conventions),
:func:`_split_holdings`, the :class:`BackwardConfig` fields a replay reads and
:class:`BackwardResult`. The Gauss-Newton walk that produces the per-date
params is training and is not ported yet.

``dual_mode``: ``"separate"`` (two param sets, ``v = g + i(h - g)``),
``"shared"`` (one param set; the ledger holdings read the quantile weights)
and ``"mse_only"`` (quantile branch off). ``holdings_combine``: ``"single"``
(``phi1 + i(phi2 - phi1)``) or ``"py"`` (the reference's sign quirk
``phi1 + i(phi1 - phi2)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

DUAL_MODES = ("separate", "shared", "mse_only")
HOLDINGS_COMBINES = ("single", "py")


def _stack_prices(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y (n, knots)`` -> ``(n, knots, 2)`` (risky, bond); ``y (n, knots, A)``
    -> ``(n, knots, A+1)``. The bond is always last."""
    if y.ndim == 3:
        bcol = b[None, :, None].expand(*y.shape[:2], 1)
        return torch.cat([y, bcol], dim=-1)
    return torch.stack([y, b[None, :].expand(y.shape)], dim=-1)


def _date_outputs_core(model, params1, params2, feats_t, prices_t, prices_t1, target,
                       cost_of_capital, g_pre, *, dual_mode, holdings_combine):
    """Per-date value, combined holdings and next-date replication residual.

    ``shared``: ``g_pre`` is the value under the weights right after the MSE
    fit; the holdings ledger reads ``params2``."""
    if dual_mode == "shared":
        h_t = model.value(params2, feats_t, prices_t)
        v_t = g_pre + cost_of_capital * (h_t - g_pre)
        comb = model.holdings(params2, feats_t)
        return v_t, comb, target - torch.sum(comb * prices_t1, dim=-1)
    g_t = model.value(params1, feats_t, prices_t)
    if dual_mode == "mse_only":
        v_t = g_t
    else:
        h_t = model.value(params2, feats_t, prices_t)
        v_t = g_t + cost_of_capital * (h_t - g_t)
    h1 = model.holdings(params1, feats_t)
    if dual_mode == "mse_only":
        comb = h1
    else:
        h2 = model.holdings(params2, feats_t)
        if holdings_combine == "py":
            comb = h1 + cost_of_capital * (h1 - h2)
        else:
            comb = h1 + cost_of_capital * (h2 - h1)
    var_resid = target - torch.sum(comb * prices_t1, dim=-1)
    return v_t, comb, var_resid


def _split_holdings(comb: torch.Tensor):
    """``(..., k)`` holdings -> ``(phi, psi)``: scalar phi for the 2-instrument
    head, per-asset phi ``(..., A)`` for a vector hedge; the bond is last."""
    if comb.shape[-1] == 2:
        return comb[..., 0], comb[..., 1]
    return comb[..., :-1], comb[..., -1]


def date_params(params_by_date: dict, t: int) -> dict:
    """Date ``t``'s params out of the stacked ``{name: (D, ...)}`` dict."""
    return {k: v[t] for k, v in params_by_date.items()}


def params_to(params_by_date: dict | None, device, dtype) -> dict | None:
    """Per-date params (numpy arrays or tensors) as contiguous tensors on ``device``."""
    if params_by_date is None:
        return None
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype).contiguous()
            for k, v in params_by_date.items()}


@dataclasses.dataclass(frozen=True)
class BackwardConfig:
    """The walk's combine semantics: the fields a replay reads."""

    cost_of_capital: float = 0.1
    dual_mode: str = "separate"
    holdings_combine: str = "single"

    def __post_init__(self):
        if self.dual_mode not in DUAL_MODES:
            raise ValueError(f"dual_mode={self.dual_mode!r}: expected one of {DUAL_MODES}")
        if self.holdings_combine not in HOLDINGS_COMBINES:
            raise ValueError(
                f"holdings_combine={self.holdings_combine!r}: expected one of "
                f"{HOLDINGS_COMBINES}")


@dataclasses.dataclass
class BackwardResult:
    """Ledgers of a walk; the time axis is the rebalance-date index, ascending."""

    values: Any               # (n_paths, n_dates+1) incl. terminal
    phi: Any                  # (n_paths, n_dates) or (n_paths, n_dates, A)
    psi: Any                  # (n_paths, n_dates)
    var_residuals: Any        # (n_paths, n_dates) next-date replication residuals
    train_loss: np.ndarray    # (n_dates,) per-date fit metrics of the training run
    train_mae: np.ndarray
    train_mape: np.ndarray
    epochs_ran: np.ndarray
    params1: Any = None
    params2: Any = None
    params1_by_date: Any = None  # {name: (n_dates, ...)} the per-date policy
    params2_by_date: Any = None

    @property
    def v0(self) -> torch.Tensor:
        """t=0 portfolio value per path; its mean is the network's price."""
        return self.values[:, 0]

    @classmethod
    def from_policy_state(cls, state: dict) -> "BackwardResult":
        """A params-only result (ledgers None), for replay and serving."""
        return cls(
            values=None, phi=None, psi=None, var_residuals=None,
            train_loss=np.asarray(state["train_loss"]),
            train_mae=np.asarray(state["train_mae"]),
            train_mape=np.asarray(state["train_mape"]),
            epochs_ran=np.asarray(state["epochs_ran"]).astype(np.int64),
            params1_by_date=state["params1_by_date"],
            params2_by_date=state.get("params2_by_date"),
        )
