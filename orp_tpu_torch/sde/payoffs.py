"""Payoff / liability layer (counterpart of ``orp_tpu/sde/payoffs.py``)."""

from __future__ import annotations

import torch


def call(s_T: torch.Tensor, strike: float) -> torch.Tensor:
    return torch.clamp(s_T - strike, min=0.0)


def put(s_T: torch.Tensor, strike: float) -> torch.Tensor:
    return torch.clamp(strike - s_T, min=0.0)


def european(s_T: torch.Tensor, strike: float, option_type: str) -> torch.Tensor:
    """``option_type``-switched European payoff."""
    if option_type not in ("call", "put"):
        raise ValueError(f"option_type must be 'call' or 'put', got {option_type!r}")
    return call(s_T, strike) if option_type == "call" else put(s_T, strike)


def basket_call(s_T: torch.Tensor, weights, strike: float) -> torch.Tensor:
    """Arithmetic basket call on terminal prices ``s_T (n, A)`` (full f32 weighting)."""
    w = torch.as_tensor(weights, dtype=s_T.dtype, device=s_T.device)
    return torch.clamp(s_T @ w - strike, min=0.0)


def pension_floor(y_T: torch.Tensor, guarantee: float) -> torch.Tensor:
    """Per-unit pension payoff ``max(Y_T, K)``."""
    return torch.clamp(y_T, min=guarantee)


def pension_liability(y_T: torch.Tensor, n_T: torch.Tensor, premium: float,
                      guarantee: float) -> torch.Tensor:
    """Aggregate liability ``S_T = max(Y_T, K) * N_T * P``."""
    return pension_floor(y_T, guarantee) * n_T * premium


def out_of_money_prob(y_T: torch.Tensor, ref_level: float) -> torch.Tensor:
    """``P(Y_T < ref)``."""
    return (y_T < ref_level).to(y_T.dtype).mean()
