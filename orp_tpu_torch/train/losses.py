"""Losses and metrics of the walk's two legs (counterpart of ``orp_tpu/train/losses.py``).

``mse`` is the expectation hedge's loss; ``pinball(q)`` the 0.99-quantile
hedge's (RP.py:138-142: ``mean(max(q e, (q-1) e))``, ``e = y - y_hat``) and
``smoothed_pinball`` its Huber-smoothed variant; ``mae`` and ``mape`` are the
per-date metrics the walk reports (the reference compiles them into its
models).
"""

from __future__ import annotations

import functools

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return torch.mean(d * d)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mape(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Mean absolute percentage error, in percent (Keras convention)."""
    return 100.0 * torch.mean(torch.abs((target - pred) / torch.clamp(torch.abs(target),
                                                                       min=eps)))


def pinball(pred: torch.Tensor, target: torch.Tensor, q: float = 0.99) -> torch.Tensor:
    """Quantile (pinball) loss at level ``q``, RP.py:138-142 semantics."""
    e = target - pred
    return torch.mean(torch.maximum(q * e, (q - 1.0) * e))


def smoothed_pinball(pred: torch.Tensor, target: torch.Tensor, q: float = 0.99,
                     delta: float = 1e-3) -> torch.Tensor:
    """Pinball with a quadratic Huber-smoothed kink of half-width ``delta``."""
    e = target - pred
    abs_e = torch.abs(e)
    quad = 0.5 * e * e / delta + 0.5 * delta
    rho = torch.where(abs_e <= delta, quad, abs_e)  # smoothed |e|
    return torch.mean(0.5 * rho + (q - 0.5) * e)


@functools.lru_cache(maxsize=None)
def make_loss(name: str, q: float = 0.99, delta: float = 1e-3):
    """Loss factory: ``'mse' | 'pinball' | 'smoothed_pinball'``. Cached, so
    repeated calls return the same function object, as in the JAX package."""
    if name == "mse":
        return mse
    if name == "pinball":
        return lambda p, t: pinball(p, t, q)
    if name == "smoothed_pinball":
        return lambda p, t: smoothed_pinball(p, t, q, delta)
    raise ValueError(f"unknown loss {name!r}")
