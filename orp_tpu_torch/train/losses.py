"""Loss and metrics of the MSE leg (counterpart of ``orp_tpu/train/losses.py``).

``mse`` is the expectation hedge's loss; ``mae`` and ``mape`` are the
per-date metrics the walk reports (the reference compiles them into its
models). The pinball losses arrive with the quantile leg.
"""

from __future__ import annotations

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
