"""One date's Levenberg-Marquardt-damped Gauss-Newton fit, in plain PyTorch.

Each iteration forms ``G = Jw^T J / n`` and ``b = Jw^T r / n`` (``r = pred -
target``), solves ``(G + (lam * (mean diag G + ridge) + ridge) I) delta = b``,
and takes ``theta - delta`` only if the true loss falls (damping times 1/3),
else keeps ``theta`` (damping times 3, within [1e-10, 1e10]). An accepted step
that gains less than ``min_rel_improve`` of the loss freezes the fit.

- ``loss="mse"``: ``W = I``, the mean squared residual.
- ``loss="pinball"``: the 0.99-quantile leg by IRLS, ``w = a / max(|r|,
  floor)`` with ``a = q`` where ``r < 0`` and ``1 - q`` elsewhere; accept and
  reject on the pinball loss ``mean(max(q e, (q - 1) e))``, ``e = target - pred``.

``fault`` plants one of the faults a training step can have, for the checks
of the comparison itself: ``"half"`` fits on the first half of the rows only,
``"frozen"`` returns the starting params.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import mlp


@dataclasses.dataclass(frozen=True)
class LM:
    """A fit's settings; :func:`leg` takes them from a configuration's ``gn`` block."""

    n_iters: int
    init_lambda: float
    lambda_up: float
    lambda_down: float
    min_rel_improve: float
    ridge: float
    loss: str = "mse"
    q: float = 0.99
    weight_floor: float = 1e-3


def leg(cfg: dict, n_iters: int, which: str) -> LM:
    """The fit of leg ``mse`` or ``q`` (the quantile leg) with the
    configuration's ``gn`` block: the quantile leg starts its damping at
    ``quantile_init_lambda`` and floors its IRLS weights at ``weight_floor``."""
    g = cfg["gn"]
    common = dict(n_iters=n_iters, lambda_up=g["lambda_up"], lambda_down=g["lambda_down"],
                  min_rel_improve=g["min_rel_improve"], ridge=g["ridge"])
    if which == "mse":
        return LM(init_lambda=g["init_lambda"], **common)
    return LM(init_lambda=g["quantile_init_lambda"], loss="pinball", q=cfg["train"]["quantile"],
              weight_floor=g["weight_floor"], **common)


def loss_of(kind: str, q: float, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if kind == "mse":
        d = pred - target
        return torch.mean(d * d)
    e = target - pred
    return torch.mean(torch.maximum(q * e, (q - 1.0) * e))


def fit(params: dict, x: torch.Tensor, prices: torch.Tensor, y: torch.Tensor, cfg: LM,
        fault: str | None = None) -> dict:
    """The fitted params from ``params`` on rows ``(x, prices, y)``."""
    if fault == "frozen":
        return {k: v.clone() for k, v in params.items()}
    if fault == "half":
        half = x.shape[0] // 2
        x, prices, y = x[:half], prices[:half], y[:half]
    n_feat = x.shape[1]
    n = y.shape[0]
    theta = mlp.flatten(params).to(x.device).clone()
    eye = torch.eye(theta.shape[0], dtype=theta.dtype, device=x.device)

    def loss(th):
        return loss_of(cfg.loss, cfg.q, mlp.value(mlp.unflatten(th, n_feat), x, prices), y)

    lam = torch.full((), cfg.init_lambda, dtype=theta.dtype, device=x.device)
    best = loss(theta)
    frozen = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(cfg.n_iters):
        v, J = mlp.value_jacobian(mlp.unflatten(theta, n_feat), x, prices)
        r = v - y
        Jw = J
        if cfg.loss == "pinball":
            a = torch.where(r < 0, cfg.q, 1.0 - cfg.q)
            Jw = J * (a / torch.clamp(torch.abs(r), min=cfg.weight_floor))[:, None]
        G = Jw.T @ J / n
        b = Jw.T @ r / n
        scale = torch.mean(torch.diagonal(G)) + cfg.ridge
        # no error check: a singular system gives a non-finite step, whose loss is
        # not below the best, so the step is rejected and the damping rises
        delta = torch.linalg.solve_ex(G + (lam * scale + cfg.ridge) * eye, b)[0]
        cand = theta - delta
        cand_loss = loss(cand)
        take = (cand_loss < best) & ~frozen
        gain = (best - cand_loss) / torch.clamp(best, min=1e-30)
        frozen_next = frozen | (take & (gain < cfg.min_rel_improve))
        lam_next = torch.clamp(torch.where(take, lam * cfg.lambda_down, lam * cfg.lambda_up),
                               1e-10, 1e10)
        lam = torch.where(frozen, lam, lam_next)
        theta = torch.where(take, cand, theta)
        best = torch.where(take, cand_loss, best)
        frozen = frozen_next
    return mlp.unflatten(theta, n_feat)
