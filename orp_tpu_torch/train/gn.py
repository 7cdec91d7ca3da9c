"""Levenberg-Marquardt-damped Gauss-Newton fits of the walk's two legs (counterpart of ``orp_tpu/train/gn.py``).

The per-date fit is a ~100-parameter nonlinear problem over up to 1M
samples. Each iteration is one large product pair

    G = J^T W J / n   (P x P weighted Gram of the per-sample value gradients)
    b = J^T W r / n   (normal-equations right-hand side, r = pred - y)

then a damped solve ``(G + (lam * mean(diag G) + ridge) I) delta = b``, the
candidate ``theta - delta`` and its TRUE loss: the step is taken only if the
loss falls (damping down), else rejected (damping up). An accepted step that
improves the loss by less than ``min_rel_improve`` freezes the fit.

- :func:`fit_gn`, the MSE leg: ``W = I``, plain damped Gauss-Newton.
- :func:`fit_gn_pinball`, the 0.99-quantile leg (reference model2,
  RP.py:138-142): IRLS. The pinball loss is an asymmetric L1, so each
  iteration solves the weighted least squares that majorises it at the
  current residuals, ``w = a(r) / max(|r|, floor)`` with ``a = q`` where
  ``r = pred - y < 0`` and ``1 - q`` elsewhere; accept/reject runs on the
  true (smoothed) pinball loss. The weights span three decades (at q = 0.99
  about 1% of rows carry the upper branch).

The loop stays on the device: accept/reject and the freeze are
``torch.where`` selections on 0-d tensors and the solve is
``torch.linalg.solve_ex`` (no error check, so no host sync); nothing is read
back per iteration. A frozen iteration still computes its step (no host
branch can skip it without a sync) but leaves theta, the damping and the
loss unchanged and records ``inf`` in ``loss_history``, as the JAX
``skip`` branch does.

``J`` is the closed-form per-sample gradient (``HedgeMLP.value_jacobian``),
one ``(n, P)`` buffer reused across iterations (456 MB at 1M paths and
P = 114), or ``(block_rows, P)`` when ``block_rows`` accumulates the Gram
over row blocks; the IRLS leg writes ``J w`` into a second buffer of the
same shape (JAX's order: weight J, then the product). Products run in full
f32 (``utils/precision.full_f32``):
normal equations square the condition number, and a reduced-precision Gram
moved the north-star price by -2.4bp on the TPU (SCALING.md §6b); TF32 is
the same hazard on this card.
"""

from __future__ import annotations

import dataclasses

import torch

from orp_tpu_torch.train.losses import mae, mape, mse
from orp_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class GNConfig:
    n_iters: int = 12
    init_lambda: float = 1e-4      # LM damping, relative to mean(diag(G))
    lambda_up: float = 3.0
    lambda_down: float = 1 / 3
    min_rel_improve: float = 1e-7  # freeze once an accepted step gains less
    ridge: float = 1e-9            # absolute floor added to the damped diagonal
    block_rows: int | None = None  # accumulate the Gram over row blocks of this
    # size instead of materialising the (n, P) Jacobian; must divide n


@dataclasses.dataclass(frozen=True)
class GNPinballConfig(GNConfig):
    """IRLS weights of the quantile leg, ``w = a(r) / max(|r|, weight_floor)``;
    the floor caps the weight of near-zero residuals (the smoothed pinball's
    kink half-width). LM starts more cautiously than the MSE leg's 1e-4: the
    asymmetric-L1 majoriser is a rougher model than the MSE's quadratic."""

    q: float = 0.99
    weight_floor: float = 1e-3
    init_lambda: float = 1e-2


class _GNProblem:
    """One date's regression ``value(theta; features, prices) ~ targets``
    under ``loss_fn``; ``weights``, when given, are the IRLS weights
    ``(q_hi, q_lo, floor)`` of the pinball leg."""

    def __init__(self, model, features, prices, targets, cfg: GNConfig, loss_fn=mse,
                 weights: tuple[float, float, float] | None = None):
        self.model, self.features, self.prices, self.cfg = model, features, prices, cfg
        self.loss_fn = loss_fn
        self.y = targets.to(model.dtype)
        self.n = self.y.shape[0]
        block = cfg.block_rows
        self.block = block if block is not None and self.n > block else None
        if self.block is not None and self.n % self.block:
            # the knob exists to bound fit memory; a silent one-shot fallback
            # would allocate exactly the Jacobian it was set to avoid
            raise ValueError(f"block_rows={block} does not divide n={self.n} rows — pick a "
                             "divisor (n <= block_rows needs no blocking and is accepted)")
        dim = model.n_params()
        dev = self.y.device
        rows = self.block or self.n
        self.J = torch.empty((rows, dim), dtype=model.dtype, device=dev)
        self.eye = torch.eye(dim, dtype=model.dtype, device=dev)
        self.Jw, self.w = None, None
        if weights is not None:
            self.Jw = torch.empty_like(self.J)
            q_hi, q_lo, self.floor = weights
            self.w = (torch.full((), q_hi, dtype=model.dtype, device=dev),
                      torch.full((), q_lo, dtype=model.dtype, device=dev))

    def loss(self, theta: torch.Tensor) -> torch.Tensor:
        pred = self.model.value(self.model.unflatten(theta), self.features, self.prices)
        return self.loss_fn(pred, self.y)

    def _weighted(self, J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """``J`` for the MSE leg; ``J * w[:, None]`` into the reused buffer for IRLS."""
        if self.w is None:
            return J
        a = torch.where(r < 0, *self.w)
        w = a / torch.clamp(torch.abs(r), min=self.floor)
        return torch.mul(J, w[:, None], out=self.Jw)

    def gram(self, theta: torch.Tensor):
        """``(Jw^T J / n, Jw^T r / n)``, one-shot or summed over row blocks."""
        params = self.model.unflatten(theta)
        if self.block is None:
            v, J = self.model.value_jacobian(params, self.features, self.prices, out=self.J)
            r = v - self.y
            Jw = self._weighted(J, r)
            return Jw.T @ J / self.n, Jw.T @ r / self.n
        G, b = torch.zeros_like(self.eye), torch.zeros_like(theta)
        for s in range(0, self.n, self.block):
            rows = slice(s, s + self.block)
            v, J = self.model.value_jacobian(params, self.features[rows], self.prices[rows],
                                             out=self.J)
            r = v - self.y[rows]
            Jw = self._weighted(J, r)
            G += Jw.T @ J
            b += Jw.T @ r
        return G / self.n, b / self.n


def _lm_step(problem: _GNProblem, theta, lam, best_loss, frozen):
    """One LM iteration on 0-d device tensors; returns the new
    ``(theta, lam, best_loss, frozen)``, the iteration's history entry and
    whether the step was taken."""
    cfg = problem.cfg
    G, b = problem.gram(theta)
    diag_scale = torch.mean(torch.diagonal(G)) + cfg.ridge
    delta = torch.linalg.solve_ex(G + (lam * diag_scale + cfg.ridge) * problem.eye, b)[0]
    cand = theta - delta
    cand_loss = problem.loss(cand)
    take = (cand_loss < best_loss) & ~frozen
    rel_gain = (best_loss - cand_loss) / torch.clamp(best_loss, min=1e-30)
    frozen_next = frozen | (take & (rel_gain < cfg.min_rel_improve))
    theta = torch.where(take, cand, theta)
    best_loss = torch.where(take, cand_loss, best_loss)
    lam_next = torch.clamp(torch.where(take, lam * cfg.lambda_down, lam * cfg.lambda_up),
                           1e-10, 1e10)
    lam = torch.where(frozen, lam, lam_next)
    # history: the post-accept achieved loss (monotone), inf once frozen
    hist = torch.where(frozen, torch.full_like(best_loss, float("inf")), best_loss)
    return theta, lam, best_loss, frozen_next, hist, take


def _fit(problem: _GNProblem, params: dict, final_solve: bool):
    """The LM loop on the device, then the result and its aux tensors."""
    model, cfg = problem.model, problem.cfg
    theta = model.flatten(params).to(device=problem.y.device, dtype=model.dtype)
    lam = torch.tensor(cfg.init_lambda, dtype=model.dtype, device=theta.device)
    best_loss = problem.loss(theta)
    frozen = torch.zeros((), dtype=torch.bool, device=theta.device)
    hist, takes = [], []
    for _ in range(cfg.n_iters):
        theta, lam, best_loss, frozen, h, take = _lm_step(problem, theta, lam, best_loss,
                                                          frozen)
        hist.append(h)
        takes.append(take)
    best = model.unflatten(theta)
    if final_solve:
        best = model.solve_readout(best, problem.features, problem.prices, problem.y)
    pred = model.value(best, problem.features, problem.prices)
    y = problem.y
    aux = {
        "loss_history": torch.stack(hist) if hist else theta.new_zeros(0),
        "n_epochs_ran": (torch.stack(takes).sum() if takes
                         else torch.zeros((), dtype=torch.int64, device=theta.device)),
        "final_loss": problem.loss_fn(pred, y),
        "mae": mae(pred, y),
        "mape": mape(pred, y),
    }
    aux["best_loss"] = aux["final_loss"] if final_solve else best_loss
    return best, aux


def fit_gn(model, params: dict, features: torch.Tensor, prices: torch.Tensor,
           targets: torch.Tensor, *, loss_fn=mse, cfg: GNConfig = GNConfig(),
           final_solve: bool = False):
    """Fit ``model``'s value at ``(features, prices)`` to ``targets`` by damped GN.

    Returns ``(best_params, aux)``; ``aux`` holds device tensors:
    ``loss_history`` (per iteration, post-accept loss, ``inf`` past the
    freeze), ``n_epochs_ran`` (accepted iterations), ``best_loss``,
    ``final_loss`` and the ``mae`` / ``mape`` metrics at the result.
    ``final_solve`` replaces the readout with ``model.solve_readout`` after
    the iterations (``best_loss`` is then the final loss)."""
    if loss_fn is not mse:
        # GN minimises mean squared residuals by construction; another loss
        # would be ignored by the iterations while aux reported it
        raise ValueError("fit_gn optimises the MSE only; got a different loss_fn "
                         "(the quantile leg uses fit_gn_pinball)")
    full_f32()
    return _fit(_GNProblem(model, features, prices, targets, cfg), params, final_solve)


def fit_gn_pinball(model, params: dict, features: torch.Tensor, prices: torch.Tensor,
                   targets: torch.Tensor, *, loss_fn, cfg: GNPinballConfig = GNPinballConfig(),
                   final_solve: bool = False):
    """IRLS Gauss-Newton for the quantile (pinball) leg, with :func:`fit_gn`'s
    aux contract. ``loss_fn`` must be the pinball (or smoothed pinball) at
    ``cfg.q``: accept/reject optimises it, while the weighted normal
    equations supply the step. ``final_solve`` is refused: a least-squares
    readout is not the pinball optimum and would undo the fit."""
    if final_solve:
        raise ValueError("fit_gn_pinball: final_solve (closed-form least-squares readout) "
                         "does not apply to the pinball objective")
    full_f32()
    problem = _GNProblem(model, features, prices, targets, cfg, loss_fn=loss_fn,
                         weights=(cfg.q, 1.0 - cfg.q, cfg.weight_floor))
    return _fit(problem, params, False)
