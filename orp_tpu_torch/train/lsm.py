"""Least-squares Monte-Carlo (Longstaff-Schwartz) Bermudan pricing
(counterpart of ``orp_tpu/train/lsm.py``).

The optimal-stopping companion of the backward walk: each exercise date
compares intrinsic value against a regressed continuation value and
exercises where intrinsic wins (the Longstaff-Schwartz 2001 realized-cashflow
form).

- The walk is a Python loop over the ``m - 1`` exercise dates (the JAX
  package's ``lax.scan``). The classical "regress only ITM paths" restriction
  is a WEIGHTED normal-equations solve (weight = ITM indicator), so every
  array stays (n_paths,).
- Paths are scrambled Sobol from the scan simulators (``simulate_gbm_log``,
  ``sde.heston_sim_fn``), stored at exercise dates only (``store_every``).
- The basis is every monomial of the features STANDARDIZED over the ITM set,
  up to a total degree; the B x B Gram is solved by a Cholesky factor
  (``cholesky_ex``: no host sync a date) with a relative ridge and an absolute
  floor, in full f32 (TF32 off: a Gram of powers is the conditioning regime
  of SCALING.md §6b, §6f).

Estimator notes: the regressed-policy price is a LOW-biased lower bound from
a suboptimal policy, with O(paths^-1/2) noise on top; discrete exercise
dates make Bermudan < American. The oracle is the CRR tree (``utils/crr.py``).
Entry points run on the card unless ``device`` (or an ``indices`` tensor)
says otherwise.
"""

from __future__ import annotations

import math

import torch

from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import heston_sim_fn, simulate_gbm_log
from orp_tpu_torch.utils.device import path_indices
from orp_tpu_torch.utils.precision import full_f32


def _monomial_exponents(n_features: int, degree: int) -> tuple[tuple[int, ...], ...]:
    """All exponent tuples with total degree <= ``degree`` (the static basis
    layout; for one feature this is exactly ``1, z, z^2, ..., z^degree``)."""
    exps: list[tuple[int, ...]] = []

    def rec(prefix: tuple[int, ...], remaining: int, budget: int):
        if remaining == 0:
            exps.append(prefix)
            return
        for e in range(budget + 1):
            rec(prefix + (e,), remaining - 1, budget - e)

    rec((), n_features, degree)
    # sort by total degree then lexicographic: constant column first
    exps.sort(key=lambda t: (sum(t), t))
    return tuple(exps)


def _regress_date(vd: torch.Tensor, f: torch.Tensor, pay: torch.Tensor,
                  exps: tuple[tuple[int, ...], ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """One exercise date's regression of the discounted realized cashflow
    ``vd`` (n,) on the basis of features ``f`` (n, F) over the ITM paths
    (``pay > 0``): ``(beta (B,), continuation value (n,))``."""
    n_basis = len(exps)
    itm = (pay > 0.0).to(pay.dtype)
    # standardize every feature over the ITM set BEFORE taking powers: the
    # Gram of raw powers is ill-conditioned enough that reduced-precision
    # accumulation blows up through the solve; centered/scaled monomials span
    # the SAME polynomial space with cond(Gram) ~4 orders of magnitude lower
    wsum = torch.sum(itm) + 1.0
    mu = torch.sum(itm[:, None] * f, dim=0) / wsum  # (F,)
    # sd floor: with ZERO ITM paths the weighted variance is 0; clamped, z
    # stays bounded, the Gram collapses to the ridge, beta = 0, and the date
    # is a clean no-exercise pass-through
    sd = torch.clamp(torch.sqrt(torch.sum(itm[:, None] * (f - mu) ** 2, dim=0) / wsum),
                     min=1e-3)
    z = (f - mu) / sd  # (n, F)
    cols = []
    for exp in exps:
        if any(exp):
            terms = [z[:, i] ** e for i, e in enumerate(exp)]
            col = terms[0]
            for term in terms[1:]:
                col = col * term
            cols.append(col)
        else:
            cols.append(torch.ones_like(pay))
    x = torch.stack(cols, dim=-1)  # (n, B)
    xw = x * itm[:, None]
    gram = xw.T @ x
    rhs = (xw.T @ vd[:, None])[:, 0]
    # relative ridge + ABSOLUTE floor: trace(gram) is 0 on an all-OTM date,
    # and a purely relative ridge would leave a zero matrix to factor
    gram = gram + (1e-6 * torch.trace(gram) / n_basis + 1e-6) * torch.eye(
        n_basis, dtype=pay.dtype, device=pay.device)
    chol, _ = torch.linalg.cholesky_ex(gram)
    beta = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    cont = (x @ beta[:, None])[:, 0]
    return beta, cont


def _lsm_walk(feats: torch.Tensor, payoffs: torch.Tensor, disc: torch.Tensor,
              degree: int) -> torch.Tensor:
    """Backward LSM walk. ``feats``: (n, m, F) regression features and
    ``payoffs``: (n, m) at exercise dates t_1..t_m; ``disc``: per-interval
    discount e^{-r dt}. The continuation basis is every monomial of the
    standardized features up to total ``degree``. Returns the (n,) realized
    discounted cashflows at t_1 (to be discounted once more to 0)."""
    exps = _monomial_exponents(feats.shape[-1], degree)
    # terminal date: exercise iff ITM (continuation is 0 past maturity)
    v = payoffs[:, -1]
    # walk m-1, ..., 1; date t_0=0 has no exercise right
    for j in range(payoffs.shape[1] - 2, -1, -1):
        pay = payoffs[:, j]
        vd = disc * v  # realized future cashflow discounted to date j
        _, cont = _regress_date(vd, feats[:, j], pay, exps)
        v = torch.where((pay > 0.0) & (pay > cont), pay, vd)
    return v


def _lsm_price(feats, s_dates, k, kind, r, T, n_exercise, degree, dtype):
    """Shared estimator tail: payoff sign, the walk, t_1->0 discounting, and
    the stats dict — ONE copy of the contract for every dynamics variant."""
    sign = 1.0 if kind == "call" else -1.0
    pay = torch.clamp(sign * (s_dates - k), min=0.0)
    disc = torch.tensor(math.exp(-r * (T / n_exercise)), dtype=dtype, device=pay.device)
    v0 = disc * _lsm_walk(feats, pay, disc, degree)  # cashflows at t_1 -> 0
    price = float(torch.mean(v0))
    euro = float(torch.mean(math.exp(-r * T) * pay[:, -1]))
    return {
        "price": price,
        "se": float(torch.std(v0, correction=0) / math.sqrt(v0.shape[0])),
        "european": euro,
        "early_exercise_premium": price - euro,
        "n_paths": int(v0.shape[0]),
        "n_exercise": n_exercise,
    }


def _validate_kind_indices(kind, indices, n_paths, device=None) -> torch.Tensor:
    if kind not in ("call", "put"):
        raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
    full_f32()
    return path_indices(n_paths, indices, device)


def bermudan_lsm(n_paths: int, s0: float, k: float, r: float, sigma: float, T: float, *,
                 kind: str = "put", n_exercise: int = 50, steps_per_exercise: int = 4,
                 n_basis: int = 4, seed: int = 1234, scramble: str = "owen", indices=None,
                 dtype=torch.float32, device=None) -> dict[str, float]:
    """Bermudan option price by Sobol-QMC LSM: ``n_exercise`` equally spaced
    exercise dates (the last = maturity), log-Euler GBM paths with
    ``steps_per_exercise`` fine steps per date. Returns price + the European
    price off the SAME paths (the early-exercise premium comes out of one
    simulation) and an iid-diagnostic SE."""
    idx = _validate_kind_indices(kind, indices, n_paths, device)
    grid = TimeGrid(T, n_exercise * steps_per_exercise)
    s = simulate_gbm_log(idx, grid, s0, r, sigma, seed=seed, scramble=scramble,
                         store_every=steps_per_exercise, dtype=dtype)  # (n, n_exercise + 1)
    s_dates = s[:, 1:]  # spot at t_1..t_m (_regress_date standardizes per date)
    # single feature (spot), degree n_basis-1 polynomial
    return _lsm_price(s_dates[:, :, None], s_dates, k, kind, r, T, n_exercise, n_basis - 1,
                      dtype)


def bermudan_lsm_heston(n_paths: int, s0: float, k: float, r: float, T: float, *, v0: float,
                        kappa: float, theta: float, xi: float, rho: float, kind: str = "put",
                        n_exercise: int = 50, steps_per_exercise: int = 4, degree: int = 3,
                        seed: int = 1234, scramble: str = "owen", indices=None,
                        scheme: str = "qe", dtype=torch.float32,
                        device=None) -> dict[str, float]:
    """Bermudan option under HESTON stochastic volatility: the continuation
    regression sees BOTH state variables (every monomial of the standardized
    (spot, variance) pair up to total ``degree``), so the exercise policy is
    variance-aware. ``scheme``: "qe" (Andersen QE-M, default) or "euler"
    (full-truncation), both on the scan path."""
    idx = _validate_kind_indices(kind, indices, n_paths, device)
    grid = TimeGrid(T, n_exercise * steps_per_exercise)
    sim = heston_sim_fn(scheme)
    traj = sim(idx, grid, s0=s0, mu=r, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho,
               seed=seed, scramble=scramble, store_every=steps_per_exercise, dtype=dtype)
    s, var = traj["S"][:, 1:], traj["v"][:, 1:]
    feats = torch.stack([s, var], dim=-1)  # (n, m, 2)
    return _lsm_price(feats, s, k, kind, r, T, n_exercise, degree, dtype)
