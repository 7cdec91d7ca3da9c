"""Regression-based martingale control variates (counterpart of ``orp_tpu/risk/controls.py``).

The discounted instrument price ``M_t = e^{-rt} S_t`` is a risk-neutral
martingale, so for any adapted integrand the pathwise sum
``sum_t a_t (M_{t+1} - M_t)`` has mean zero. Per date the basis
``{1, m, m^2, (m - k)^+, 1{m > k}}`` (``m = S_t / S_0``), optionally with the
trained phi, is regressed on the discounted payoff's residual, and the fitted
controls are subtracted. The dates are backfitted in order: each date's solve
sees the residual the dates before it left, so the order is kept.

Each solve whitens the columns to unit second moment and inverts the Gram
spectrally, dropping eigenvalues below ``ridge * max|w|`` (the rank-1 date-0
Gram would blow up a plain ridge solve in f32). Products run in full f32
(``utils/precision.full_f32``): a reduced-precision Gram moved this price by
-2.4bp on the TPU (SCALING.md §6b).

Under a paths mesh (``mesh``) each rank holds its block of the paths: every
mean, and each date's normal equations, are path sums across the ranks (the
mean of the ranks' equal-shard means), so every rank solves the same
regression and the price is replicated.
"""

from __future__ import annotations

import torch

from orp_tpu_torch.parallel.mesh import path_mean, path_means
from orp_tpu_torch.utils.precision import full_f32


def _backfit_scan(y, m_cols, phi_cols, dm_cols, k, ridge, mesh=None):
    """Sequential per-(date, asset) OLS backfitting; returns the final residual.

    ``m_cols``/``dm_cols``: ``(T*A, n)``; ``phi_cols``: ``(T*A, n)`` or None."""
    for j in range(m_cols.shape[0]):
        m, d = m_cols[j], dm_cols[j]
        cols = [torch.ones_like(m), m, m * m, torch.clamp(m - k, min=0.0),
                (m > k).to(m.dtype)]
        if phi_cols is not None:
            cols.append(phi_cols[j])
        X = torch.stack(cols, dim=-1) * d[:, None]
        n = X.shape[0]
        sd = torch.sqrt(path_mean(torch.mean(X * X, dim=0), mesh))
        sd = torch.where(sd > 0, sd, 1.0)
        Xn = X / sd
        g = Xn.T @ Xn / n
        c = Xn.T @ y / n
        g, c = path_means(mesh, g, c)
        w, v = torch.linalg.eigh(g)
        tol = ridge * torch.max(torch.abs(w))
        winv = torch.where(w > tol, 1.0 / torch.where(w > tol, w, 1.0), 0.0)
        beta = v @ (winv * (v.T @ c))
        y = y - Xn @ beta
    return y


def martingale_ols_price(s: torch.Tensor, payoff: torch.Tensor, r: float, times, *,
                         strike_over_s0: float = 1.0, phi: torch.Tensor | None = None,
                         ridge: float = 1e-5, mesh=None) -> tuple[float, float]:
    """OLS-martingale-controlled price: ``(v0, residual_std)``.

    ``s``: ``(n, T+1)`` instrument paths at the rebalance knots, or
    ``(n, T+1, A)``; ``payoff (n,)``; ``times (T+1,)``; ``phi``: optional
    ``(n, T[, A])`` trained holdings, added as a basis column. ``mesh``: the
    paths are this rank's block (module docstring)."""
    full_f32()
    if s.ndim == 2:
        s = s[:, :, None]
        phi = None if phi is None else phi[:, :, None]
    n = s.shape[0]
    dtype = s.dtype
    disc = torch.exp(-r * torch.as_tensor(times, dtype=dtype).to(s.device))
    m_disc = disc[None, :, None] * s
    dm = m_disc[:, 1:] - m_disc[:, :-1]
    m_norm = s[:, :-1] / s[:, :1]

    def to_cols(a):  # (n, T, A) -> (T*A, n), per-(date, asset) slot order
        return torch.movedim(a, 0, -1).reshape(-1, n)

    phi_cols = None if phi is None else to_cols(phi.to(dtype))
    y = disc[-1] * payoff.to(dtype)
    v0_plain = path_mean(torch.mean(y), mesh)
    resid = _backfit_scan(y - v0_plain, to_cols(m_norm), phi_cols, to_cols(dm),
                          torch.tensor(strike_over_s0, dtype=dtype, device=s.device),
                          torch.tensor(ridge, dtype=dtype, device=s.device), mesh)
    # every control has exact zero expectation: the residual's mean is the correction
    v0 = float(v0_plain + path_mean(torch.mean(resid), mesh))
    return v0, path_std(resid, mesh)


def path_std(x: torch.Tensor, mesh=None) -> float:
    """The population standard deviation of ``x`` over the global paths
    (``torch.std(x, correction=0)`` without a mesh)."""
    if mesh is None:
        return float(torch.std(x, correction=0))
    m = path_mean(torch.mean(x), mesh)
    return float(torch.sqrt(path_mean(torch.mean((x - m) ** 2), mesh)))
