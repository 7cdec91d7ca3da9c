"""The OLS-martingale price of a European claim, in plain PyTorch.

``M_t = e^{-rt} S_t`` is a risk-neutral martingale, so ``sum_t a_t (M_{t+1} -
M_t)`` has mean zero for any adapted ``a_t``. Date by date, in order, the
basis ``{1, m, m^2, (m - k)^+, 1{m > k}, phi_t}`` (``m = S_t / S_0``, ``k`` the
strike over ``S_0``, ``phi_t`` the hedge's holding) times ``M_{t+1} - M_t`` is
regressed on what the earlier dates left of the discounted payoff's
deviation and subtracted. Each solve scales the columns to unit second moment
and inverts the Gram spectrally, dropping eigenvalues below ``1e-5`` of the
largest. The price is the plain mean plus the mean of the final residual.
"""

from __future__ import annotations

import torch


def martingale_ols_price(s: torch.Tensor, payoff: torch.Tensor, r: float, times, *,
                         strike_over_s0: float, phi: torch.Tensor,
                         ridge: float = 1e-5) -> float:
    """``s (n, T+1)`` knots, ``payoff (n,)``, ``phi (n, T)``; the price."""
    n = s.shape[0]
    disc = torch.exp(-r * torch.as_tensor(times, dtype=s.dtype).to(s.device))
    m_disc = disc[None, :] * s
    dm = m_disc[:, 1:] - m_disc[:, :-1]
    m_norm = s[:, :-1] / s[:, :1]
    y = disc[-1] * payoff
    v0_plain = torch.mean(y)
    resid = y - v0_plain
    k = torch.tensor(strike_over_s0, dtype=s.dtype, device=s.device)
    tol_rel = torch.tensor(ridge, dtype=s.dtype, device=s.device)
    for j in range(m_norm.shape[1]):
        m, d = m_norm[:, j], dm[:, j]
        X = torch.stack([torch.ones_like(m), m, m * m, torch.clamp(m - k, min=0.0),
                         (m > k).to(m.dtype), phi[:, j]], dim=-1) * d[:, None]
        sd = torch.sqrt(torch.mean(X * X, dim=0))
        Xn = X / torch.where(sd > 0, sd, 1.0)
        w, v = torch.linalg.eigh(Xn.T @ Xn / n)
        c = Xn.T @ resid / n
        tol = tol_rel * torch.max(torch.abs(w))
        winv = torch.where(w > tol, 1.0 / torch.where(w > tol, w, 1.0), 0.0)
        resid = resid - Xn @ (v @ (winv * (v.T @ c)))
    return float(v0_plain + torch.mean(resid))
