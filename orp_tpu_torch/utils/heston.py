"""Semi-analytic Heston oracle (counterpart of ``orp_tpu/utils/heston.py``, host NumPy).

Heston (1993) characteristic function in the Albrecher et al. "little Heston
trap" form (continuous in the principal branch of the complex log), Gil-Pelaez
inversion for the two in-the-money probabilities, fixed Gauss-Legendre
quadrature on ``u in (0, u_max]``. The smoke run checks the card's Heston
hedge against it as the north star is checked against Black-Scholes.
"""

from __future__ import annotations

from math import exp, log

import numpy as np


def _heston_cf(u: np.ndarray, T: float, s0: float, r: float, v0: float, kappa: float,
               theta: float, xi: float, rho: float) -> np.ndarray:
    """Characteristic function E[exp(i u ln S_T)] ("little trap" form)."""
    iu = 1j * u
    beta = kappa - rho * xi * iu
    d = np.sqrt(beta * beta + xi * xi * (iu + u * u))
    g = (beta - d) / (beta + d)
    edt = np.exp(-d * T)
    C = r * iu * T + (kappa * theta / (xi * xi)) * (
        (beta - d) * T - 2.0 * np.log((1.0 - g * edt) / (1.0 - g)))
    D = ((beta - d) / (xi * xi)) * ((1.0 - edt) / (1.0 - g * edt))
    return np.exp(C + D * v0 + iu * log(s0))


def heston_call(s0: float, k: float, r: float, T: float, *, v0: float, kappa: float,
                theta: float, xi: float, rho: float, u_max: float = 200.0,
                n_quad: int = 2048) -> float:
    """European call under Heston: ``S0 P1 - K e^{-rT} P2`` via Gil-Pelaez."""
    x, w = np.polynomial.legendre.leggauss(n_quad)
    u = 0.5 * u_max * (x + 1.0)  # map [-1,1] -> (0, u_max]
    w = 0.5 * u_max * w
    lnk = log(k)
    cf = _heston_cf(u, T, s0, r, v0, kappa, theta, xi, rho)
    cf_shift = _heston_cf(u - 1j, T, s0, r, v0, kappa, theta, xi, rho)
    # E[S_T] = cf(-i) = S0 e^{rT} exactly; use the closed form for stability
    phase = np.exp(-1j * u * lnk) / (1j * u)
    p2 = 0.5 + np.sum(w * np.real(phase * cf)) / np.pi
    p1 = 0.5 + np.sum(w * np.real(phase * cf_shift)) / (np.pi * s0 * exp(r * T))
    return s0 * p1 - k * exp(-r * T) * p2


def heston_put(s0: float, k: float, r: float, T: float, **kw) -> float:
    """European put via put-call parity."""
    return heston_call(s0, k, r, T, **kw) - s0 + k * exp(-r * T)
