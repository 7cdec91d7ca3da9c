"""Moment-matched lognormal oracle of an arithmetic basket call (counterpart of ``orp_tpu/utils/basket.py``).

The basket ``B_T = sum_i w_i S_i(T)`` of correlated GBMs has no closed-form
law, but its first two moments do. Matching them to a lognormal ("Levy")
gives a Black-formula price that is exact when A = 1 and when all assets are
comonotone with equal vols, and within ~40bp of the QMC price at the
basket pipeline's defaults. Host numpy in float64.
"""

from __future__ import annotations

import numpy as np

from orp_tpu_torch.utils.black_scholes import _N


def basket_call_mm(s0, weights, strike: float, r: float, sigmas, corr,
                   T: float) -> tuple[float, float]:
    """``(price, effective_vol)`` of a European arithmetic basket call;
    ``effective_vol`` is the matched lognormal's annualised vol
    ``sqrt(ln(m2 / m1^2) / T)``."""
    s0 = np.asarray(s0, np.float64)
    w = np.asarray(weights, np.float64)
    sig = np.asarray(sigmas, np.float64)
    rho = np.asarray(corr, np.float64)
    fwd = w * s0 * np.exp(r * T)                     # per-asset forwards
    m1 = fwd.sum()
    # E[B^2] = sum_ij w_i w_j S_i0 S_j0 exp(2rT + rho_ij sig_i sig_j T)
    cov = rho * np.outer(sig, sig) * T
    m2 = float(np.outer(fwd, fwd).ravel() @ np.exp(cov).ravel())
    v2 = np.log(m2 / (m1 * m1))                      # matched total variance
    if v2 <= 0:  # numerically degenerate (zero vol)
        return float(np.exp(-r * T) * max(m1 - strike, 0.0)), 0.0
    v = np.sqrt(v2)
    d1 = (np.log(m1 / strike) + 0.5 * v2) / v
    d2 = d1 - v
    price = float(np.exp(-r * T) * (m1 * _N(float(d1)) - strike * _N(float(d2))))
    return price, float(v / np.sqrt(T))
