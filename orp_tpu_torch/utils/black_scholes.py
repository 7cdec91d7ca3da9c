"""Closed-form Black-Scholes oracle (counterpart of ``orp_tpu/utils/black_scholes.py``).

Host-side float64 arithmetic only; the smoke run and the tests price the
north-star call against it.
"""

from __future__ import annotations

from math import erf, exp, log, sqrt


def _N(x: float) -> float:
    return 0.5 * (1.0 + erf(x / sqrt(2.0)))


def bs_call(s0: float, k: float, r: float, sigma: float, T: float) -> tuple[float, float]:
    """European call ``(price, delta)``."""
    d1 = (log(s0 / k) + (r + sigma * sigma / 2.0) * T) / (sigma * sqrt(T))
    d2 = d1 - sigma * sqrt(T)
    return s0 * _N(d1) - k * exp(-r * T) * _N(d2), _N(d1)
