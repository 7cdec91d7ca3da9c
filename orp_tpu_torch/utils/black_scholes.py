"""Closed-form Black-Scholes oracle (counterpart of ``orp_tpu/utils/black_scholes.py``).

Host-side float64 arithmetic only; the smoke run and the tests price the
north-star call against it, and :func:`bs_greeks` is the oracle of the
pathwise greeks (``risk/greeks.py``).
"""

from __future__ import annotations

from math import erf, exp, log, sqrt


def _N(x: float) -> float:
    return 0.5 * (1.0 + erf(x / sqrt(2.0)))


def _phi(x: float) -> float:
    return exp(-0.5 * x * x) / sqrt(2.0 * 3.141592653589793)


def bs_call(s0: float, k: float, r: float, sigma: float, T: float) -> tuple[float, float]:
    """European call ``(price, delta)``."""
    g = bs_greeks(s0, k, r, sigma, T, kind="call")
    return g["price"], g["delta"]


def bs_put(s0: float, k: float, r: float, sigma: float, T: float) -> tuple[float, float]:
    """European put ``(price, delta)`` by put-call parity."""
    call, delta_c = bs_call(s0, k, r, sigma, T)
    return call - s0 + k * exp(-r * T), delta_c - 1.0


def bs_greeks(s0: float, k: float, r: float, sigma: float, T: float,
              kind: str = "call") -> dict[str, float]:
    """Price, delta, gamma, vega, rho and theta in closed form. Theta is the
    calendar decay ``dV/dt`` (negative for a long call)."""
    d1 = (log(s0 / k) + (r + sigma * sigma / 2.0) * T) / (sigma * sqrt(T))
    d2 = d1 - sigma * sqrt(T)
    disc = exp(-r * T)
    gamma = _phi(d1) / (s0 * sigma * sqrt(T))
    vega = s0 * _phi(d1) * sqrt(T)
    if kind == "call":
        price, delta = s0 * _N(d1) - k * disc * _N(d2), _N(d1)
        theta = -s0 * _phi(d1) * sigma / (2.0 * sqrt(T)) - r * k * disc * _N(d2)
        rho = k * T * disc * _N(d2)
    elif kind == "put":
        price, delta = k * disc * _N(-d2) - s0 * _N(-d1), _N(d1) - 1.0
        theta = -s0 * _phi(d1) * sigma / (2.0 * sqrt(T)) + r * k * disc * _N(-d2)
        rho = -k * T * disc * _N(-d2)
    else:
        raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
    return {"price": price, "delta": delta, "gamma": gamma, "vega": vega, "rho": rho,
            "theta": theta}
