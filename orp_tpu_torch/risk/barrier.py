"""Barrier options: Brownian-bridge-corrected QMC vs the reflection oracle
(counterpart of ``orp_tpu/risk/barrier.py``).

Checking the barrier only at the stored knots misses intra-interval
crossings and biases a down-and-out price HIGH by O(1/sqrt(m)). Under GBM
the log-price is a Brownian motion, so the crossing probability of each
interval conditional on its endpoints is exact,
``exp(-2 (x_i - h)(x_{i+1} - h) / (sigma^2 dt))`` for the Brownian bridge,
and weighting each path by its interval survival products makes the
estimator unbiased for the CONTINUOUS barrier from any monitoring grid
(Beaglehole-Dybvig-Zhou).

Oracle: the closed-form reflection-principle price of the continuous
down-and-out call (``down_and_out_call``), host f64.

The survival weight is one elementwise pass and a product over the stored
(n_paths, m) knots. The only device log is ``log(S/H)`` of O(1) ratios
(SCALING.md §6d). Entry points run on the card unless ``device`` (or an
``indices`` tensor) says otherwise.
"""

from __future__ import annotations

import math

import torch

from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import simulate_gbm_log
from orp_tpu_torch.utils.black_scholes import _N, bs_call
from orp_tpu_torch.utils.device import path_indices
from orp_tpu_torch.utils.precision import full_f32


def down_and_out_call(s0: float, k: float, h: float, r: float, sigma: float,
                      T: float) -> float:
    """Continuous-barrier down-and-out call, reflection principle (H <= K).

    ``c_do = c_bs - c_di`` with the down-and-in part priced off the
    reflected process; requires ``h <= k`` (the standard regime) and
    ``h < s0`` (otherwise already knocked out -> 0).
    """
    if h >= s0:
        return 0.0
    if h <= 0.0:
        return bs_call(s0, k, r, sigma, T)[0]
    if h > k:
        raise ValueError(f"down_and_out_call needs h <= k, got h={h} k={k}")
    if sigma == 0.0:  # deterministic path s0*e^{rt}: monotone, so the
        # running minimum is at an endpoint; knocked out iff it touches h
        if min(s0, s0 * math.exp(r * T)) <= h:
            return 0.0
        return math.exp(-r * T) * max(s0 * math.exp(r * T) - k, 0.0)
    lam = (r + 0.5 * sigma * sigma) / (sigma * sigma)
    sq = sigma * math.sqrt(T)
    y = math.log(h * h / (s0 * k)) / sq + lam * sq
    c_di = (s0 * (h / s0) ** (2.0 * lam) * _N(y)
            - k * math.exp(-r * T) * (h / s0) ** (2.0 * lam - 2.0)
            * _N(y - sq))
    return bs_call(s0, k, r, sigma, T)[0] - c_di


def down_and_out_call_qmc(n_paths: int, s0: float, k: float, h: float, r: float,
                          sigma: float, T: float, *, n_monitor: int = 52,
                          steps_per_monitor: int = 1, bridge: bool = True, seed: int = 1234,
                          scramble: str = "owen", indices=None, dtype=torch.float32,
                          device=None) -> dict[str, float]:
    """Down-and-out call by Sobol-QMC. ``bridge=True`` multiplies each path
    by its exact per-interval bridge survival probability (unbiased for the
    continuous barrier); ``bridge=False`` is the naive knot-check, kept to
    measure the discrete-monitoring bias it suffers."""
    if h >= s0:
        # already knocked out — the same answer the closed form gives,
        # without burning a simulation
        return {"price": 0.0, "se": 0.0, "knockout_frac": 1.0,
                "n_paths": int(n_paths), "n_monitor": n_monitor}
    if sigma == 0.0:
        # Deterministic path s0*e^{rt}: monotone, so the running minimum sits
        # at an endpoint — no simulation, and no 0/0 in the bridge weight
        # exponent (which divides by sigma^2 dt).
        knocked = min(s0, s0 * math.exp(r * T)) <= h
        price = 0.0 if knocked else (
            math.exp(-r * T) * max(s0 * math.exp(r * T) - k, 0.0))
        return {"price": price, "se": 0.0,
                "knockout_frac": 1.0 if knocked else 0.0,
                "n_paths": int(n_paths), "n_monitor": n_monitor}
    full_f32()
    idx = path_indices(n_paths, indices, device)
    grid = TimeGrid(T, n_monitor * steps_per_monitor)
    s = simulate_gbm_log(idx, grid, s0, r, sigma, seed=seed, scramble=scramble,
                         store_every=steps_per_monitor, dtype=dtype)  # (n, m+1) incl. t=0
    alive = torch.all(s > h, dim=1)  # knot-level knockout
    payoff = torch.clamp(s[:, -1] - k, min=0.0)
    if bridge:
        x = torch.log(s / torch.tensor(h, dtype=dtype, device=s.device))  # O(1) ratios
        dt_m = T / n_monitor
        cross = torch.exp(-2.0 * x[:, :-1] * x[:, 1:] / (sigma * sigma * dt_m))
        survive = torch.prod(1.0 - torch.clamp(cross, max=1.0), dim=1)
        weight = torch.where(alive, survive, torch.zeros_like(survive))
    else:
        weight = alive.to(dtype)
    v = math.exp(-r * T) * payoff * weight
    n = v.shape[0]
    return {
        "price": float(torch.mean(v)),
        "se": float(torch.std(v, correction=0)) / math.sqrt(n),
        "knockout_frac": float(1.0 - torch.mean(weight)),
        "n_paths": int(n),
        "n_monitor": n_monitor,
    }
