"""Lookback options: exact bridge-maximum sampling vs the closed form
(counterpart of ``orp_tpu/risk/lookback.py``).

Companion to ``risk/barrier.py``: instead of weighting by the bridge
CROSSING probability, the running maximum itself is SAMPLED exactly. For a
Brownian bridge between log-knots ``x_i, x_{i+1}`` with variance
``s^2 = sigma^2 dt``, the conditional maximum has the closed inverse-CDF

    M_i = (x_i + x_{i+1} + sqrt((x_{i+1} - x_i)^2 - 2 s^2 ln U_i)) / 2,

so one extra uniform per interval turns the stored knots into the EXACT
continuous-time running maximum (in law). A fixed-strike lookback call
``max(S_max - K, 0)`` priced this way is unbiased from any monitoring grid,
while the naive knot-max is biased LOW by the missed intra-interval maxima.

The bridge uniforms ride Sobol dimensions BEYOND the path dimensions (dims
``n_steps .. n_steps + m - 1``), so the estimator stays a pure function of
(indices, seed). A CUDA gather past the direction table would fire a
device-side assert, so the dimension check raises before any tensor op.

Oracles: the Conze-Viswanathan closed form for the continuously-monitored
fixed-strike lookback call and Goldman-Sosin-Gatto for the floating strike
(host f64). Entry points run on the card unless ``device`` (or an
``indices`` tensor) says otherwise.
"""

from __future__ import annotations

import math

import torch

from orp_tpu_torch.qmc.sobol import N_DIMS, sobol_uniform
from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import scan_sde
from orp_tpu_torch.utils.black_scholes import _N
from orp_tpu_torch.utils.device import path_indices
from orp_tpu_torch.utils.precision import full_f32


def lookback_call_fixed(s0: float, k: float, r: float, sigma: float, T: float) -> float:
    """Continuously-monitored fixed-strike lookback call (Conze-
    Viswanathan), running max observed from t=0 (M_0 = S_0)."""
    if r <= 0.0:
        raise ValueError("the Conze-Viswanathan form here assumes r > 0")
    if k < s0:
        # standard decomposition: payoff = (M - K)^+ = (S0 - K) + (M - S0)^+
        # since M >= S0 >= K always
        return math.exp(-r * T) * (s0 - k) + lookback_call_fixed(s0, s0, r, sigma, T)
    if sigma == 0.0:  # deterministic path: max over [0,T] is s0*e^{rT} (r>0)
        return math.exp(-r * T) * max(s0 * math.exp(r * T) - k, 0.0)
    sq = sigma * math.sqrt(T)
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma * sigma) * T) / sq
    d2 = d1 - sq
    beta = 2.0 * r / (sigma * sigma)
    # C = S0 N(d1) - K e^{-rT} N(d2)
    #     + (S0/beta) [N(d1) - e^{-rT} (S0/K)^{-beta} N(d1 - beta sq)]
    nphi = _N(d1 - beta * sq)
    if beta * sq > 40.0 or nphi == 0.0:
        # sigma -> 0 and deep-OTM tails: N(d1 - beta*sq) crushes the power
        # term to 0 at all precision, while (s0/k)**(-beta) alone would
        # overflow (beta*ln(k/s0) > 709 is reachable with beta*sq <= 40)
        reflect = 0.0
    else:
        # log space: no intermediate overflows for far strikes
        reflect = math.exp(-r * T - beta * math.log(s0 / k) + math.log(nphi))
    return (s0 * _N(d1) - k * math.exp(-r * T) * _N(d2)
            + (s0 / beta) * (_N(d1) - reflect))


def _bridge_extreme_knots(n_paths, r, sigma, T, n_monitor, steps_per_monitor, bridge, sign,
                          seed, scramble, indices, dtype, device):
    """Shared sampler: (log-knots x (n, m+1), log-extreme x_ext (n,)) where
    ``sign=+1`` samples the exact per-interval bridge MAXIMUM and ``sign=-1``
    the minimum (``bridge=False``: the naive knot extreme)."""
    n_steps = n_monitor * steps_per_monitor
    if bridge and n_steps + n_monitor > N_DIMS:
        # checked before any tensor op: an out-of-range gather of the
        # direction table is a device-side assert on the card (JAX clamps)
        raise ValueError(
            f"n_steps + n_monitor = {n_steps + n_monitor} exceeds the "
            f"{N_DIMS}-dimension Sobol table (bridge uniforms ride the "
            "dims past the path dims)"
        )
    full_f32()
    idx = path_indices(n_paths, indices, device)
    grid = TimeGrid(T, n_steps)
    # log-return knots straight from the scan (the recurrence of
    # simulate_gbm_log): no price-space exp/log round trip
    vol = (sigma * torch.tensor(grid.dt, dtype=dtype) ** 0.5).to(idx.device)
    c0 = (r - 0.5 * sigma * sigma) * grid.dt

    def step(acc, z, t, dt):
        return acc + c0 + vol * z[:, 0]

    _, x = scan_sde(step, torch.zeros(idx.shape, dtype=dtype, device=idx.device),
                    lambda a: a, idx, grid, 1, seed, scramble=scramble,
                    store_every=steps_per_monitor, dtype=dtype)  # (n, m+1) incl. t=0
    extreme = torch.amax if sign > 0 else torch.amin
    if bridge:
        # one extra Sobol dim per monitoring interval, PAST the path dims
        dims = n_steps + torch.arange(n_monitor, dtype=torch.int64, device=idx.device)
        u = sobol_uniform(idx, dims, seed, scramble=scramble, dtype=dtype)  # (n, m) in (0, 1)
        s2 = torch.tensor(sigma * sigma * (T / n_monitor), dtype=dtype, device=idx.device)
        d = x[:, 1:] - x[:, :-1]
        m_int = 0.5 * (x[:, :-1] + x[:, 1:] + sign * torch.sqrt(d * d - 2.0 * s2 * torch.log(u)))
        x_ext = extreme(m_int, dim=1)
    else:
        x_ext = extreme(x, dim=1)
    return x, x_ext


def lookback_call_qmc(n_paths: int, s0: float, k: float, r: float, sigma: float, T: float, *,
                      n_monitor: int = 52, steps_per_monitor: int = 1, bridge: bool = True,
                      seed: int = 1234, scramble: str = "owen", indices=None,
                      dtype=torch.float32, device=None) -> dict[str, float]:
    """Fixed-strike lookback call by Sobol-QMC. ``bridge=True`` samples the
    exact per-interval bridge maximum (unbiased for continuous monitoring);
    ``bridge=False`` is the naive knot-max, kept to measure its low bias."""
    _, x_max = _bridge_extreme_knots(n_paths, r, sigma, T, n_monitor, steps_per_monitor,
                                     bridge, +1.0, seed, scramble, indices, dtype, device)
    s_max = torch.tensor(s0, dtype=dtype, device=x_max.device) * torch.exp(x_max)
    v = math.exp(-r * T) * torch.clamp(s_max - k, min=0.0)
    n = v.shape[0]
    return {
        "price": float(torch.mean(v)),
        "se": float(torch.std(v, correction=0)) / math.sqrt(n),
        "mean_smax": float(torch.mean(s_max)),
        "n_paths": int(n),
        "n_monitor": n_monitor,
    }


def lookback_call_floating(s0: float, r: float, sigma: float, T: float) -> float:
    """Continuously-monitored FLOATING-strike lookback call
    ``S_T - min S`` (Goldman-Sosin-Gatto), min observed from t=0."""
    if r <= 0.0:
        raise ValueError("the Goldman-Sosin-Gatto form here assumes r > 0")
    sq = sigma * math.sqrt(T)
    if sigma == 0.0:
        # deterministic path: min is s0 (r>0), payoff s0(e^{rT}-1)
        return s0 * (1.0 - math.exp(-r * T))
    a1 = (r + 0.5 * sigma * sigma) * math.sqrt(T) / sigma
    a2 = a1 - sq
    beta = 2.0 * r / (sigma * sigma)
    # C = S0 N(a1) - S0 e^{-rT} N(a2) + (S0/beta)(e^{-rT} N(a2) - N(-a1)):
    # GSG with m0 = S0, where the reflected-term argument
    # -a1 + (2r/sigma)sqrt(T) collapses to a2 and (S0/m0)^{-beta} to 1
    return (s0 * _N(a1) - s0 * math.exp(-r * T) * _N(a2)
            + (s0 / beta) * (math.exp(-r * T) * _N(a2) - _N(-a1)))


def lookback_floating_qmc(n_paths: int, s0: float, r: float, sigma: float, T: float, *,
                          n_monitor: int = 52, steps_per_monitor: int = 1, bridge: bool = True,
                          seed: int = 1234, scramble: str = "owen", indices=None,
                          dtype=torch.float32, device=None) -> dict[str, float]:
    """Floating-strike lookback call ``S_T - min S`` by Sobol-QMC with the
    exact per-interval bridge MINIMUM (the reflection of the max sampler:
    ``(x_i + x_{i+1} - sqrt(d^2 - 2 s^2 ln U)) / 2``)."""
    x, x_min = _bridge_extreme_knots(n_paths, r, sigma, T, n_monitor, steps_per_monitor,
                                     bridge, -1.0, seed, scramble, indices, dtype, device)
    s0_t = torch.tensor(s0, dtype=dtype, device=x.device)
    s_t = s0_t * torch.exp(x[:, -1])
    s_min = s0_t * torch.exp(x_min)
    v = math.exp(-r * T) * (s_t - s_min)  # always >= 0
    n = v.shape[0]
    return {
        "price": float(torch.mean(v)),
        "se": float(torch.std(v, correction=0)) / math.sqrt(n),
        "mean_smin": float(torch.mean(s_min)),
        "n_paths": int(n),
        "n_monitor": n_monitor,
    }
