"""Arithmetic-Asian options with the exact geometric-Asian control variate
(counterpart of ``orp_tpu/risk/asian.py``).

The GEOMETRIC average of lognormals is itself lognormal, so the
geometric-Asian call has an exact Black-Scholes-style closed form, and it is
~0.99-correlated with the arithmetic payoff. Used as a control variate
(``price = mean(arith) + (geo_closed_form - mean(geo))``) it removes almost
all of the Monte-Carlo variance.

Closed form (discrete equally spaced averaging over t_1..t_m):
``log G = log s0 + (r - sigma^2/2) * tbar + (sigma/m) * sum_i W(t_i)`` with
``tbar = mean(t_i)`` and ``Var[(1/m) sum W(t_i)] = (1/m^2) sum_{ij}
min(t_i, t_j)``: a plain lognormal, priced by the usual two-term formula.

The averaging grid rides the scan's stored knots (``store_every``). The
geometric leg takes ``log(S_t/s0)``, a device log of O(1) ratios where f32
``log`` is tight; no constant is seeded through a device ``log`` (SCALING.md
§6d). Entry points run on the card unless ``device`` (or an ``indices``
tensor) says otherwise.
"""

from __future__ import annotations

import math

import torch

from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import simulate_gbm_log
from orp_tpu_torch.utils.black_scholes import _N
from orp_tpu_torch.utils.device import path_indices
from orp_tpu_torch.utils.precision import full_f32


def geometric_asian_call(s0: float, k: float, r: float, sigma: float, T: float,
                         n_avg: int) -> float:
    """Exact price of the discretely-monitored geometric-Asian call
    (equally spaced t_i = i*T/m, i=1..m). Host f64 oracle."""
    m = n_avg
    times = [T * i / m for i in range(1, m + 1)]
    tbar = sum(times) / m
    # Var[(1/m) sum W(t_i)] = (1/m^2) * sum_ij min(t_i, t_j)
    var_w = sum(min(ti, tj) for ti in times for tj in times) / (m * m)
    mu_g = math.log(s0) + (r - 0.5 * sigma * sigma) * tbar
    sd_g = sigma * math.sqrt(var_w)
    if sd_g == 0.0:  # sigma=0: deterministic average, pure intrinsic
        return math.exp(-r * T) * max(math.exp(mu_g) - k, 0.0)
    d1 = (mu_g - math.log(k) + sd_g * sd_g) / sd_g
    d2 = d1 - sd_g
    fwd_g = math.exp(mu_g + 0.5 * sd_g * sd_g)
    return math.exp(-r * T) * (fwd_g * _N(d1) - k * _N(d2))


def asian_call_qmc(n_paths: int, s0: float, k: float, r: float, sigma: float, T: float, *,
                   n_avg: int = 52, steps_per_avg: int = 7, seed: int = 1234,
                   scramble: str = "owen", indices=None, dtype=torch.float32,
                   device=None) -> dict[str, float]:
    """Arithmetic-Asian call by Sobol-QMC with the geometric control variate.

    Returns both the plain estimator and the controlled one (``price``), with
    iid-diagnostic SEs; ``geo_closed`` / ``geo_sample`` expose the CV pieces.
    """
    full_f32()
    idx = path_indices(n_paths, indices, device)
    grid = TimeGrid(T, n_avg * steps_per_avg)
    s = simulate_gbm_log(idx, grid, s0, r, sigma, seed=seed, scramble=scramble,
                         store_every=steps_per_avg, dtype=dtype)[:, 1:]  # (n, m)
    disc = math.exp(-r * T)
    arith = disc * torch.clamp(torch.mean(s, dim=1) - k, min=0.0)
    # geometric leg: log of S_t/s0 ~ O(1) ratios (well-conditioned f32 log)
    s0_t = torch.tensor(s0, dtype=dtype, device=s.device)
    geo = s0_t * torch.exp(torch.mean(torch.log(s / s0_t), dim=1))
    geo_pay = disc * torch.clamp(geo - k, min=0.0)
    geo_closed = geometric_asian_call(s0, k, r, sigma, T, n_avg)

    n = arith.shape[0]
    plain = float(torch.mean(arith))
    geo_sample = float(torch.mean(geo_pay))
    controlled = plain + (geo_closed - geo_sample)  # beta = 1 control
    resid_std = float(torch.std(arith - geo_pay, correction=0))
    return {
        "price": controlled,
        "se": resid_std / math.sqrt(n),
        "plain": plain,
        "se_plain": float(torch.std(arith, correction=0)) / math.sqrt(n),
        "geo_closed": geo_closed,
        "geo_sample": geo_sample,
        "n_paths": int(n),
        "n_avg": n_avg,
    }
