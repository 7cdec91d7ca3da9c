"""Price/implied-vol surfaces from a single Sobol path set (counterpart of
``orp_tpu/risk/surface.py``).

The simulation stores every maturity knot, so ONE path set prices the whole
maturity axis, and the strike axis is a per-strike payoff mean over the same
paths: an (n_maturities x n_strikes) European surface from one simulation,
then inverted to Black-Scholes implied vols by a vectorized Newton iteration
(closed-form vega) over the whole grid.

Under flat-vol GBM the recovered smile must be flat at the input sigma; with
Heston paths the same machinery produces the model's skew.

Strikes are swept one at a time (the JAX package's ``lax.map``), so the
(n_paths, m, K) payoff tensor never materialises: each strike is one
subtract/max/mean over the stored (n_paths, m) knots. The Newton solve runs
elementwise on the device of the prices. Entry points run on the card unless
``device`` (or an ``indices`` tensor) says otherwise.
"""

from __future__ import annotations

import math

import torch

from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import heston_sim_fn, simulate_gbm_log
from orp_tpu_torch.utils.device import path_indices
from orp_tpu_torch.utils.precision import full_f32

_INV_SQRT_2PI = 0.3989422804014327


def _surface_from_paths(s: torch.Tensor, times: torch.Tensor, strikes: torch.Tensor, r: float,
                        kind: str) -> torch.Tensor:
    """(m, K) discounted payoff means from stored knots ``s``: (n, m)."""
    disc = torch.exp(-r * times)  # (m,)
    sign = 1.0 if kind == "call" else -1.0
    cols = [disc * torch.mean(torch.clamp(sign * (s - k), min=0.0), dim=0) for k in strikes]
    return torch.stack(cols, dim=1)  # (m, K)


def implied_vol(prices, s0: float, strikes, times, r: float, *, kind: str = "call",
                n_iter: int = 25, sigma0: float = 0.3) -> torch.Tensor:
    """Black-Scholes implied vol over a (m, K) price grid by vectorized
    Newton with the closed-form vega, on the device and in the dtype of
    ``prices`` (``strikes`` and ``times`` are taken in that dtype). Entries
    whose price sits outside the no-arbitrage band (below intrinsic-forward
    or above the s0/K bound) return NaN."""
    prices = torch.as_tensor(prices)
    like = dict(dtype=prices.dtype, device=prices.device)
    k = torch.as_tensor(strikes).to(**like)[None, :]
    t = torch.as_tensor(times).to(**like)[:, None]
    disc = torch.exp(-r * t)
    sign = 1.0 if kind == "call" else -1.0
    lower = torch.clamp(sign * (s0 - k * disc), min=0.0)  # forward intrinsic
    upper = torch.full_like(k * disc, s0) if sign > 0 else k * disc
    # time value below ~1e-5 of spot scale is not invertible (vega ~ 0 and
    # the price sits inside its own QMC/f32 noise of the intrinsic floor)
    eps = 1e-5 * s0
    ok = (prices > lower + eps) & (prices < upper - eps) & (t > 0)

    sqrt_t = torch.sqrt(torch.clamp(t, min=1e-12))
    log_mny = torch.log(s0 / k)
    sig = torch.full(prices.shape, sigma0, **like)
    for _ in range(n_iter):
        d1 = (log_mny + (r + 0.5 * sig * sig) * t) / (sig * sqrt_t)
        d2 = d1 - sig * sqrt_t
        nd1 = torch.special.ndtr(sign * d1)
        nd2 = torch.special.ndtr(sign * d2)
        model = sign * (s0 * nd1 - k * disc * nd2)
        vega = s0 * sqrt_t * _INV_SQRT_2PI * torch.exp(-0.5 * d1 * d1)
        step = (model - prices) / torch.clamp(vega, min=1e-8)
        # damped, positivity-preserving update
        sig = torch.clamp(sig - torch.clamp(step, -0.5, 0.5), 1e-4, 5.0)
    return torch.where(ok, sig, torch.full_like(sig, math.nan))


def price_surface(n_paths: int, s0: float, r: float, sigma: float, strikes, T: float, *,
                  kind: str = "call", n_maturities: int = 52, steps_per_maturity: int = 7,
                  seed: int = 1234, scramble: str = "owen", indices=None, with_iv: bool = True,
                  dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """European price (and implied-vol) surface over ``strikes`` x
    ``n_maturities`` equally spaced maturities, from ONE GBM-Sobol path set.
    Returns ``{"times", "strikes", "prices", "iv"?}`` with prices of shape
    (n_maturities, n_strikes), on the paths' device."""
    idx, strikes, grid = _surface_prelude(kind, indices, n_paths, strikes, T, n_maturities,
                                          steps_per_maturity, dtype, device)
    s = simulate_gbm_log(idx, grid, s0, r, sigma, seed=seed, scramble=scramble,
                         store_every=steps_per_maturity, dtype=dtype)[:, 1:]  # drop t=0
    return _assemble_surface(s, s0, strikes, r, T, n_maturities, kind, with_iv, dtype)


def heston_price_surface(n_paths: int, s0: float, r: float, strikes, T: float, *, v0: float,
                         kappa: float, theta: float, xi: float, rho: float, kind: str = "call",
                         n_maturities: int = 52, steps_per_maturity: int = 7, seed: int = 1234,
                         scramble: str = "owen", indices=None, with_iv: bool = True,
                         scheme: str = "qe", dtype=torch.float32,
                         device=None) -> dict[str, torch.Tensor]:
    """The same one-simulation surface under HESTON dynamics: the
    Black-Scholes inversion produces the model's SKEW. ``scheme``: "qe"
    (Andersen QE-M, default) or "euler" (full-truncation), both on the scan
    path (``sde.heston_sim_fn``), as in the JAX package."""
    idx, strikes, grid = _surface_prelude(kind, indices, n_paths, strikes, T, n_maturities,
                                          steps_per_maturity, dtype, device)
    sim = heston_sim_fn(scheme)
    traj = sim(idx, grid, s0=s0, mu=r, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho,
               seed=seed, scramble=scramble, store_every=steps_per_maturity, dtype=dtype)
    return _assemble_surface(traj["S"][:, 1:], s0, strikes, r, T, n_maturities, kind, with_iv,
                             dtype)


def _surface_prelude(kind, indices, n_paths, strikes, T, n_maturities, steps_per_maturity,
                     dtype, device):
    """Shared argument validation/setup for every dynamics variant."""
    if kind not in ("call", "put"):
        raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
    full_f32()
    idx = path_indices(n_paths, indices, device)
    return (idx, torch.as_tensor(strikes, dtype=dtype).to(idx.device),
            TimeGrid(T, n_maturities * steps_per_maturity))


def _assemble_surface(s, s0, strikes, r, T, n_maturities, kind, with_iv, dtype):
    """Shared epilogue: (n, m) stored knots -> price (+ IV) surface dict."""
    times = (torch.arange(1, n_maturities + 1, dtype=dtype, device=s.device)
             * torch.tensor(T / n_maturities, dtype=dtype, device=s.device))
    prices = _surface_from_paths(s, times, strikes, r, kind)
    out = {"times": times, "strikes": strikes, "prices": prices}
    if with_iv:
        out["iv"] = implied_vol(prices, s0, strikes, times, r, kind=kind)
    return out
