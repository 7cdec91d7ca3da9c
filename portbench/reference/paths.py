"""The two configurations' path models in plain PyTorch, step by step.

- :func:`gbm_knots`: exact log-Euler GBM, ``log S_t = log S_{t-1} + (r -
  sigma^2/2) dt + sigma sqrt(dt) z_t``, one Sobol dimension a step (``t - 1``),
  the constants rounded once from f64 to f32, ``S = s0 exp(log-return)`` at
  every ``store_every``-th step.
- :func:`pension_knots`: the coupled pension system of the assignment (pp.
  3-4): the fund ``Y_t = Y_{t-1} (1 + mu dt + sigma sqrt(dt) z0)``, the
  mortality intensity ``lam_t = lam_{t-1} + c lam_{t-1} dt + eta sqrt(dt) z1``,
  the survivors ``N_t = N_{t-1} - D_t`` with ``D_t ~ Binomial(N_{t-1}, 1 -
  exp(-lam_t dt))`` drawn by inverting its CDF from the uniform of factor 3
  (the normal approximation where the mean exceeds 45 deaths). Factor ``f`` of
  step ``t`` is Sobol dimension ``4 (t - 1) + f``.

Both run on whatever device their row indices live on; each row has its own
scramble seed.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.sobol import Points, ndtri_as241

INVERSION_TRIPS = 128
INVERSION_MEAN_MAX = 45.0


def gbm_knots(idx: torch.Tensor, seeds: torch.Tensor, *, n_steps: int, store_every: int,
              s0: float, drift: float, sigma: float, dt: float) -> torch.Tensor:
    """``(n, n_steps // store_every + 1)`` f32 knots of rows ``idx``."""
    pts = Points(idx, seeds)
    c0 = float((drift - 0.5 * sigma * sigma) * dt)
    vol = float(sigma * dt ** 0.5)
    logs = torch.zeros(idx.shape[0], dtype=torch.float32, device=idx.device)
    outs = [logs]
    for t in range(1, n_steps + 1):
        z = ndtri_as241(pts.uniforms([t - 1]))[:, 0]
        logs = logs + c0 + vol * z
        if t % store_every == 0:
            outs.append(logs)
    return torch.tensor(s0, dtype=torch.float32) * torch.exp(torch.stack(outs, dim=1))


def inversion_deaths(u, n, q, pmf0, z_clt):
    """``D ~ Binomial(n, q)`` by the CDF walk ``pmf_k = pmf_{k-1} (n-k+1)/k q/(1-q)``
    from ``u`` (``D = #{k <= 128 : cdf_{k-1} < u}``), or ``clip(round(n q + sd
    z_clt), 0, n)`` where ``n q > 45``. A trip that leaves the cdf unchanged
    while the next multiplier is at most 1/2 can never move it again: such an
    element below ``u`` ends at 128."""
    mean_d = n * q
    ratio = q / torch.clamp(1.0 - q, min=1e-30)
    cdf, pmf = pmf0, pmf0
    deaths = torch.zeros_like(n)
    walking = mean_d <= INVERSION_MEAN_MAX
    stuck = torch.zeros_like(walking)
    ks = torch.arange(1, INVERSION_TRIPS + 2, dtype=n.dtype, device=n.device)
    for k in range(1, INVERSION_TRIPS + 1):
        below = cdf < u
        if not bool((below & walking & ~stuck).any()):
            break
        pmf = torch.clamp(pmf * (n - (k - 1.0)) / ks[k - 1] * ratio, min=0.0)
        deaths = torch.where(below, ks[k - 1], deaths)
        moved = cdf + pmf
        stuck |= (moved == cdf) & ((n - float(k)) / ks[k] * ratio <= 0.5)
        cdf = moved
    deaths = torch.where(stuck & (cdf < u), ks[INVERSION_TRIPS - 1], deaths)
    sd_d = torch.sqrt(torch.clamp(n * q * (1.0 - q), min=0.0))
    clt = torch.minimum(torch.clamp(torch.round(mean_d + sd_d * z_clt), min=0.0), n)
    return torch.where(walking, deaths, clt)


def pension_knots(idx: torch.Tensor, seeds: torch.Tensor, *, n_steps: int, store_every: int,
                  y0: float, mu: float, sigma: float, l0: float, mort_c: float, eta: float,
                  n0: float, dt: float) -> dict[str, torch.Tensor]:
    """``{"Y", "lam", "N"}`` of ``(n, n_steps // store_every + 1)`` f32."""
    pts = Points(idx, seeds)
    n = idx.shape[0]
    dev = idx.device
    sdt = math.sqrt(dt)
    y = torch.full((n,), y0, dtype=torch.float32, device=dev)
    lam = torch.full((n,), l0, dtype=torch.float32, device=dev)
    pop = torch.full((n,), n0, dtype=torch.float32, device=dev)
    outs = [(y, lam, pop)]
    for t in range(1, n_steps + 1):
        base = 4 * (t - 1)
        u = pts.uniforms([base, base + 1, base + 3])
        z = ndtri_as241(u)
        y = y * (1 + mu * dt + sigma * sdt * z[:, 0])
        lam = lam + mort_c * lam * dt + eta * sdt * z[:, 1]
        p = torch.exp(-lam * dt)
        q = 1.0 - p
        pmf0 = torch.exp(-pop * lam * dt)
        pop = torch.clamp(pop - inversion_deaths(u[:, 2], pop, q, pmf0, z[:, 2]), min=0.0)
        if t % store_every == 0:
            outs.append((y, lam, pop))
    return {k: torch.stack([o[j] for o in outs], dim=1) for j, k in enumerate(("Y", "lam", "N"))}
