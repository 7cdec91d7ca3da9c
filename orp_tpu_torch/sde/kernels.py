"""SDE simulation on the Sobol stream: GBM, Heston, the pension system and the correlated basket (counterpart of ``orp_tpu/sde/kernels.py``).

Time is a Python loop (the JAX package's ``lax.scan``); paths are a flat
vector axis. Step ``t`` (1-based) consumes Sobol dimensions
``(t-1)*n_factors + f``, so the full ``(n_paths, n_steps)`` increment matrix
never materialises, and ``store_every`` keeps only the rebalance knots.
The Heston and pension steps are shared with the fused kernel's plain twins
(``qmc/fused_mf.py``), which differ only in the inverse normal and in the
raw uniform that QE's variance draw and the pension's inversion sampler read.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from orp_tpu_torch.qmc.sobol import N_DIMS, sobol_uniform
from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.utils import threefry
from orp_tpu_torch.utils.device import as_indices
from orp_tpu_torch.utils.precision import full_f32

# step_fn(state, z, t, dt) -> new_state; z is (n, n_factors), t the 1-based step
StepFn = Callable[[Any, torch.Tensor, int, float], Any]


def scan_sde(step_fn: StepFn, state0, out_fn: Callable[[Any], torch.Tensor],
             indices: torch.Tensor, grid: TimeGrid, n_factors: int, seed: int, *,
             scramble: str = "owen", store_every: int = 1, dtype=torch.float32,
             inverse_normal: Callable[[torch.Tensor], torch.Tensor] = torch.special.ndtri):
    """Drive ``step_fn`` over the grid, storing ``out_fn(state)`` every ``store_every``.

    ``inverse_normal`` maps the Sobol uniforms to the step's normals: ``ndtri``
    on the scan path, AS241 in the fused kernel's plain version.

    Returns ``(final_state, trajectory)`` with ``trajectory`` of shape
    ``(n_paths, n_steps // store_every + 1)``; column 0 is the initial condition.
    """
    if grid.n_steps % store_every != 0:
        raise ValueError(f"store_every={store_every} must divide n_steps={grid.n_steps}")
    if grid.n_steps * n_factors > N_DIMS:
        raise ValueError(
            f"n_steps*n_factors = {grid.n_steps * n_factors} exceeds the "
            f"{N_DIMS}-dimension Sobol direction table")
    factor_ids = torch.arange(n_factors, dtype=torch.int64, device=indices.device)
    state = state0
    outs = [out_fn(state0)]
    for t in range(1, grid.n_steps + 1):
        z = inverse_normal(sobol_uniform(indices, (t - 1) * n_factors + factor_ids, seed,
                                         scramble=scramble, dtype=dtype))
        state = step_fn(state, z, t, grid.dt)
        if t % store_every == 0:
            outs.append(out_fn(state))
    return state, torch.stack(outs, dim=1)


def simulate_gbm_arithmetic(indices, grid: TimeGrid, y0: float, mu: float, sigma: float,
                            seed: int = 1235, *, scramble: str = "owen", store_every: int = 1,
                            dtype=torch.float32, n_factors: int = 1, factor: int = 0,
                            device=None) -> torch.Tensor:
    """Arithmetic-Euler GBM ``Y_t = Y_{t-1} (1 + mu dt + sigma sqrt(dt) Z_t)``,
    the reference's pension fund (RP.py:64-65): ``(n_paths, n_knots)``.
    ``n_factors``/``factor`` place the asset inside a wider factor layout.
    Runs on ``indices``' device when it is a tensor, else on ``device`` (``None``:
    the card)."""
    indices = as_indices(indices, device)
    sdt = (torch.tensor(grid.dt, dtype=dtype) ** 0.5).to(indices.device)

    def step(y, z, t, dt):
        return y * (1 + mu * dt + sigma * sdt * z[:, factor])

    state0 = torch.full(indices.shape, y0, dtype=dtype, device=indices.device)
    _, traj = scan_sde(step, state0, lambda y: y, indices, grid, n_factors, seed,
                       scramble=scramble, store_every=store_every, dtype=dtype)
    return traj


def simulate_gbm_log(indices, grid: TimeGrid, s0: float, drift: float, sigma: float,
                     seed: int = 1234, *, scramble: str = "owen", store_every: int = 1,
                     dtype=torch.float32, n_factors: int = 1, factor: int = 0) -> torch.Tensor:
    """Exact log-Euler GBM ``S_t = S_{t-1} exp((drift - sigma^2/2) dt + sigma sqrt(dt) Z)``.

    The accumulator is the log-RETURN (state0 = 0) and ``s0`` scales the
    output at the end: seeding it with a device-side ``log(s0)`` multiplies
    every path by the same rounding error (SCALING.md §6d).
    """
    indices = torch.as_tensor(indices).to(torch.int64)
    sdt = torch.tensor(grid.dt, dtype=dtype) ** 0.5
    c0 = (drift - 0.5 * sigma * sigma) * grid.dt
    vol = (sigma * sdt).to(indices.device)

    def step(logs, z, t, dt):
        return logs + c0 + vol * z[:, factor]

    state0 = torch.zeros(indices.shape, dtype=dtype, device=indices.device)
    _, traj = scan_sde(step, state0, lambda x: x, indices, grid, n_factors, seed,
                       scramble=scramble, store_every=store_every, dtype=dtype)
    return torch.tensor(s0, dtype=dtype, device=indices.device) * torch.exp(traj)


# ---------------------------------------------------------------------------
# Heston: full-truncation Euler and Andersen QE-M (v is variance)
# ---------------------------------------------------------------------------


def heston_euler_step(*, mu: float, kappa: float, theta: float, xi: float, rho: float,
                      sdt) -> StepFn:
    """Full-truncation Euler step on ``(logs, v)``; ``z[:, 0]`` is the asset's
    own normal, ``z[:, 1]`` the variance's. ``sdt`` is ``sqrt(dt)``: a device
    f32 scalar on the scan path, a host-f64 float in the fused kernel's twin."""
    rho_c = (1.0 - rho * rho) ** 0.5

    def step(state, z, t, dt):
        logs, v = state
        vp = torch.clamp(v, min=0.0)
        zs = rho * z[:, 1] + rho_c * z[:, 0]
        logs = logs + (mu - 0.5 * vp) * dt + torch.sqrt(vp) * sdt * zs
        v = v + kappa * (theta - vp) * dt + xi * torch.sqrt(vp) * sdt * z[:, 1]
        return (logs, v)

    return step


def _heston_out(s0: float, traj: torch.Tensor) -> dict[str, torch.Tensor]:
    """``(n, knots, 2)`` stacked ``(logs, v)`` -> ``{"S": s0 exp(logs), "v": v}``."""
    return {"S": s0 * torch.exp(traj[..., 0]), "v": traj[..., 1]}


def _heston_state0(n: int, v0: float, dtype, device):
    # log-return accumulator (state0 = 0, S = s0 exp): no device log(s0) (SCALING.md §6d)
    return (torch.zeros(n, dtype=dtype, device=device),
            torch.full((n,), v0, dtype=dtype, device=device))


def _stack_state(s):
    return torch.stack(s, dim=-1)


def simulate_heston_log(indices, grid: TimeGrid, *, s0: float, mu: float, v0: float,
                        kappa: float, theta: float, xi: float, rho: float = 0.0,
                        seed: int = 1234, scramble: str = "owen", store_every: int = 1,
                        dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Full-truncation-Euler Heston: ``dv = kappa(theta-v)dt + xi sqrt(v dt) Zv``,
    ``dlogS = (mu - v/2)dt + sqrt(v dt)(rho Zv + sqrt(1-rho^2) Zs)``; returns
    ``{"S", "v"}`` of ``(n_paths, n_knots)``."""
    indices = torch.as_tensor(indices).to(torch.int64)
    sdt = (torch.tensor(grid.dt, dtype=dtype) ** 0.5).to(indices.device)
    step = heston_euler_step(mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho, sdt=sdt)
    _, traj = scan_sde(step, _heston_state0(indices.shape[0], v0, dtype, indices.device),
                       _stack_state, indices, grid, 2, seed, scramble=scramble,
                       store_every=store_every, dtype=dtype)
    return _heston_out(s0, traj)


_QE_G1 = 0.5  # central integrated-variance weights (gamma1 = gamma2)


def qe_step_constants(kappa: float, theta: float, xi: float, rho: float,
                      dt: float) -> dict[str, float]:
    """The QE-M per-step constants in HOST f64, shared by the scan step and
    the fused kernel: ``E`` (mean-reversion factor), ``c1``/``c2``
    (conditional variance ``s^2 = c1*v + c2``), ``k1..k4`` (Andersen's
    integrated-variance weights at the central gammas) and ``A = k2 + k4/2``
    (the MGF argument whose sign decides the martingale correction)."""
    E = math.exp(-kappa * dt)
    g1 = g2 = _QE_G1
    k2 = g2 * dt * (kappa * rho / xi - 0.5) + rho / xi
    k4 = g2 * dt * (1.0 - rho * rho)
    return {
        "E": E,
        "c1": xi * xi * E * (1.0 - E) / kappa,
        "c2": theta * xi * xi * (1.0 - E) ** 2 / (2.0 * kappa),
        "k1": g1 * dt * (kappa * rho / xi - 0.5) - rho / xi,
        "k2": k2,
        "k3": g1 * dt * (1.0 - rho * rho),
        "k4": k4,
        "A": k2 + 0.5 * k4,
    }


def qe_mgf_argument(kappa: float, xi: float, rho: float, dt: float) -> float:
    """``A = K2 + K4/2``, the argument of ``E[exp(A v')]`` in QE-M's martingale
    correction; the correction exists when ``A <= 0``. (A is theta-free.)"""
    return qe_step_constants(kappa, 0.0, xi, rho, dt)["A"]


def heston_qe_step(*, mu: float, kappa: float, theta: float, xi: float, rho: float,
                   dt: float, psi_c: float = 1.5, variance_draw) -> StepFn:
    """Andersen QE-M step on ``(logs, v)`` with the host-f64 constants.

    ``z[:, 0]`` is the asset's normal; ``variance_draw(z[:, 1])`` returns
    ``(zv, u_comp)``, the variance normal and the exponential branch's uniform
    complement ``1 - U``: ``(zv, ndtr(-zv))`` on the scan path, ``(AS241(u),
    1 - u)`` from the raw uniform in the fused kernel's twin. Both branches are
    computed with guarded inputs and selected per path."""
    C = qe_step_constants(kappa, theta, xi, rho, dt)
    E, c1, c2 = C["E"], C["c1"], C["c2"]
    k1, k2, k3, k4, A = C["k1"], C["k2"], C["k3"], C["k4"], C["A"]
    mu_dt = mu * dt
    tiny = 1e-12

    def step(state, z, t, dt_):
        logs, v = state
        zs = z[:, 0]
        zv, u_comp = variance_draw(z[:, 1])
        m = theta + (v - theta) * E                 # exact conditional mean
        s2 = v * c1 + c2                            # exact conditional variance
        psi = s2 / torch.clamp(m * m, min=tiny)
        # quadratic branch (psi <= psi_c): v' = a (b + Zv)^2
        invpsi = 2.0 / torch.clamp(psi, min=tiny)
        tq = torch.clamp(invpsi - 1.0, min=0.0)
        b2 = tq + torch.sqrt(invpsi) * torch.sqrt(tq)
        a = m / (1.0 + b2)
        v_q = a * torch.square(torch.sqrt(b2) + zv)
        # exponential branch (psi > psi_c): P[v' = 0] = p, else rate beta
        p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-6)
        beta = (1.0 - p) / torch.clamp(m, min=tiny)
        v_e = torch.where(u_comp >= 1.0 - p, 0.0, torch.log((1.0 - p) / u_comp) / beta)
        quad = psi <= psi_c
        v_next = torch.where(quad, v_q, v_e)
        if A <= 0.0:
            # martingale correction K0* = -ln E[exp(A v')|v] - (k1 + k3/2) v
            den_q = torch.clamp(1.0 - 2.0 * A * a, min=1e-6)
            ln_m_q = A * b2 * a / den_q - 0.5 * torch.log(den_q)
            ln_m_e = torch.log(torch.clamp(
                p + beta * (1.0 - p) / torch.clamp(beta - A, min=tiny), min=tiny))
            k0s = -torch.where(quad, ln_m_q, ln_m_e) - (k1 + 0.5 * k3) * v
        else:
            # A > 0: K0* does not exist; plain-QE drift (Andersen §3.2.4)
            k0s = -rho * kappa * theta * dt / xi
        gauss = torch.sqrt(torch.clamp(k3 * v + k4 * v_next, min=0.0)) * zs
        logs = logs + mu_dt + k0s + k1 * v + k2 * v_next + gauss
        return (logs, v_next)

    return step


def simulate_heston_qe(indices, grid: TimeGrid, *, s0: float, mu: float, v0: float,
                       kappa: float, theta: float, xi: float, rho: float = 0.0,
                       seed: int = 1234, scramble: str = "owen", store_every: int = 1,
                       dtype=torch.float32, psi_c: float = 1.5) -> dict[str, torch.Tensor]:
    """Andersen QE-M Heston (moment-matched variance draw + martingale-corrected
    log step); the exponential branch's uniform is ``ndtr(-Zv)`` of the same
    Sobol normal that feeds the quadratic branch. Returns ``{"S", "v"}``."""
    indices = torch.as_tensor(indices).to(torch.int64)

    def draw(zv):
        return zv, torch.clamp(torch.special.ndtr(-zv), min=1e-12)

    step = heston_qe_step(mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho, dt=grid.dt,
                          psi_c=psi_c, variance_draw=draw)
    _, traj = scan_sde(step, _heston_state0(indices.shape[0], v0, dtype, indices.device),
                       _stack_state, indices, grid, 2, seed, scramble=scramble,
                       store_every=store_every, dtype=dtype)
    return _heston_out(s0, traj)


# ---------------------------------------------------------------------------
# Pension model: fund + mortality + binomial population (coupled system)
# ---------------------------------------------------------------------------


_INVERSION_K = 128  # the CDF walk's trip count (terms D = 0..128)
_INVERSION_MEAN_MAX = 45.0  # per-element switch to the CLT draw: the walk covers
# mean death counts with mean + 12 sd <= K and pmf(0) = e^-m far above f32 underflow


def binomial_inversion_deaths(u: torch.Tensor, n: torch.Tensor, q: torch.Tensor,
                              pmf0: torch.Tensor, z_clt: torch.Tensor,
                              stuck_at: torch.Tensor | None = None) -> torch.Tensor:
    """Invert ``D ~ Binomial(n, q)`` from the uniform ``u`` by the CDF walk
    ``pmf_k = pmf_{k-1} (n-k+1)/k q/(1-q)``, ``D = #{k : cdf_{k-1} < u}`` over
    ``k = 1..128``, with the CLT draw ``clip(round(n q + sd z_clt), 0, n)``
    where the mean death count exceeds ``_INVERSION_MEAN_MAX``.

    The walk stops once every walking element has ``cdf >= u`` or a stuck
    ``cdf``, with the counts of the JAX function's fixed 128 trips: ``cdf``
    never falls (``pmf >= 0``), so past ``cdf >= u`` no count changes. In f32
    ``q`` carries the cancellation of ``1 - p``, so the cdf can plateau below 1
    and a ``u`` above the plateau takes all 128 trips. A trip that leaves
    ``cdf`` unchanged while the next multiplier ``(n-k)/(k+1) q/(1-q)`` is at
    most 1/2 marks the element stuck: every later ``pmf`` is smaller, so no
    later trip moves ``cdf`` either, and a stuck element below ``u`` ends at
    128. The division by ``k`` is by a device tensor, so a CUDA run divides
    and does not multiply by a rounded reciprocal. ``stuck_at``, where given
    (a tensor like ``n``), receives the trip at which each element became
    stuck and keeps its value where none did."""
    mean_d = n * q
    ratio = q / torch.clamp(1.0 - q, min=1e-30)
    cdf, pmf = pmf0, pmf0
    deaths = torch.zeros_like(n)
    walking = mean_d <= _INVERSION_MEAN_MAX
    stuck = torch.zeros_like(walking)
    ks = torch.arange(1, _INVERSION_K + 2, dtype=n.dtype, device=n.device)
    for k in range(1, _INVERSION_K + 1):
        below = cdf < u
        if not bool((below & walking & ~stuck).any()):
            break
        pmf = torch.clamp(pmf * (n - (k - 1.0)) / ks[k - 1] * ratio, min=0.0)
        deaths = torch.where(below, ks[k - 1], deaths)
        moved = cdf + pmf
        now = (moved == cdf) & ((n - float(k)) / ks[k] * ratio <= 0.5)
        if stuck_at is not None:
            stuck_at.copy_(torch.where(now & ~stuck, ks[k - 1], stuck_at))
        stuck |= now
        cdf = moved
    deaths = torch.where(stuck & (cdf < u), ks[_INVERSION_K - 1], deaths)
    sd_d = torch.sqrt(torch.clamp(n * q * (1.0 - q), min=0.0))
    deaths_clt = torch.clamp(torch.round(mean_d + sd_d * z_clt), min=0.0)
    deaths_clt = torch.minimum(deaths_clt, n)
    return torch.where(walking, deaths, deaths_clt)


def thin_normal(pop: torch.Tensor, lam: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
                dt: float) -> torch.Tensor:
    """Moment-matched normal thinning ``clip(round(n p + sqrt(n p (1-p)) z), 0, n)``
    (round half to even, as ``jnp.round``)."""
    mean = pop * p
    var = pop * p * (1 - p)
    draw = torch.round(mean + torch.sqrt(torch.clamp(var, min=0.0)) * z)
    return torch.minimum(torch.clamp(draw, min=0.0), pop)


def thin_inversion(pop: torch.Tensor, lam: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """The scan path's inversion thinning: ``u = ndtr(z)`` of the step's
    normal, ``pmf(0) = exp(-n lam dt)`` from the analytic ``-log p = lam dt``,
    and ``z`` itself as the CLT normal."""
    u = torch.special.ndtr(z)
    q = torch.clamp(1.0 - p, 0.0, 1.0)
    pmf0 = torch.exp(-pop * (lam * dt))
    deaths = binomial_inversion_deaths(u, pop, q, pmf0, z)
    return torch.clamp(pop - deaths, min=0.0)


def pension_step(*, mu: float, sigma: float | None, mort_c: float, eta: float, sdt,
                 thin, sv: bool = False, cir_a: float = 0.0, cir_b: float = 0.0,
                 cir_c: float = 0.0, cir_drift_times_dt: bool = False) -> StepFn:
    """One step of the coupled system on ``(y, lam, N)`` or, with ``sv``,
    ``(log-return, v, lam, N)``. Factor 0 is the fund's normal, 1 the
    mortality's, 2 the CIR vol's (``sv`` only), 3 the population's draw,
    which ``thin(pop, lam, p, z3, dt)`` turns into the survivors.

    Fund: ``y (1 + mu dt + sigma sdt z0)`` (RP.py:64-65), or the CIR-vol log
    fund ``v' = v + a(b - v)[dt] + c sqrt(v dt) z2``, ``logy += (mu - v'^2/2) dt
    + v' sdt z0`` (RP.py:280-289; ``cir_drift_times_dt=False`` keeps the
    reference's missing dt). Mortality ``lam + c lam dt + eta sdt z1``
    (RP.py:75-76), survival ``p = exp(-lam dt)``. ``sdt`` is ``sqrt(dt)``: a
    device f32 scalar on the scan path, a host-f64 float in the fused
    kernel's twin."""
    if not sv and sigma is None:
        raise ValueError("sigma is required when sv=False (constant-vol fund)")

    def step(state, z, t, dt):
        if sv:
            logy, v, lam, pop = state
            drift_scale = dt if cir_drift_times_dt else 1.0
            v_new = (v + cir_a * (cir_b - v) * drift_scale
                     + cir_c * torch.sqrt(torch.clamp(v * dt, min=0.0)) * z[:, 2])
            logy = logy + (mu - 0.5 * v_new * v_new) * dt + v_new * sdt * z[:, 0]
        else:
            y, lam, pop = state
            y = y * (1 + mu * dt + sigma * sdt * z[:, 0])
        lam = lam + mort_c * lam * dt + eta * sdt * z[:, 1]
        p = torch.exp(-lam * dt)
        pop = thin(pop, lam, p, z[:, 3], dt)
        return (logy, v_new, lam, pop) if sv else (y, lam, pop)

    return step


def pension_state0(n: int, *, y0: float, l0: float, n0: float, sv: bool, v0: float,
                   dtype, device) -> tuple:
    """Initial state; in SV mode the fund is a log-return accumulator (0) and
    ``y0`` scales the output, so no device log of ``y0`` is taken."""
    def full(x):
        return torch.full((n,), x, dtype=dtype, device=device)

    return (full(0.0), full(v0), full(l0), full(n0)) if sv else (full(y0), full(l0), full(n0))


def pension_out(traj: torch.Tensor, *, y0: float, sv: bool) -> dict[str, torch.Tensor]:
    """``(n, knots, slots)`` stacked state -> ``{"Y", "lam", "N"}`` (+ ``"v"``)."""
    if sv:
        return {"Y": y0 * torch.exp(traj[..., 0]), "v": traj[..., 1], "lam": traj[..., 2],
                "N": traj[..., 3]}
    return {"Y": traj[..., 0], "lam": traj[..., 1], "N": traj[..., 2]}


def thin_exact(pop: torch.Tensor, p: torch.Tensor, key: tuple[int, int],
               indices: torch.Tensor) -> torch.Tensor:
    """Exact binomial thinning: ``Binomial(N_{t-1}, p)`` survivors, path ``i``'s
    draw under the threefry key ``fold_in(key, indices[i])``, ``key`` being
    the step's ``fold_in(key(seed), t)`` (``utils/threefry.py``). A path's
    survivors are a function of ``(seed, t, global path index)`` alone, as in
    the JAX package: a prefix of the paths, or a shard of them, draws what
    those paths draw in the whole run. The sampler runs in float64, exact in
    law at any mean (the single-step grid thins ~10^4 lives in one step)."""
    k0, k1 = threefry.fold_in(key, indices)
    return threefry.binomial(k0, k1, pop, p).to(pop.dtype)


class _ExactThinning:
    """The scan path's ``thin`` for ``exact``: :func:`thin_exact` under step
    ``t``'s key, set by :meth:`at` before each step (the step's normal is not
    read, as in the JAX package)."""

    def __init__(self, seed: int, indices: torch.Tensor):
        self.key0, self.indices, self.key = threefry.seed_key(seed), indices, None

    def at(self, t: int) -> None:
        self.key = threefry.fold_in(self.key0, t)

    def __call__(self, pop, lam, p, z, dt):
        return thin_exact(pop, p, self.key, self.indices)


def check_binomial_mode(binomial_mode: str, name: str, *, exact: bool = True) -> None:
    """``exact``, ``inversion`` and ``normal``; ``exact=False`` (the fused
    kernel, the counterpart of the JAX package's Pallas engine) refuses the
    exact draw, as the JAX package does."""
    if binomial_mode not in ("exact", "inversion", "normal"):
        raise ValueError(f"{name}: binomial_mode={binomial_mode!r}: expected 'exact', "
                         "'inversion' or 'normal'")
    if binomial_mode == "exact" and not exact:
        raise ValueError(
            f"{name}: engine='pallas' supports binomial_mode 'normal' or 'inversion' (the "
            "exact binomial draw stays on the scan path); got binomial_mode='exact'")


def simulate_pension(indices, grid: TimeGrid, *, y0: float, mu: float,
                     sigma: float | None = None, l0: float, mort_c: float, eta: float,
                     n0: float, seed: int = 1234, scramble: str = "owen", store_every: int = 1,
                     dtype=torch.float32, binomial_mode: str = "exact", sv: bool = False,
                     v0: float = 0.0, cir_a: float = 0.0, cir_b: float = 0.0,
                     cir_c: float = 0.0,
                     cir_drift_times_dt: bool = False) -> dict[str, torch.Tensor]:
    """Coupled pension system, fund Y, mortality intensity lambda, survivors N,
    on the Sobol stream (4 factors per step; :func:`pension_step`).

    ``binomial_mode``: ``"exact"`` (the JAX default: :func:`thin_exact`, each
    path's draw addressed by ``(seed, t, indices[i])``), ``"inversion"``
    (exact-in-law CDF inversion of the death count from ``ndtr`` of the step's
    normal) or ``"normal"`` (moment-matched; biased about -0.9% in survivors
    at fine grids). Returns ``(n_paths,
    n_knots)`` tensors ``Y``, ``lam``, ``N`` (+ ``v`` when ``sv``)."""
    check_binomial_mode(binomial_mode, "simulate_pension")
    indices = torch.as_tensor(indices).to(torch.int64)
    dev = indices.device
    sdt = (torch.tensor(grid.dt, dtype=dtype) ** 0.5).to(dev)
    exact = _ExactThinning(seed, indices) if binomial_mode == "exact" else None
    thin = exact or {"inversion": thin_inversion, "normal": thin_normal}[binomial_mode]
    pstep = pension_step(mu=mu, sigma=sigma, mort_c=mort_c, eta=eta, sdt=sdt, thin=thin,
                         sv=sv, cir_a=cir_a, cir_b=cir_b, cir_c=cir_c,
                         cir_drift_times_dt=cir_drift_times_dt)

    def step(state, z, t, dt):
        if exact is not None:
            exact.at(t)
        return pstep(state, z, t, dt)

    state0 = pension_state0(indices.shape[0], y0=y0, l0=l0, n0=n0, sv=sv, v0=v0, dtype=dtype,
                            device=dev)
    _, traj = scan_sde(step, state0, _stack_state, indices, grid, 4, seed, scramble=scramble,
                       store_every=store_every, dtype=dtype)
    return pension_out(traj, y0=y0, sv=sv)


# ---------------------------------------------------------------------------
# Correlated multi-asset GBM basket (BASELINE.json config 5)
# ---------------------------------------------------------------------------


def basket_factor(corr, dtype=torch.float32) -> torch.Tensor:
    """The Cholesky factor of ``corr`` in ``dtype``, computed once on the host:
    the card and the CPU then correlate with the same ``(A, A)`` factor (a
    cuSOLVER and a LAPACK factor differ in their last ulps, which would part
    every path)."""
    return torch.linalg.cholesky(torch.as_tensor(np.asarray(corr), dtype=dtype))


def simulate_gbm_basket(indices, grid: TimeGrid, *, s0, drift, sigma, corr, seed: int = 1234,
                        scramble: str = "owen", store_every: int = 1,
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """Correlated log-Euler GBM of an A-asset basket: ``(n_paths, n_knots, A)``.

    Step ``t`` reads the A Sobol dimensions ``(t-1)*A + i`` (the JAX package's
    factor layout) and correlates them through ``z @ chol.T`` in full f32
    (``utils/precision.full_f32``: TF32 would tilt every shock), with ``chol``
    :func:`basket_factor` of ``corr``, computed on the host; the accumulator
    is each asset's log-RETURN and ``s0`` scales the output, so no device log
    is taken (SCALING.md §6d). Runs on ``indices``' device when it is a tensor,
    else on ``device`` (``None``: the card)."""
    indices = as_indices(indices, device)
    dev = indices.device
    full_f32()
    s0 = torch.as_tensor(np.asarray(s0), dtype=dtype)
    drift = torch.as_tensor(np.asarray(drift), dtype=dtype)
    sigma = torch.as_tensor(np.asarray(sigma), dtype=dtype)
    n_assets = s0.shape[0]
    chol_t = basket_factor(corr, dtype).T.to(dev)
    sdt = torch.tensor(grid.dt, dtype=dtype) ** 0.5
    c0 = ((drift - 0.5 * sigma * sigma) * grid.dt).to(dev)[None, :]
    vol = (sigma[None, :] * sdt).to(dev)

    def step(logs, z, t, dt):
        return logs + c0 + vol * (z @ chol_t)

    state0 = torch.zeros((indices.shape[0], n_assets), dtype=dtype, device=dev)
    _, traj = scan_sde(step, state0, lambda x: x, indices, grid, n_assets, seed,
                       scramble=scramble, store_every=store_every, dtype=dtype)
    return s0.to(dev) * torch.exp(traj)


#: the scenario-name -> simulator table: every consumer that selects a
#: scenario model by name goes through it, so a new model reaches all of them
_SIM_FNS = {
    "gbm": simulate_gbm_log,
    "gbm-arith": simulate_gbm_arithmetic,
    "heston-qe": simulate_heston_qe,
    "heston-euler": simulate_heston_log,
    "pension": simulate_pension,
    "basket": simulate_gbm_basket,
}


def resolve_sim_fn(kind: str):
    """The simulator of a scenario kind (:data:`_SIM_FNS`); an unknown kind
    raises with the full menu."""
    try:
        return _SIM_FNS[kind]
    except KeyError:
        raise ValueError(f"unknown scenario kind {kind!r} (known: {sorted(_SIM_FNS)})") from None


def heston_sim_fn(scheme: str):
    """The Heston simulator of a scheme name (``heston-<scheme>`` in
    :data:`_SIM_FNS`); ``api.pipelines.resolve_heston_scheme`` layers the
    ``None`` default on top for the pipeline configs."""
    if scheme not in ("qe", "euler"):
        raise ValueError(f"unknown Heston scheme {scheme!r} (expected 'qe' or 'euler')")
    return resolve_sim_fn(f"heston-{scheme}")
