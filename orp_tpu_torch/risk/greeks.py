"""Pathwise QMC greeks by forward-mode AD through the path recurrences (counterpart of ``orp_tpu/risk/greeks.py``).

- **delta, vega, rho** of a European option: pathwise (IPA) estimators, the
  a.s. derivative of the discounted payoff along each path, unbiased for the
  Lipschitz call and put; the parameters are ``(s0, sigma, drift, tau)``.
- **theta**: the tangent through ``tau``, a time dilation of every ``dt``;
  calendar theta is ``-(1/T) dV/dtau`` at ``tau = 1``.
- **gamma**: the pathwise second derivative of a kinked payoff is a.s. zero,
  so gamma is a common-random-numbers central difference of the pathwise
  delta at ``s0 (1 ± gamma_bump)`` (same Sobol points); only paths that end
  inside the bump window contribute.
- **digital** (:func:`digital_greeks`): likelihood-ratio delta and vega (the
  pathwise derivative of an indicator is a.s. zero); ``z`` is read from the
  accumulated log-return, so no device ``log`` is taken.
- **Heston** (:func:`heston_greeks`): delta, the four variance-dynamics
  sensitivities and rate rho through the full-truncation Euler recurrence,
  with the square root's tangent held at 0 where the variance is floored.
- **basket** (:func:`basket_greeks`): per-asset delta and vega vectors and
  rate rho through the correlated log-Euler recurrence.

Every path loop is the pricing engine's own (``sde/kernels.scan_sde``): the
Sobol draws stream per step outside the differentiated function, O(paths)
memory at any horizon. The tangents ride the recurrence as a batch: each step
is ``torch.func.jvp`` of the step function under ``torch.func.vmap`` over the
unit tangents, with the primal shared (the JAX package's ``vmap(jvp)`` in one
``lax.scan``). Standard errors are iid diagnostics only: Sobol points are not
iid. Entry points run on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TypedDict

import torch

from orp_tpu_torch.sde.grid import TimeGrid
from orp_tpu_torch.sde.kernels import basket_factor, scan_sde
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class GreeksResult:
    """Point estimates and iid-diagnostic standard errors."""

    price: float
    delta: float
    gamma: float
    vega: float
    rho: float
    theta: float
    se: dict[str, float]  # keys: price/delta/vega/rho/theta (gamma: FD of means)
    n_paths: int
    n_steps: int

    def as_dict(self) -> dict[str, float]:
        return {"price": self.price, "delta": self.delta, "gamma": self.gamma,
                "vega": self.vega, "rho": self.rho, "theta": self.theta}


def _first(tree):
    """The primal of a ``vmap(jvp)`` output: it is shared by the tangent batch."""
    if isinstance(tree, tuple):
        return tuple(x[0] for x in tree)
    return tree[0]


def _jvp_batch(fn, primals: tuple, tangents: tuple):
    """``(fn(*primals), its jvp along each tangent direction)``: every tangent
    carries a leading batch axis, the primals none."""
    out, t_out = torch.func.vmap(lambda *t: torch.func.jvp(fn, primals, t))(*tangents)
    return _first(out), t_out


def _pathwise(init, step, final, params: torch.Tensor, p_tan: torch.Tensor, indices,
              grid: TimeGrid, n_factors: int, seed: int, scramble: str, dtype):
    """The per-path value ``final(state, params)`` and its tangents ``(k, n)``
    along the rows of ``p_tan`` (``(k, P)``), through ``state = init(params)``
    and ``step(state, params, z, dt)`` on the Sobol stream of ``scan_sde``."""

    def lifted(state, z, t, dt):
        prim, tan = state
        return _jvp_batch(lambda s, p: step(s, p, z, dt), (prim, params), (tan, p_tan))

    state0 = _jvp_batch(init, (params,), (p_tan,))
    (prim, tan), _ = scan_sde(lifted, state0, lambda s: torch.zeros(1), indices, grid,
                              n_factors, seed, scramble=scramble, store_every=grid.n_steps,
                              dtype=dtype)
    return _jvp_batch(final, (prim, params), (tan, p_tan))


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` whose tangent is halved at a tie, as ``jnp.maximum``'s."""
    return torch.maximum(x, torch.zeros_like(x))


def _mean_se(x: torch.Tensor) -> tuple[float, float]:
    """(mean, iid-diagnostic standard error) of a per-path column."""
    return float(torch.mean(x)), float(torch.std(x, correction=0) / math.sqrt(x.shape[0]))


def _indices(n_paths: int, indices, device) -> torch.Tensor:
    """The Sobol point indices on the entry point's device (``None``: the card)."""
    dev = resolve_device(device)
    full_f32()
    if indices is None:
        return torch.arange(n_paths, dtype=torch.int64, device=dev)
    return torch.as_tensor(indices).to(device=dev, dtype=torch.int64)


def _check_kind(kind: str) -> None:
    if kind not in ("call", "put"):
        raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")


# ---------------------------------------------------------------------------
# European options: pathwise delta, vega, rho, theta; CRN gamma
# ---------------------------------------------------------------------------


def _european_fns(grid: TimeGrid, k: float, is_call: bool, n: int):
    """``(init, step, final)`` of the discounted payoff as a function of
    ``params = (s0, sigma, drift, tau)``: the log-RETURN recurrence of
    ``simulate_gbm_log`` with ``s0`` an output scale (no device log)."""

    def init(p):
        return p.new_zeros(n)

    def step(acc, p, z, dt):
        _, sigma, drift, tau = p
        dt_eff = tau * dt
        c0 = (drift - 0.5 * sigma * sigma) * dt_eff
        return acc + c0 + sigma * torch.sqrt(dt_eff) * z[:, 0]

    def final(acc, p):
        s0, _, drift, tau = p
        s_t = s0 * torch.exp(acc)
        payoff = _relu(s_t - k) if is_call else _relu(k - s_t)
        horizon = p.new_tensor(grid.T) * tau
        return torch.exp(-drift * horizon) * payoff

    return init, step, final


def european_greeks(n_paths: int, s0: float, k: float, r: float, sigma: float, T: float, *,
                    kind: str = "call", n_steps: int = 52, seed: int = 1234,
                    scramble: str = "owen", gamma_bump: float = 0.01, indices=None,
                    dtype=torch.float32, device=None) -> GreeksResult:
    """Price and (delta, gamma, vega, rho, theta) of a European option from one
    Sobol path set, by pathwise AD through the log-Euler recurrence.

    ``gamma_bump`` is the relative spot bump of the CRN delta difference;
    ``indices`` overrides the Sobol point range."""
    _check_kind(kind)
    idx = _indices(n_paths, indices, device)
    grid = TimeGrid(T, n_steps)
    params = torch.tensor([s0, sigma, r, 1.0], dtype=dtype, device=idx.device)
    fns = _european_fns(grid, k, kind == "call", idx.shape[0])

    def run(p, tangents):
        return _pathwise(*fns, p, tangents, idx, grid, 1, seed, scramble, dtype)

    v, jac = run(params, torch.eye(4, dtype=dtype, device=idx.device))
    price, se_price = _mean_se(v)
    delta, se_delta = _mean_se(jac[0])
    vega, se_vega = _mean_se(jac[1])
    rho, se_rho = _mean_se(jac[2])
    dv_dtau, se_tau = _mean_se(jac[3])
    # CRN central difference of the pathwise delta: same points, same scramble
    h = gamma_bump * s0
    e0 = torch.eye(4, dtype=dtype, device=idx.device)[:1]  # the s0 tangent alone
    dsum = torch.zeros((), dtype=dtype, device=idx.device)
    for sgn in (1.0, -1.0):
        bumped = params.clone()
        bumped[0] += sgn * h
        dsum = dsum + sgn * torch.mean(run(bumped, e0)[1][0])
    return GreeksResult(
        price=price, delta=delta, gamma=float(dsum) / (2.0 * h), vega=vega, rho=rho,
        theta=-dv_dtau / T,
        se={"price": se_price, "delta": se_delta, "vega": se_vega, "rho": se_rho,
            "theta": se_tau / T},
        n_paths=v.shape[0], n_steps=n_steps)


# ---------------------------------------------------------------------------
# Digital options: likelihood-ratio delta and vega
# ---------------------------------------------------------------------------


def digital_greeks(n_paths: int, s0: float, k: float, r: float, sigma: float, T: float, *,
                   kind: str = "call", n_steps: int = 52, seed: int = 1234,
                   scramble: str = "owen", indices=None, dtype=torch.float32,
                   device=None) -> dict[str, object]:
    """Cash-or-nothing digital: price and LIKELIHOOD-RATIO delta and vega.

    With ``z = (log(S_T/s0) - (r - sigma^2/2) T) / (sigma sqrt(T))``::

        delta = e^{-rT} E[1_payoff z / (s0 sigma sqrt(T))]
        vega  = e^{-rT} E[1_payoff ((z^2 - 1)/sigma - z sqrt(T))]

    ``z`` is the accumulated log-return of the engine's recurrence itself, so
    no device ``log`` is taken (re-logging ``s0 exp(acc)`` would bring back the
    ulp class of SCALING.md §6d)."""
    _check_kind(kind)
    idx = _indices(n_paths, indices, device)
    grid = TimeGrid(T, n_steps)
    sq = sigma * math.sqrt(T)
    acc_drift = (r - 0.5 * sigma * sigma) * T
    sdt = torch.tensor(grid.dt, dtype=dtype) ** 0.5
    c0 = (r - 0.5 * sigma * sigma) * grid.dt
    vol = (sigma * sdt).to(idx.device)

    def step(acc, zz, t, dt):
        return acc + c0 + vol * zz[:, 0]

    acc, _ = scan_sde(step, torch.zeros(idx.shape, dtype=dtype, device=idx.device),
                      lambda a: a, idx, grid, 1, seed, scramble=scramble,
                      store_every=n_steps, dtype=dtype)
    z = (acc - acc_drift) / sq
    s_t = torch.tensor(s0, dtype=dtype, device=idx.device) * torch.exp(acc)
    sign = 1.0 if kind == "call" else -1.0
    hit = (sign * (s_t - k) > 0.0).to(dtype)
    disc = torch.exp(torch.tensor(-r * T, dtype=dtype, device=idx.device))
    price, se_price = _mean_se(disc * hit)
    delta, se_delta = _mean_se(disc * hit * z / (s0 * sq))
    vega, se_vega = _mean_se(disc * hit * ((z * z - 1.0) / sigma - z * math.sqrt(T)))
    return {"price": price, "delta": delta, "vega": vega,
            "se": {"price": se_price, "delta": se_delta, "vega": se_vega},
            "n_paths": int(hit.shape[0]), "n_steps": n_steps}


# ---------------------------------------------------------------------------
# Heston: pathwise sensitivities through the full-truncation Euler recurrence
# ---------------------------------------------------------------------------


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt`` with tangent 0 at the truncation floor: at ``v = 0`` the
    tangent of ``sqrt`` is infinite and would poison every tangent of a path
    that touches the floor. The inner ``where`` keeps the primal exact and the
    tangent finite (0) where ``x <= 0``."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _heston_fns(grid: TimeGrid, k: float, is_call: bool, n: int, dtype, device):
    """``(init, step, final)`` of the discounted payoff as a function of
    ``params = (s0, v0, kappa, theta, xi, r)``: the recurrence of
    ``simulate_heston_log``, log-return accumulated. The step reads ``z =
    (zs, zv)``: the asset's normal, already correlated with the variance's
    (``rho`` is held fixed), and the variance's."""
    sdt = torch.sqrt(torch.tensor(grid.dt, dtype=dtype)).to(device)

    def init(p):
        return p.new_zeros(n), p[1] * p.new_ones(n)

    def step(state, p, z, dt):
        logs, v = state
        _, _, kappa, theta, xi, r = p
        zs, zv = z
        vp = _relu(v)
        sv = _safe_sqrt(vp)
        logs = logs + (r - 0.5 * vp) * dt + sv * sdt * zs
        v = v + kappa * (theta - vp) * dt + xi * sv * sdt * zv
        return logs, v

    def final(state, p):
        s_t = p[0] * torch.exp(state[0])
        payoff = _relu(s_t - k) if is_call else _relu(k - s_t)
        return torch.exp(-p[5] * grid.T) * payoff

    return init, step, final


class HestonGreeks(TypedDict):
    price: float
    delta: float
    vega_v0: float
    vega_kappa: float
    vega_theta: float
    vega_xi: float
    rho_rate: float
    se: dict[str, float]
    n_paths: int
    n_steps: int


def heston_greeks(n_paths: int, s0: float, k: float, r: float, T: float, *, v0: float,
                  kappa: float, theta: float, xi: float, rho: float, kind: str = "call",
                  n_steps: int = 364, seed: int = 1234, scramble: str = "owen", indices=None,
                  dtype=torch.float32, device=None) -> HestonGreeks:
    """Price and pathwise sensitivities of a European option under Heston:
    ``delta``, ``vega_v0``, ``vega_kappa``, ``vega_theta``, ``vega_xi`` and
    ``rho_rate``, through the full-truncation Euler recurrence. The correlation
    ``rho`` stays fixed (its pathwise derivative needs the rotation's tangent).
    A flat dict with an iid-diagnostic ``se`` sub-dict."""
    _check_kind(kind)
    if not -1.0 <= rho <= 1.0:
        # (1 - rho^2) ** 0.5 of a Python float turns complex past +-1
        raise ValueError(f"rho must be in [-1, 1], got {rho!r}")
    idx = _indices(n_paths, indices, device)
    grid = TimeGrid(T, n_steps)
    params = torch.tensor([s0, v0, kappa, theta, xi, r], dtype=dtype, device=idx.device)
    init, step, final = _heston_fns(grid, k, kind == "call", idx.shape[0], dtype, idx.device)
    rho_c = (1.0 - rho * rho) ** 0.5

    def correlated(state, p, z, dt):
        return step(state, p, (rho * z[:, 1] + rho_c * z[:, 0], z[:, 1]), dt)

    v, jac = _pathwise(init, correlated, final, params,
                       torch.eye(6, dtype=dtype, device=idx.device), idx, grid, 2, seed,
                       scramble, dtype)
    names = ("price", "delta", "vega_v0", "vega_kappa", "vega_theta", "vega_xi", "rho_rate")
    stats = {name: _mean_se(col) for name, col in zip(names, (v, *jac))}
    out = {name: m for name, (m, _) in stats.items()}
    out["se"] = {name: se for name, (_, se) in stats.items()}
    out["n_paths"] = v.shape[0]
    out["n_steps"] = n_steps
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Basket: per-asset delta and vega vectors through the correlated recurrence
# ---------------------------------------------------------------------------


def basket_greeks(n_paths: int, *, s0, weights, strike: float, r: float, sigma, corr,
                  T: float, n_steps: int = 52, seed: int = 1234, scramble: str = "owen",
                  indices=None, dtype=torch.float32, device=None) -> dict[str, object]:
    """Price, per-asset delta and vega vectors ``(A,)`` and rate rho of the
    basket call ``max(sum_i w_i S_T^i - K, 0)``, by pathwise AD through the
    correlated log-Euler recurrence of ``simulate_gbm_basket`` (the Cholesky
    factor, ``sde.basket_factor``, held fixed). Its oracles: Black-Scholes for
    one asset, CRN bump-reprice differences in general."""
    idx = _indices(n_paths, indices, device)
    dev = idx.device
    grid = TimeGrid(T, n_steps)
    s0 = torch.as_tensor(s0, dtype=dtype).to(dev)
    n_assets = s0.shape[0]
    sigma = torch.as_tensor(sigma, dtype=dtype).to(dev)
    w = torch.as_tensor(weights, dtype=dtype).to(dev)
    chol_t = basket_factor(corr, dtype).T.to(dev)
    sdt = torch.sqrt(torch.tensor(grid.dt, dtype=dtype)).to(dev)
    n = idx.shape[0]
    # params: s0 (A), sigma (A), r; the tangents: e_i of each s0, of each sigma, r
    params = torch.cat([s0, sigma, torch.tensor([r], dtype=dtype, device=dev)])

    def init(p):
        return p.new_zeros((n, n_assets))

    def step(logs, p, zc, dt):
        sig, rate = p[n_assets:2 * n_assets], p[-1]
        c0 = (rate - 0.5 * sig * sig) * dt
        return logs + c0[None, :] + sig[None, :] * sdt * zc

    def final(acc, p):
        s_t = p[None, :n_assets] * torch.exp(acc)
        return torch.exp(-p[-1] * grid.T) * _relu(s_t @ w - strike)

    v, tang = _pathwise(init, lambda s, p, z, dt: step(s, p, z @ chol_t, dt), final, params,
                        torch.eye(2 * n_assets + 1, dtype=dtype, device=dev), idx, grid,
                        n_assets, seed, scramble, dtype)
    price, se_price = _mean_se(v)
    return {"price": price,
            "delta": torch.mean(tang[:n_assets], dim=1),               # (A,)
            "vega": torch.mean(tang[n_assets:2 * n_assets], dim=1),    # (A,)
            "rho_rate": float(torch.mean(tang[-1])), "se": {"price": se_price},
            "n_paths": v.shape[0], "n_steps": n_steps}
