"""What each configuration family hands the walk: paths, features, prices,
the terminal value, the starting output bias, and the date outputs.

- ``european``: one feature ``S_t / S0``; prices ``(S_t / S0, B_t / S0)``
  with ``B_t = e^{r t}``; terminal ``max(S_T - K, 0) / S0``; starting holdings
  ``(E[payoff] / S0, 0)``; one leg (``mse_only``): ``V_t`` is the fitted value.
- ``pension``: features ``(Y_t, N_t / N0, lam_t)``; prices ``(Y_t, B_t)``;
  terminal ``max(Y_T, K) N_T / N0``; starting holdings ``(1 - p, p)`` with ``p =
  P(Y_T < Y0)``; two legs sharing their weights (``shared``): the quantile
  fit continues from the MSE fit, ``V_t = g + c (h - g)`` with ``g`` the MSE
  fit's value and ``h`` the quantile fit's, the holdings the quantile fit's
  (``py``: the reference's combine).
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import mlp, paths


@dataclasses.dataclass
class Inputs:
    feats: torch.Tensor      # (n, K, f)
    prices: torch.Tensor     # (n, K, 2)
    terminal: torch.Tensor   # (n,)
    bias: tuple[float, float]
    knots: dict              # the raw knots


def bond(cfg: dict, device) -> torch.Tensor:
    k = cfg["n_steps"] // cfg["rebalance_every"] + 1
    times = torch.linspace(0.0, cfg["T"], k, dtype=torch.float32, device=device)
    return torch.exp(torch.tensor(cfg["r"], dtype=torch.float32, device=device) * times)


def knots(cfg: dict, idx: torch.Tensor, seeds: torch.Tensor) -> dict:
    dt = cfg["T"] / cfg["n_steps"]
    common = dict(n_steps=cfg["n_steps"], store_every=cfg["rebalance_every"], dt=dt)
    if cfg["family"] == "european":
        return {"S": paths.gbm_knots(idx, seeds, s0=cfg["s0"], drift=cfg["r"],
                                     sigma=cfg["sigma"], **common)}
    return paths.pension_knots(idx, seeds, y0=cfg["y0"], mu=cfg["mu"], sigma=cfg["sigma"],
                               l0=cfg["l0"], mort_c=cfg["mort_c"], eta=cfg["eta"],
                               n0=float(cfg["n0"]), **common)


def inputs(cfg: dict, kn: dict) -> Inputs:
    if cfg["family"] == "european":
        s, s0 = kn["S"], cfg["s0"]
        b = bond(cfg, s.device) / s0
        payoff = torch.clamp(s[:, -1] - cfg["strike"], min=0.0)
        return Inputs(feats=(s / s0)[:, :, None],
                      prices=torch.stack([s / s0, b[None, :].expand(s.shape)], dim=-1),
                      terminal=payoff / s0, bias=(float(torch.mean(payoff)) / s0, 0.0),
                      knots=kn)
    y, lam, pop = kn["Y"], kn["lam"], kn["N"]
    pop_n = pop / torch.tensor(float(cfg["n0"]), dtype=pop.dtype, device=pop.device)
    otm = float(torch.mean((y[:, -1] < cfg["y0"]).to(y.dtype)))
    return Inputs(feats=torch.stack([y, pop_n, lam], dim=-1),
                  prices=torch.stack([y, bond(cfg, y.device)[None, :].expand(y.shape)], dim=-1),
                  terminal=torch.clamp(y[:, -1], min=cfg["guarantee"]) * pop_n[:, -1],
                  bias=(1.0 - otm, otm), knots=kn)


def adjustment(cfg: dict) -> tuple[float, float]:
    """``(value scale, holdings scale)`` of the report."""
    if cfg["family"] == "european":
        return cfg["s0"], 1.0
    a = float(cfg["n0"]) * cfg["premium"]
    return a, a


def date_params(by_date: dict, t: int) -> dict:
    return {k: v[t] for k, v in by_date.items()}


def replay(cfg: dict, by_date: dict, inp: Inputs):
    """The ledgers of per-date params on ``inp``'s rows, each date a direct
    prediction: ``(values (n, K), phi (n, D), psi (n, D), var (n, D))``, the
    residual at ``t`` measured against the next date's value. Under
    ``shared`` the MSE value ``g`` is the stored params' own, as a replay of a
    policy has only those."""
    c = torch.tensor(cfg["train"]["cost_of_capital"], dtype=torch.float32)
    shared = cfg["train"]["dual_mode"] == "shared"
    n_dates = inp.feats.shape[1] - 1
    vals, combs = [], []
    for t in range(n_dates):
        p = date_params(by_date, t)
        x, pr = inp.feats[:, t], inp.prices[:, t]
        v = mlp.value(p, x, pr)
        if shared:
            v = v + c * (mlp.value(p, x, pr) - v)
        vals.append(v)
        combs.append(mlp.holdings(p, x))
    values = torch.stack(vals + [inp.terminal], dim=1)
    comb = torch.stack(combs, dim=1)
    var = values[:, 1:] - torch.sum(comb * inp.prices[:, 1:], dim=-1)
    return values, comb[..., 0], comb[..., 1], var
