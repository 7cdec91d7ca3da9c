"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference under ``portbench/reference/``, which imports
nothing of the program.

Each window job leaves a record (``keep``): its scramble seed, the ledgers
(values, phi, psi, residuals) at rows drawn from the run's seed, its report's
prices and, for a training job, its per-date params; the window's last
training job also leaves its whole value ledger. After the window the
reference regenerates the paths of those rows from the seeds and computes:

- ``ledger_gap`` (simulation and outputs): the worst ``|program - reference|``
  over the kept rows, per ledger and date, over the reference column's rms.
  The reference evaluates the program's own per-date params (a training job)
  or the policy it loaded itself (a revaluation). Under the pension's shared
  legs the training values hold the MSE leg's value, whose params the
  program does not return: there only phi, psi, the terminal value and the
  last residual are compared, and ``gpre_gap`` covers the rest.
- ``ledger_rms`` (the same layers, steadier): the rms of ``program -
  reference`` over all kept rows and dates over the reference's rms, the
  worst ledger.
- ``price_gap`` (price): ``v0`` (and ``v0_acv`` of the European claim, over
  all rows of the last job) and ``phi0``, ``psi0``, against the reference's,
  over ``|v0|``.
- ``knot_gap`` (simulation, where the job keeps the knots its walk was
  fitted on: the call's training cell): the worst ``|program - reference|``
  over every row of the last job, per knot over the reference column's rms.
- ``fit_excess`` (walk, training cells): date by date from the program's own
  state (its next-date params as the warm start, its next-date values as the
  target, its knots where the job keeps them, else the reference's; the last
  date from the reference's own init and terminal value), the reference fits
  the date with the configured iterations over all rows.
  The number is the worst date's relative excess of the program's loss over
  the reference fit's, each evaluated by the reference over all rows: the
  MSE under ``mse_only``, the pinball loss of the quantile leg under
  ``shared``.
- ``gpre_gap`` (walk, the pension): the MSE leg's value the program's ledger
  implies, ``(V_t - c h_t) / (1 - c)``, against the reference MSE fit's, over
  its rms, the worst date.
"""

from __future__ import annotations

import torch

from portbench.reference import families, gn, mlp, ols


#: the last check's readings by ledger and date, for a look at what a number reads
DETAIL: dict = {}


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x.double() * x.double()))


def column_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst ``|prog - ref|`` over rows, per column over the column's rms."""
    d = (prog.double() - ref.double()).abs().amax(dim=0)
    scale = torch.sqrt(torch.mean(ref.double() ** 2, dim=0))
    floor = float(_rms(ref)) * 1e-6 + 1e-30
    return float((d / torch.clamp(scale, min=floor)).max())


def _row_knots(cfg: dict, kept: list[dict], rows: torch.Tensor, device) -> families.Inputs:
    """The reference's inputs at the kept rows of every job, in one pass."""
    idx = rows.to(device).repeat(len(kept))
    seeds = torch.cat([torch.full((rows.shape[0],), k["seed"], dtype=torch.int64)
                       for k in kept]).to(device)
    return families.inputs(cfg, families.knots(cfg, idx, seeds))


def _slice(inp: families.Inputs, j: int, r: int) -> families.Inputs:
    sl = slice(j * r, (j + 1) * r)
    return families.Inputs(feats=inp.feats[sl], prices=inp.prices[sl],
                           terminal=inp.terminal[sl], bias=inp.bias, knots={})


def ledger_gap(cfg: dict, kept: list[dict], rows: torch.Tensor, policy: dict | None,
               device) -> tuple[float, dict]:
    """``(gap, reference row inputs)``; a training job's own params, else ``policy``."""
    inp = _row_knots(cfg, kept, rows, device)
    shared_train = cfg["train"]["dual_mode"] == "shared" and policy is None
    worst = 0.0
    detail, sq = {}, {}
    for j, k in enumerate(kept):
        by_date = k["params"] if policy is None else policy
        by_date = {n: v.to(device) for n, v in by_date.items()}
        values, phi, psi, var = families.replay(cfg, by_date, _slice(inp, j, rows.shape[0]))
        got = {n: v.to(device) for n, v in k["rows"].items()}
        pairs = [(got["phi"], phi), (got["psi"], psi)]
        if shared_train:
            pairs += [(got["values"][:, -1:], values[:, -1:]), (got["var"][:, -1:], var[:, -1:])]
        else:
            pairs += [(got["values"], values), (got["var"], var)]
        for name, (a, b) in zip(("phi", "psi", "values", "var"), pairs):
            g = column_gap(a, b)
            detail[name] = max(detail.get(name, 0.0), g)
            worst = max(worst, g)
            d = sq.setdefault(name, [0.0, 0.0])
            d[0] += float(torch.sum((a.double() - b.double()) ** 2))
            d[1] += float(torch.sum(b.double() ** 2))
    DETAIL["ledger"] = detail
    DETAIL["ledger_rms"] = {k: (v[0] / v[1]) ** 0.5 if v[1] > 0 else 0.0 for k, v in sq.items()}
    return worst, inp


def revalue_price_gap(cfg: dict, k: dict, policy: dict, inp: families.Inputs) -> float:
    """The report's t=0 numbers against the policy at the first knot (every
    path starts there, so one row gives them)."""
    adj, hadj = families.adjustment(cfg)
    p0 = families.date_params({n: v.to(inp.feats.device) for n, v in policy.items()}, 0)
    x, pr = inp.feats[:1, 0], inp.prices[:1, 0]
    v0 = float(mlp.value(p0, x, pr)[0]) * adj
    h = mlp.holdings(p0, x)[0]
    rep = k["report"]
    return max(abs(rep["v0"] - v0), abs(rep["phi0"] - float(h[0]) * hadj),
               abs(rep["psi0"] - float(h[1]) * hadj)) / abs(v0)


def follow_walk(cfg: dict, inp: families.Inputs, by_date: dict, values: torch.Tensor) -> dict:
    """Walk the dates from the program's state (module docstring)."""
    tr = cfg["train"]
    shared = tr["dual_mode"] == "shared"
    c = torch.tensor(tr["cost_of_capital"], dtype=torch.float32)
    n_dates = inp.feats.shape[1] - 1
    excess, gpre = [], []
    out = {"g0": None}
    for step_i, t in enumerate(range(n_dates - 1, -1, -1)):
        x, pr, pr1 = inp.feats[:, t], inp.prices[:, t], inp.prices[:, t + 1]
        target = inp.terminal if step_i == 0 else values[:, t + 1]
        if step_i == 0:
            start = {n: v.to(x.device) for n, v in
                     mlp.init(x.shape[1], tr["seed"], inp.bias,
                              cfg["model"]["init_scale"]).items()}
        else:
            start = families.date_params(by_date, t + 1)
        n_iters = tr["gn_iters_first"] if step_i == 0 else tr["gn_iters_warm"]
        p_ref = gn.fit(start, x, pr1, target, gn.leg(cfg, n_iters, "mse"))
        prog = families.date_params(by_date, t)
        kind = "mse"
        if shared:
            g_ref = mlp.value(p_ref, x, pr)
            h = mlp.value(prog, x, pr)
            g_prog = (values[:, t] - c * h) / (1.0 - c)
            gpre.append(float(_rms(g_prog - g_ref) / _rms(g_ref)))
            if t == 0:
                out["g0"] = g_ref
            p_ref = gn.fit(p_ref, x, pr1, target, gn.leg(cfg, n_iters, "q"))
            kind = "pinball"
        q = tr["quantile"]
        l_ref = gn.loss_of(kind, q, mlp.value(p_ref, x, pr1), target)
        l_prog = gn.loss_of(kind, q, mlp.value(prog, x, pr1), target)
        excess.append(float((l_prog - l_ref) / l_ref))
    DETAIL["excess_by_step"] = excess
    DETAIL["gpre_by_step"] = gpre
    out["fit_excess"] = max(excess)
    if shared:
        out["gpre_gap"] = max(gpre)
    return out


def train_price_gap(cfg: dict, k: dict, inp: families.Inputs, by_date: dict, walk: dict) -> float:
    """The last job's report against the reference over all its rows: ``v0``,
    ``phi0``, ``psi0``; ``v0_acv`` for the European claim (its OLS regression on
    the hedge's phi). Under ``shared`` ``v0`` takes the reference MSE fit's
    value, as the program's MSE-leg params are not returned."""
    adj, hadj = families.adjustment(cfg)
    p0 = families.date_params(by_date, 0)
    x, pr = inp.feats[:, 0], inp.prices[:, 0]
    h = mlp.holdings(p0, x)
    val = mlp.value(p0, x, pr)
    rep = k["report"]
    if cfg["train"]["dual_mode"] == "shared":
        c = torch.tensor(cfg["train"]["cost_of_capital"], dtype=torch.float32)
        val = walk["g0"] + c * (val - walk["g0"])
    v0 = float(torch.mean(val)) * adj
    gaps = [abs(rep["v0"] - v0), abs(rep["phi0"] - float(torch.mean(h[:, 0])) * hadj),
            abs(rep["psi0"] - float(torch.mean(h[:, 1])) * hadj)]
    scale = abs(v0)
    if "v0_acv" in rep:
        s = inp.knots["S"]
        n_dates = inp.feats.shape[1] - 1
        phi = torch.stack([mlp.holdings(families.date_params(by_date, t), inp.feats[:, t])[:, 0]
                           for t in range(n_dates)], dim=1)
        times = torch.linspace(0.0, cfg["T"], n_dates + 1, dtype=torch.float32).numpy()
        acv = ols.martingale_ols_price(s, torch.clamp(s[:, -1] - cfg["strike"], min=0.0),
                                       cfg["r"], times, strike_over_s0=cfg["strike"] / cfg["s0"],
                                       phi=phi)
        gaps.append(abs(rep["v0_acv"] - acv))
        scale = abs(acv)
    return max(gaps) / scale


def full_inputs(cfg: dict, n_paths: int, seed: int, device) -> families.Inputs:
    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    seeds = torch.full((n_paths,), seed, dtype=torch.int64, device=device)
    return families.inputs(cfg, families.knots(cfg, idx, seeds))


def readings(cfg: dict, traffic: dict, kept: list[dict], rows: torch.Tensor,
             policy: dict | None, device) -> tuple[dict[str, float], dict]:
    """Every number the cell compares, by name, and what the cost model takes
    from the reference's paths (the pension's deaths a path)."""
    full_f32()
    gap, inp_rows = ledger_gap(cfg, kept, rows, policy, device)
    out = {"ledger_gap": gap, "ledger_rms": max(DETAIL["ledger_rms"].values())}
    extra = {}
    if "N" in inp_rows.knots:
        pop = inp_rows.knots["N"]
        extra["deaths_per_path"] = float(torch.mean(pop[:, 0] - pop[:, -1]))
    if traffic["job"] == "revalue":
        out["price_gap"] = max(revalue_price_gap(cfg, k, policy, _slice(inp_rows, j, rows.shape[0]))
                               for j, k in enumerate(kept))
        return out, extra
    del inp_rows
    last = kept[-1]
    inp = full_inputs(cfg, traffic["n_paths"], last["seed"], device)
    by_date = {n: v.to(device) for n, v in last["params"].items()}
    walk_inp = inp
    prog_knots = last["full"].get("knots")
    if prog_knots is not None:
        prog_knots = {k: v.to(device) for k, v in prog_knots.items()}
        out["knot_gap"] = max(column_gap(prog_knots[k], inp.knots[k]) for k in prog_knots)
        walk_inp = families.inputs(cfg, prog_knots)
    walk = follow_walk(cfg, walk_inp, by_date, last["full"]["values"].to(device))
    del walk_inp, prog_knots
    out["fit_excess"] = walk["fit_excess"]
    if "gpre_gap" in walk:
        out["gpre_gap"] = walk["gpre_gap"]
    out["price_gap"] = train_price_gap(cfg, last, inp, by_date, walk)
    return out, extra


def full_f32() -> None:
    """The reference's products in full f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32() -> None:
    """The control's precision: f32 products in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
