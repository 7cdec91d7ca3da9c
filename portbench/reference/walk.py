"""The backward hedge-training walk in plain PyTorch, standing alone: the
control of the training cells puts it in the program's place (computed in
TF32), and the training faults are planted in it.

From the last rebalance date down to the first, each date's network is fitted
to the next date's portfolio value with the features at ``t`` and the
prices at ``t + 1`` (``gn.fit``, the configured iterations; the first fitted
date from the initial params, the rest from the date after them). Under
``shared`` the quantile leg continues from the MSE fit, ``V_t = g + c (h -
g)`` and the holdings are the quantile fit's; under ``mse_only`` ``V_t`` is
the fitted value.
"""

from __future__ import annotations

import torch

from portbench.reference import families, gn, mlp


def walk(cfg: dict, inp: families.Inputs, fault: str | None = None) -> dict:
    """``{"params": {name: (D, ...)}, "values", "phi", "psi", "var", "v0", "phi0",
    "psi0"}`` over all of ``inp``'s rows."""
    tr = cfg["train"]
    shared = tr["dual_mode"] == "shared"
    c = torch.tensor(tr["cost_of_capital"], dtype=torch.float32)
    n, k = inp.feats.shape[:2]
    n_dates = k - 1
    dev = inp.feats.device
    values = torch.zeros((n, k), dtype=torch.float32, device=dev)
    values[:, -1] = inp.terminal
    params = {n_: v.to(dev) for n_, v in mlp.init(inp.feats.shape[2], tr["seed"], inp.bias,
                                                   cfg["model"]["init_scale"]).items()}
    by_date = {n_: torch.empty((n_dates, *v.shape), dtype=v.dtype, device=dev)
               for n_, v in params.items()}
    for step_i, t in enumerate(range(n_dates - 1, -1, -1)):
        x, pr, pr1 = inp.feats[:, t], inp.prices[:, t], inp.prices[:, t + 1]
        target = values[:, t + 1]
        n_iters = tr["gn_iters_first"] if step_i == 0 else tr["gn_iters_warm"]
        params = gn.fit(params, x, pr1, target, gn.leg(cfg, n_iters, "mse"), fault)
        v = mlp.value(params, x, pr)
        if shared:
            params = gn.fit(params, x, pr1, target, gn.leg(cfg, n_iters, "q"), fault)
            v = v + c * (mlp.value(params, x, pr) - v)
        values[:, t] = v
        for name, val in params.items():
            by_date[name][t] = val
    comb = torch.stack([mlp.holdings(families.date_params(by_date, t), inp.feats[:, t])
                        for t in range(n_dates)], dim=1)
    var = values[:, 1:] - torch.sum(comb * inp.prices[:, 1:], dim=-1)
    adj, hadj = families.adjustment(cfg)
    return {"params": by_date, "values": values, "phi": comb[..., 0], "psi": comb[..., 1],
            "var": var, "v0": float(torch.mean(values[:, 0])) * adj,
            "phi0": float(torch.mean(comb[:, 0, 0])) * hadj,
            "psi0": float(torch.mean(comb[:, 0, 1])) * hadj}
