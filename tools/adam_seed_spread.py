#!/usr/bin/env python3
"""The Euro flagship's network V0 over the Adam walk's seeds, in one package.

    python3 tools/adam_seed_spread.py --package jax|torch [--seeds 1-24]
                                      [--device cpu]

Runs ``european_hedge`` at the reference's Euro flagship configuration
(``tools/parity_runs.py`` ``euro_flagship_cfg``: 4,096 paths, 52 weekly
dates, ``TrainConfig(dual_mode="mse_only")``, Adam 500/100) with the paths
of seed 1234 (``seed=1234``, ``seed_fund=1235``) and the walk's seed
(``TrainConfig.seed``: its initial params and its epoch orders) set to each
of ``--seeds``, and prints one JSON line a seed (V0, phi0, psi0, the
OLS-martingale price) and a last line with the V0 mean, standard deviation,
range, and the share of seeds outside ``test_golden_euro_flagship_hedge``'s
6% band around the reference's 11.352.

``--package jax`` runs the JAX package (imported alone, under
``JAX_PLATFORMS=cpu``), ``--package torch`` the port (``--device``, the CPU
by default); one process never imports both. The spread is a property of the
estimator: the network's V0 moves with the walk's random stream, and the
reference's 11.352 is one draw of it.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_V0, BAND = 11.352, 0.06


def seeds_arg(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("1-24"))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.package == "jax":
        from orp_tpu import api
        kw = {}
    else:
        from orp_tpu_torch import api
        kw = {"device": args.device}
    v0s = []
    for seed in args.seeds:
        res = api.european_hedge(
            api.EuropeanConfig(),
            api.SimConfig(n_paths=4096, T=1.0, dt=1 / 364, rebalance_every=7, seed=1234,
                          seed_fund=1235),
            api.TrainConfig(dual_mode="mse_only", seed=seed), **kw)
        v0s.append(float(res.report.v0))
        print(json.dumps({"package": args.package, "walk_seed": seed, "v0": v0s[-1],
                          "phi0": float(res.report.phi0), "psi0": float(res.report.psi0),
                          "v0_acv": float(res.report.v0_acv)}), flush=True)
    n = len(v0s)
    mean = sum(v0s) / n
    sd = math.sqrt(sum((v - mean) ** 2 for v in v0s) / max(n - 1, 1))
    print(json.dumps({"package": args.package, "seeds": n, "v0_mean": mean, "v0_sd": sd,
                      "v0_min": min(v0s), "v0_max": max(v0s),
                      "outside_6pct_of_11.352": sum(abs(v / REF_V0 - 1) > BAND for v in v0s)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
