#!/usr/bin/env python3
"""How far the 4,096-path Heston walk moves under one-ulp changes of its paths.

    python3 tools/torch_walk_spread.py [--trials 16] [--device cpu]

Runs the port's ``heston_hedge`` (QE-M paths, Gauss-Newton ``mse_only``
walk) from the stored JAX initial params of ``orp_tpu_torch/_data/heston_walk``
once as simulated and ``--trials - 1`` times with every stored knot of ``S``
moved by -1, 0 or +1 ulp at random (a seeded generator per trial), and prints
each run's network ``v0``, hedged-CV price ``v0_cv`` and OLS-martingale price
``v0_acv`` against the stored JAX report, then the largest gap of each over
all runs as JSON. The Levenberg-Marquardt accept/reject branches on float
compares, so such a change can flip a step and part the trajectory: the
spread is the band inside which two correct f32 implementations of the walk
(the JAX package on two engines, or the port against it) can land. It is a
property of the algorithm at this size, not a device metric.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from orp_tpu_torch import HESTON_WALK
    from orp_tpu_torch.api import HestonConfig, SimConfig, TrainConfig, pipelines

    ref = json.loads((HESTON_WALK / "reference.json").read_text())
    with np.load(HESTON_WALK / "init.npz") as z:
        init = {k: z[k] for k in z.files}
    simulate = pipelines._simulate_heston_paths
    gaps = {"v0_rel": [], "v0_cv_bp": [], "v0_acv_bp": []}
    try:
        for trial in range(args.trials):
            gen = torch.Generator().manual_seed(trial)

            def nudged(*a, _trial=trial, _gen=gen, **kw):
                out = simulate(*a, **kw)
                if _trial == 0:
                    return out
                s = out["S"]
                step = torch.randint(-1, 2, s.shape, generator=_gen).to(s.device, s.dtype)
                return {"S": torch.nextafter(s, s + step), "v": out["v"]}

            pipelines._simulate_heston_paths = nudged
            res = pipelines.heston_hedge(
                HestonConfig(), SimConfig(n_paths=4096, T=1.0, dt=1 / 364, rebalance_every=7,
                                          engine="pallas"),
                TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"),
                warm_start=(init, None), device=args.device)
            rep = res.report
            row = {"trial": trial, "v0_rel": rep.v0 / ref["v0"] - 1,
                   "v0_cv_bp": (rep.v0_cv - ref["v0_cv"]) / ref["v0_cv"] * 1e4,
                   "v0_acv_bp": (rep.v0_acv - ref["v0_acv"]) / ref["v0_acv"] * 1e4}
            for k in gaps:
                gaps[k].append(abs(row[k]))
            print(json.dumps(row), flush=True)
    finally:
        pipelines._simulate_heston_paths = simulate
    print(json.dumps({"trials": args.trials, "device": args.device,
                      "max_abs": {k: max(v) for k, v in gaps.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
