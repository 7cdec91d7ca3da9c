#!/usr/bin/env python3
"""How far a 4,096-path f32 walk moves under one-ulp changes of its paths.

    python3 tools/torch_walk_spread.py [--walk heston | pension] [--trials 16]
                                       [--device cpu]

``--walk heston`` (the default) runs the port's ``heston_hedge`` (QE-M
paths, Gauss-Newton ``mse_only`` walk) from the stored JAX initial params of
``orp_tpu_torch/_data/heston_walk``; ``--walk pension`` runs the pension
dual walk (``shared`` + ``py``, GN 60/30 with the IRLS quantile leg, the
reference's multi-step grid, inversion thinning) from those of
``orp_tpu_torch/_data/pension_walk``. Each runs once as simulated and
``--trials - 1`` times with every stored knot of the risky price (``S`` or
the fund ``Y``) moved by -1, 0 or +1 ulp at random (a seeded generator per
trial), and prints each run's gaps to the stored JAX report, then the largest
gap of each over all runs as JSON: Heston the network ``v0`` (relative) and
the prices ``v0_cv`` / ``v0_acv`` (bp); the pension ``v0`` (relative) and
``phi0`` / ``psi0`` as shares of V0. The Levenberg-Marquardt accept/reject
branches on float compares, so such a change can flip a step and part the
trajectory: the spread is the band inside which two correct f32
implementations of the walk (the JAX package on two engines, or the port
against it) can land. It is a property of the algorithm at this size, not a
device metric.

The pension walk also depends on which device made its paths. The
reference's f32 CDF walk of the death count saturates: ``q = 1 - p``
cancels, the cdf can plateau below 1, and a uniform above the plateau takes
all 128 trips (a 128-death step). One ulp of ``exp(-lam dt)`` moves the
plateau, so the card's survivors part from the CPU's on about 38% of knots
at 4,096 x 1,000 and the walk fits another sample: with ``--device cuda``
the gaps to the stored report are a shift of the whole spread, not a wider
chaos.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _nudger(simulate, key: str, trial: int):
    """``simulate`` with ``out[key]`` moved by a seeded -1/0/+1 ulp (trial 0: unchanged)."""
    import torch

    gen = torch.Generator().manual_seed(trial)

    def nudged(*a, **kw):
        out = simulate(*a, **kw)
        if trial == 0:
            return out
        x = out[key]
        step = torch.randint(-1, 2, x.shape, generator=gen).to(x.device, x.dtype)
        return {**out, key: torch.nextafter(x, x + step)}

    return nudged


def heston_trial(pipelines, ref: dict, device: str) -> dict:
    import numpy as np

    from orp_tpu_torch import HESTON_WALK
    from orp_tpu_torch.api import HestonConfig, SimConfig, TrainConfig

    with np.load(HESTON_WALK / "init.npz") as z:
        init = {k: z[k] for k in z.files}
    rep = pipelines.heston_hedge(
        HestonConfig(), SimConfig(n_paths=4096, T=1.0, dt=1 / 364, rebalance_every=7,
                                  engine="pallas"),
        TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"),
        warm_start=(init, None), device=device).report
    return {"v0_rel": rep.v0 / ref["v0"] - 1,
            "v0_cv_bp": (rep.v0_cv - ref["v0_cv"]) / ref["v0_cv"] * 1e4,
            "v0_acv_bp": (rep.v0_acv - ref["v0_acv"]) / ref["v0_acv"] * 1e4}


def pension_config():
    """The fixture's configuration: ``seeds3_gn_cfg(1234)`` at 4,096 paths,
    the Pallas engine, inversion thinning."""
    from orp_tpu_torch.api import HedgeRunConfig, SimConfig, TrainConfig

    return HedgeRunConfig(
        sim=SimConfig(n_paths=4096, T=10.0, dt=0.01, rebalance_every=25, seed=1234,
                      engine="pallas", binomial_mode="inversion"),
        train=TrainConfig(dual_mode="shared", holdings_combine="py", optimizer="gauss_newton",
                          gn_iters_first=60, gn_iters_warm=30))


def pension_trial(pipelines, ref: dict, device: str) -> dict:
    import numpy as np
    import torch

    from orp_tpu_torch import PENSION_WALK
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import backward_induction

    with np.load(PENSION_WALK / "init.npz") as z:
        init = {k: z[k] for k in z.files}
    cfg = pension_config()
    inp = pipelines.pension_inputs(cfg, "spread", torch.device(device))
    res = backward_induction(HedgeMLP(n_features=3), inp.features, inp.y, inp.b, inp.terminal,
                             pipelines._backward_cfg(cfg.train), initial_params=(init, None))
    rep = pipelines._pension_result(cfg, inp, res, HedgeMLP(n_features=3), "sort").report
    return {"v0_rel": rep.v0 / ref["v0"] - 1, "phi0_of_v0": (rep.phi0 - ref["phi0"]) / ref["v0"],
            "psi0_of_v0": (rep.psi0 - ref["psi0"]) / ref["v0"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walk", choices=("heston", "pension"), default="heston")
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from orp_tpu_torch import HESTON_WALK, PENSION_WALK
    from orp_tpu_torch.api import pipelines

    heston = args.walk == "heston"
    ref = json.loads(((HESTON_WALK if heston else PENSION_WALK) / "reference.json").read_text())
    name, key = (("_simulate_heston_paths", "S") if heston
                 else ("_simulate_pension_paths", "Y"))
    simulate = getattr(pipelines, name)
    gaps = {}
    try:
        for trial in range(args.trials):
            setattr(pipelines, name, _nudger(simulate, key, trial))
            row = (heston_trial if heston else pension_trial)(pipelines, ref, args.device)
            for k, v in row.items():
                gaps.setdefault(k, []).append(abs(v))
            print(json.dumps({"trial": trial, **row}), flush=True)
    finally:
        setattr(pipelines, name, simulate)
    print(json.dumps({"walk": args.walk, "trials": args.trials, "device": args.device,
                      "max_abs": {k: max(v) for k, v in gaps.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
