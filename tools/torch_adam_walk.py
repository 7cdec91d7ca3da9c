#!/usr/bin/env python3
"""The Adam walk's step time and launches on the card, each epoch captured as
a CUDA graph (the port's default) and launched op by op.

    python3 tools/torch_adam_walk.py [--device cuda] [--paths 1048576]
                                     [--epochs 20] [--walk]

The fit is the north star's Adam configuration (``benchmarks/north_star.py``:
``batch_size = n_paths // 64``, ``shuffle="blocks"``, ``lr=1e-3``) on the
regression of its last date (features ``S/S0``, prices ``(S, B)`` at the
next knot, target the normalised payoff) from K1's paths. For each mode it
prints one JSON line: the fit's host wall (synchronised) over ``--epochs``
epochs, the ms per Adam step, and from ``torch.profiler`` the host launch
calls per step (``cudaLaunchKernel``, ``cudaGraphLaunch``, copies) and the
device kernels per step. ``--walk`` adds the whole north-star Adam walk
(``european_hedge`` at ``--paths``, ``TrainConfig(dual_mode="mse_only",
epochs_first=120, epochs_warm=30, batch_size=paths // 64, lr=1e-3,
shuffle="blocks")``) in each mode: its wall, Adam steps and epochs, and its
|v0_acv - BS| in bp. The last line is the card's name and power limit.

``--device cpu`` runs the op-by-op epoch alone (CPU ops, no kernels), for
the CPU test of this script; its times are not device numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
              "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def regression(n_paths: int, device):
    """The north star's last-date regression from K1's paths (the plain version on the CPU)."""
    import torch

    from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused
    from orp_tpu_torch.utils import full_f32

    full_f32()
    s = gbm_log_fused(n_paths, 364, s0=100.0, drift=0.08, sigma=0.15, dt=1 / 364, seed=1235,
                      store_every=7, device=device) / 100.0
    b = torch.exp(0.08 * torch.tensor([51 / 52, 1.0], device=device)) / 100.0
    prices = torch.stack([s[:, -1], b[1].expand(n_paths)], dim=-1)
    return s[:, -2:-1].contiguous(), prices, torch.clamp(s[:, -1] - 1.0, min=0.0)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def fit_once(model, params, data, cfg, seed: int = 1):
    import torch

    from orp_tpu_torch.train import fit, losses

    return fit.fit_core(model, params, *data, torch.Generator().manual_seed(seed),
                        loss_fn=losses.mse, cfg=cfg)


def measure(device, n_paths: int, epochs: int, graphs: bool) -> dict:
    """One mode: the fit's wall and ms per step, then its launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import fit

    fit.CUDA_GRAPHS = graphs
    data = regression(n_paths, device)
    model = HedgeMLP(n_features=1)
    params = {k: v.to(device) for k, v in
              model.init(torch.Generator().manual_seed(3), bias_init=(0.1, 0.0)).items()}
    bs = max(n_paths // 64, 1)
    cfg = fit.FitConfig(n_epochs=epochs, batch_size=bs, patience=epochs, shuffle="blocks",
                        lr=1e-3)
    fit_once(model, params, data, cfg)  # build, warm up, capture
    sync(device)
    t0 = time.perf_counter()
    _, aux = fit_once(model, params, data, cfg)
    sync(device)
    wall = time.perf_counter() - t0
    steps = int(aux["n_epochs_ran"]) * max(n_paths // bs, 1)
    short = dataclasses.replace(cfg, n_epochs=2)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _, aux2 = fit_once(model, params, data, short)
        sync(device)
    prof_steps = int(aux2["n_epochs_ran"]) * max(n_paths // bs, 1)
    host = {}
    for e in prof.key_averages():
        if e.key in HOST_CALLS:
            host[e.key] = host.get(e.key, 0) + e.count
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"mode": "graph" if graphs else "eager", "device": str(device), "paths": n_paths,
            "batch_size": bs, "epochs": int(aux["n_epochs_ran"]), "steps": steps,
            "wall_s": wall, "ms_per_step": wall / steps * 1e3,
            "host_calls_per_step": {k: v / prof_steps for k, v in host.items()},
            "kernels_per_step": kernels / prof_steps}


def walk(device, n_paths: int, graphs: bool) -> dict:
    """The north-star Adam walk (``european_hedge``) in one mode."""
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.train import fit
    from orp_tpu_torch.utils import bs_call

    fit.CUDA_GRAPHS = graphs
    bs = max(n_paths // 64, 1)
    train = TrainConfig(dual_mode="mse_only", epochs_first=120, epochs_warm=30, batch_size=bs,
                        lr=1e-3, shuffle="blocks")
    sync(device)
    t0 = time.perf_counter()
    res = european_hedge(EuropeanConfig(constrain_self_financing=False),
                         SimConfig(n_paths=n_paths, T=1.0, dt=1 / 364, rebalance_every=7,
                                   engine="pallas"), train, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    price, _ = bs_call(100.0, 100.0, 0.08, 0.15, 1.0)
    eps = res.backward.epochs_ran
    return {"mode": "graph" if graphs else "eager", "walk_wall_s": wall,
            "adam_steps": int(eps.sum()) * (n_paths // bs), "epochs_first": int(eps[-1]),
            "epochs_warm_min_median_max": [int(eps[:-1].min()), float(sorted(eps[:-1])[25]),
                                           int(eps[:-1].max())],
            "bp_err": (res.report.v0_acv - price) / price * 1e4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", type=int, default=1 << 20)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--walk", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_adam_walk: no CUDA device", file=sys.stderr)
        return 2
    modes = (True, False) if device.type == "cuda" else (False,)
    for graphs in modes:
        print(json.dumps(measure(device, args.paths, args.epochs, graphs)), flush=True)
    if args.walk:
        for graphs in modes:
            print(json.dumps(walk(device, args.paths, graphs)), flush=True)
    if device.type == "cuda":
        print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
