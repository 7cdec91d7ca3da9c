#!/usr/bin/env python3
"""The Heston pathwise greeks against their characteristic-function oracle,
across dtypes, seeds and Euler step counts.

    python3 tools/torch_heston_greeks.py [--device cuda] [--paths 1048576]
                                         [--runs float64:77:364 float32:77:364 ...]
                                         [--split float32:77:364]

Each run ``dtype:seed:steps`` is one ``risk.heston_greeks`` call on
``chip_smoke.py``'s Heston greeks case (``HESTON_GREEKS``: s0 = k = 100, r =
0.08, T = 1, v0 = theta = 0.0225, kappa 1.5, xi 0.25, rho -0.6). It prints one
JSON line: the wall (synchronised), and for each greek its estimate, its
oracle (``chip_smoke.heston_greeks_oracle``: the CF price and central
differences of it), the gap (relative or absolute, as the band is) and the
iid standard error. The default runs hold float64 and float32 at three seeds
and float64 at four step counts.

``--split dtype:seed:steps`` runs the per-path tangents once in float64 and
once in the given dtype on the same Sobol points, and splits the difference
of the two ``vega_xi`` means between the paths whose variance reached the
full-truncation floor (``v <= 0`` at some step) and the rest: where the low
precision's error comes from. The last line is the card's name and power
limit (on ``--device cpu``: ``cpu``; its times are not device numbers).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_RUNS = ("float64:77:364", "float32:77:364", "float64:78:364", "float32:78:364",
                "float64:1234:364", "float32:1234:364", "float64:77:91", "float64:77:182",
                "float64:77:728")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def parse_run(text: str):
    import torch

    dtype, seed, steps = text.split(":")
    return getattr(torch, dtype), int(seed), int(steps)


def run(n_paths: int, dtype, seed: int, steps: int, device, oracle: dict) -> dict:
    """One ``heston_greeks`` call and each greek's gap to the oracle."""
    import torch

    import chip_smoke
    from orp_tpu_torch.risk import heston_greeks

    t0 = time.perf_counter()
    g = heston_greeks(n_paths, 100.0, 100.0, 0.08, 1.0, **chip_smoke.HESTON_GREEKS,
                      n_steps=steps, seed=seed, dtype=dtype, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    greeks = {}
    for name, (want, how, lim) in oracle.items():
        gap = g[name] - want if how == "atol" else g[name] / want - 1
        greeks[name] = {"got": g[name], "oracle": float(want), how: float(gap), "band": lim,
                        "inside": bool(abs(gap) <= lim), "se": g["se"][name]}
    return {"dtype": str(dtype).removeprefix("torch."), "seed": seed, "steps": steps,
            "paths": n_paths, "wall_s": wall, "greeks": greeks}


def xi_tangents(n_paths: int, dtype, seed: int, steps: int, device):
    """Per path: the ``vega_xi`` tangent and whether the variance reached the
    floor, through ``heston_greeks``' own recurrence with the running minimum of
    ``v`` carried beside the state."""
    import torch

    import chip_smoke
    from orp_tpu_torch.risk import greeks
    from orp_tpu_torch.sde.grid import TimeGrid

    h = chip_smoke.HESTON_GREEKS
    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    grid = TimeGrid(1.0, steps)
    params = torch.tensor([100.0, h["v0"], h["kappa"], h["theta"], h["xi"], 0.08], dtype=dtype,
                          device=device)
    init, step, final = greeks._heston_fns(grid, 100.0, True, n_paths, dtype, idx.device)
    rho = h["rho"]
    rho_c = (1.0 - rho * rho) ** 0.5

    def init_min(p):
        logs, v = init(p)
        return logs, v, v

    def step_min(state, p, z, dt):
        logs, v = step(state[:2], p, (rho * z[:, 1] + rho_c * z[:, 0], z[:, 1]), dt)
        return logs, v, torch.minimum(state[2], v)

    def final_min(state, p):
        return torch.stack([final(state[:2], p), state[2]], dim=-1)

    out, tan = greeks._pathwise(init_min, step_min, final_min, params,
                                torch.eye(6, dtype=dtype, device=idx.device), idx, grid, 2,
                                seed, "owen", dtype)
    return tan[4][:, 0].double(), out[:, 1] <= 0.0  # orp: noqa[ORP001] -- the greek is compared in f64 across the precision arms


def split(n_paths: int, dtype, seed: int, steps: int, device) -> dict:
    """The low-precision ``vega_xi`` mean minus float64's, split by the floor."""
    import torch

    lo, floored_lo = xi_tangents(n_paths, dtype, seed, steps, device)
    hi, floored = xi_tangents(n_paths, torch.float64, seed, steps, device)  # orp: noqa[ORP001] -- the f64 arm of the f32-vs-f64 comparison this tool measures
    diff = lo - hi
    out = {"dtype": str(dtype).removeprefix("torch."), "seed": seed, "steps": steps,
           "paths": n_paths, "vega_xi": float(lo.mean()), "vega_xi_f64": float(hi.mean()),
           "gap": float(diff.mean()),
           "floored_share": float(floored.double().mean()),  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
           "floored_differ": int((floored != floored_lo).sum())}
    for name, mask in (("floored", floored), ("never_floored", ~floored)):
        d = torch.where(mask, diff, 0.0)
        out[f"gap_from_{name}"] = float(d.sum() / n_paths)
        out[f"max_abs_diff_{name}"] = float(d.abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", type=int, default=1 << 20)
    ap.add_argument("--runs", nargs="*", default=list(DEFAULT_RUNS))
    ap.add_argument("--split", nargs="*", default=["float32:77:364"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    oracle = chip_smoke.heston_greeks_oracle()
    for text in args.runs:
        print(json.dumps(run(args.paths, *parse_run(text), args.device, oracle)), flush=True)
    for text in args.split:
        print(json.dumps(split(args.paths, *parse_run(text), args.device)), flush=True)
    print(card_line() if args.device.startswith("cuda") else "cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
