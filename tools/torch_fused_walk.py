#!/usr/bin/env python3
"""The north star's Gauss-Newton walk at the benchmark's configuration, host loop
against fused, in turns, on one card.

    python3 tools/torch_fused_walk.py [--device cuda] [--paths 1048576] [--turns 2]
                                      [--iters-first 150] [--iters-warm 75]
                                      [--block 16384] [--profile-iters 75]

The walk is ``backward_induction`` on the north star's inputs (K1's paths,
1,048,576 x 364 steps stored every 7: 52 dates, ``HedgeMLP(n_features=1)``,
``mse_only``) with ``gn_iters_first=150``, ``gn_iters_warm=75`` and
``gn_block_rows=16384`` (``benchmarks/north_star.py``), run host loop, fused,
fused, host loop for each turn. Each run prints one JSON line: its wall
(synchronised), ms per LM iteration (wall over 150 + 51 x 75), the accepted
iterations, the synchronizing CUDA calls of the walk
(``torch.cuda.set_sync_debug_mode("warn")``, one warning each; the fused walk's
date loop runs under ``"error"``, ``utils/measure.no_host_sync``), and whether
its ledgers and params equal the first run's bitwise.
Then one blocked LM iteration at the walk's shapes (``utils/measure.lm_census``):
op by op its ms, host launch calls and device kernels; as a CUDA graph its ms,
nodes and kernel nodes, capture and instantiate seconds. Then, from
``torch.profiler`` over a one-date walk of ``--profile-iters`` iterations in
each mode, the device's idle share between its first and last kernel and the
kernels it ran. The last line is the card's name and power limit.

``--device cpu`` runs the two walks alone at a small size (plain K1, no graph,
no census, no profile), for the CPU test of this script; its times are not
device numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def inputs(n_paths: int, device):
    """The north star's walk inputs from K1's paths (its plain version on the CPU)."""
    import torch

    from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused
    from orp_tpu_torch.utils import full_f32

    full_f32()
    s = gbm_log_fused(n_paths, 364, s0=100.0, drift=0.08, sigma=0.15, dt=1 / 364, seed=1235,
                      store_every=7, device=device) / 100.0
    b = torch.exp(0.08 * torch.linspace(0.0, 1.0, s.shape[1], device=device)) / 100.0
    return s[:, :, None], s, b, torch.clamp(s[:, -1] - 1.0, min=0.0)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def walk(model, data, cfg, device):
    """One walk: ``(result, wall, synchronizing calls or None on the CPU)``."""
    from orp_tpu_torch.train import backward_induction
    from orp_tpu_torch.utils.measure import count_syncs

    def run():
        sync(device)
        t0 = time.perf_counter()
        res = backward_induction(model, *data, cfg, bias_init=(float(data[3].mean()), 0.0))
        sync(device)
        return res, time.perf_counter() - t0

    if device.type != "cuda":
        return (*run(), None)
    (res, wall), syncs = count_syncs(run)
    return res, wall, syncs


def same(a, b) -> bool:
    import torch

    return (all(torch.equal(getattr(a, k), getattr(b, k))
                for k in ("values", "phi", "psi", "var_residuals"))
            and all(torch.equal(a.params1_by_date[k], v) for k, v in b.params1_by_date.items())
            and (a.epochs_ran == b.epochs_ran).all())


def idle_share(device_spans) -> float:
    """1 - (union of kernel intervals) / (first kernel start to last kernel end)."""
    spans = sorted(device_spans)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return 1.0 - busy / (spans[-1][1] - spans[0][0])


def profiled(model, data, cfg, device) -> dict:
    """A one-date walk (the last two knots) under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = (data[0][:, -2:], data[1][:, -2:], data[2][-2:], data[3])
    walk(model, one, cfg, device)  # warm: the fused walk's capture, the allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _ = walk(model, one, cfg, device)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_s": wall, "device_kernels": len(spans),
            "idle_share": idle_share(spans) if spans else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", type=int, default=1 << 20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--iters-first", type=int, default=150)
    ap.add_argument("--iters-warm", type=int, default=75)
    ap.add_argument("--block", type=int, default=1 << 14)
    ap.add_argument("--profile-iters", type=int, default=75)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import torch

    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import BackwardConfig, backward, gn
    from orp_tpu_torch.utils import measure

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_fused_walk: no CUDA device", file=sys.stderr)
        return 2
    backward.fused_loop_scope = measure.no_host_sync
    data = inputs(args.paths, device)
    model = HedgeMLP(n_features=1)
    host_cfg = BackwardConfig(dual_mode="mse_only", optimizer="gauss_newton",
                              gn_iters_first=args.iters_first, gn_iters_warm=args.iters_warm,
                              gn_block_rows=args.block)
    n_dates = data[1].shape[1] - 1
    iters = args.iters_first + (n_dates - 1) * args.iters_warm
    first = None
    for turn in range(args.turns):
        for fused in (False, True, True, False):
            cfg = dataclasses.replace(host_cfg, fused=fused)
            res, wall, syncs = walk(model, data, cfg, device)
            first = first or res
            print(json.dumps({
                "turn": turn, "mode": "fused" if fused else "host loop", "device": str(device),
                "paths": args.paths, "dates": n_dates, "lm_iterations": iters,
                "wall_s": wall, "ms_per_lm_iteration": wall / iters * 1e3,
                "accepted_iterations": int(res.epochs_ran.sum()), "synchronizing_calls": syncs,
                "bitwise_first_run": bool(same(res, first)),
                "v0": float(res.values[:, 0].mean())}), flush=True)
    if device.type != "cuda":
        print("census, profile and card: not measured (CPU run)")
        return 0
    t = n_dates - 1
    prices = torch.stack([data[1][:, t + 1], data[2][t + 1].expand(args.paths)], -1)
    prog = gn.gn_program(model, data[0][:, t], prices, data[3],
                         gn.GNConfig(n_iters=1, block_rows=args.block))
    prog.start(model.flatten({k: v[t] for k, v in first.params1_by_date.items()}))
    census = measure.lm_census(prog)
    census["nodes"], census["kernel_nodes"] = census.pop("nodes") or (None, None)
    print(json.dumps({"census": "one blocked LM iteration", "rows": args.paths,
                      "block_rows": args.block, **census}), flush=True)
    del prog
    one_cfg = dataclasses.replace(host_cfg, gn_iters_first=args.profile_iters)
    for fused in (False, True):
        print(json.dumps({"profile": "one date", "mode": "fused" if fused else "host loop",
                          "lm_iterations": args.profile_iters,
                          **profiled(model, data, dataclasses.replace(one_cfg, fused=fused),
                                     device)}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
