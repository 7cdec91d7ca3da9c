#!/usr/bin/env python3
"""One fresh process of the AOT plane's checks on the card (``chip_smoke.py``
[aot] starts it with ``ORP_TORCH_CACHE_DIR`` pointed at the cache under test).
Prints one JSON object as its last line.

    python3 tools/torch_aot_child.py cold --bundle DIR
        an engine with no AOT set (``use_aot=False``), then its first requests:
        one mixed-date block (the lane that loads K2's library) and one
        bucketed request; the wall and the nvcc runs and seconds it cost.
    python3 tools/torch_aot_child.py serve --bundle DIR --tiers f32,bf16 --dates 0,25,51
        the same from the bundle's AOT set, then every shipped bucket at each
        date and tier against an eager engine (``use_aot=False``) in this
        process: the mismatching requests (none, bitwise), the AOT hits per
        tier, the nvcc runs (none).
    python3 tools/torch_aot_child.py walk --paths N
        the fused north star (K1 paths, GN 30 + 51 x 10, ``fused=True``) on a
        cache warmed by ``aot.warm_fused_walk``: the nvcc runs (none).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _first_requests(engine, np, torch) -> None:
    """One mixed-date block and one bucketed request, waited for."""
    rng = np.random.default_rng(0)
    rows = (1.0 + 0.1 * rng.standard_normal((8, engine.model.n_features))).astype(np.float32)
    dates = (np.arange(8) % engine.n_dates).astype(np.int32)
    engine.evaluate_mixed_async(dates, rows).result()
    engine.evaluate(0, rows)
    torch.cuda.synchronize()


def _stats(cuda_build) -> dict:
    return {k: cuda_build.BUILD_STATS[k] for k in ("nvcc", "nvcc_s", "loads", "captures")}


def cold(args, np, torch) -> dict:
    from orp_tpu_torch.serve import HedgeEngine, load_bundle
    from orp_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    engine = HedgeEngine(load_bundle(args.bundle), use_aot=False)
    _first_requests(engine, np, torch)
    return {"mode": "cold", "wall_s": time.perf_counter() - t0, **_stats(cuda_build),
            "cache_dir": str(cuda_build.build_dir())}


def serve(args, np, torch) -> dict:
    from orp_tpu_torch.serve import HedgeEngine, load_bundle
    from orp_tpu_torch.utils import cuda_build

    tiers = args.tiers.split(",")
    dates = [int(d) for d in args.dates.split(",")]
    t0 = time.perf_counter()
    policy = load_bundle(args.bundle)
    engines = {tiers[0]: HedgeEngine(policy, precision=tiers[0])}
    _first_requests(engines[tiers[0]], np, torch)
    wall = time.perf_counter() - t0
    first = _stats(cuda_build)
    for tier in tiers[1:]:
        engines[tier] = HedgeEngine(policy, precision=tier)
    out = {"mode": "serve", "wall_s": wall, "first": first, "tiers": {}}
    rng = np.random.default_rng(1)
    for tier, engine in engines.items():
        eager = HedgeEngine(policy, precision=tier, use_aot=False)
        info = engine.cache_info()
        hits0, requests, bad = info["aot_hits"], 0, []
        for b in info["aot_buckets"]:
            states = (1.0 + 0.1 * rng.standard_normal((b, 1))).astype(np.float32)
            prices = np.concatenate([states, np.full((b, 1), 0.0108, np.float32)], 1)
            for d in dates:
                got = engine.evaluate(d % engine.n_dates, states, prices)
                want = eager.evaluate(d % engine.n_dates, states, prices)
                requests += 1
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    bad.append([b, d])
        out["tiers"][tier] = {"aot_buckets": info["aot_buckets"], "requests": requests,
                              "aot_hits": engine.cache_info()["aot_hits"] - hits0,
                              "mismatches": bad}
    out.update(_stats(cuda_build))
    return out


def walk(args, np, torch) -> dict:
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    res = european_hedge(
        EuropeanConfig(constrain_self_financing=False),
        SimConfig(n_paths=args.paths, T=1.0, dt=1 / 364, rebalance_every=7, engine="pallas"),
        TrainConfig(dual_mode="mse_only", optimizer="gauss_newton", fused=True))
    torch.cuda.synchronize()
    return {"mode": "walk", "wall_s": time.perf_counter() - t0, "v0_acv": res.report.v0_acv,
            **_stats(cuda_build), "cache_dir": str(cuda_build.build_dir())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("cold", "serve", "walk"))
    ap.add_argument("--bundle")
    ap.add_argument("--tiers", default="f32,bf16")
    ap.add_argument("--dates", default="0,25,51")
    ap.add_argument("--paths", type=int, default=1 << 16)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_aot_child: needs a CUDA device", file=sys.stderr)
        return 2
    out = {"cold": cold, "serve": serve, "walk": walk}[args.mode](args, np, torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
