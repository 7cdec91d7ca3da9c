#!/usr/bin/env python3
"""Where the time goes on the port's served and trained paths, on one NVIDIA card.

    python3 tools/torch_profile_paths.py [--out build/profile_paths.json]

Runs each path once to warm up (kernel build, allocator), then once under
``torch.profiler`` (CPU + CUDA activities):

- ``serve``: one 1,048,576-row mixed-date block of the committed north-star
  policy through ``HedgeEngine.evaluate_mixed_async(...).result()``;
- ``replay``: ``european_oos`` at 1,048,576 fresh paths x 364 steps on the
  fused kernel;
- ``train``: ``heston_hedge`` at 1,048,576 paths x 364 steps (the QE-M
  kernel, the 52-date Gauss-Newton walk, the report);
- ``asian``: ``asian_call_qmc`` at 1,048,576 paths x 364 steps (the scan
  path, plain PyTorch: the option analytics launch no kernel of their own);
- ``lsm``: ``bermudan_lsm`` at 1,048,576 paths x 200 steps and its 49
  regressions (LS2001, 50 exercise dates).

For each path it prints the host wall, the summed device time of all GPU
activity, the device's idle share (1 - device time / wall) and the top
entries by device time and by host time. Then it times the mixed-date kernel
at 1,048,576 rows with every row at one date, with rows sorted by date and
with random dates. Everything is also written as JSON to ``--out``. Needs a
CUDA device; exits non-zero without one.
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


def _rows(events, key: str, n: int) -> list[dict]:
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"name": e.key[:80], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3,
             "host_ms": e.self_cpu_time_total / 1e3} for e in rows]


def profile(name: str, fn) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device activity (kernels, copies, memsets) only: an operator's device
    # time repeats the time of the kernels it launched
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    out = {"path": name, "wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "top_device": _rows(on_device, "self_device_time_total", 12),
           "top_host": _rows(on_host, "self_cpu_time_total", 12)}
    print(f"== {name}: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"idle share {out['device_idle_share']:.3f}")
    for label, rows in (("device", out["top_device"]), ("host", out["top_host"])):
        for r in rows:
            print(f"   [{label}] {r['device_ms']:10.3f} dev ms {r['host_ms']:10.3f} host ms "
                  f"x{r['calls']:<5d} {r['name']}")
    if device_ms == 0.0:
        print("   (the profiler recorded no device time; time with CUDA events instead)")
    return out


def k2_date_spread(policy, n: int) -> dict:
    """K2's time at ``n`` rows when a warp's rows share one date (all rows at
    date 0; rows sorted by date) vs random dates: the per-row weight gather
    conflicts on shared-memory banks only when a warp spans several dates."""
    import torch

    from orp_tpu_torch.serve import megakernel

    dev = torch.device("cuda")
    model = policy.model
    p1 = {k: v.to(dev) for k, v in policy.backward.params1_by_date.items()}
    packed = megakernel.pack_head_params(model, p1)
    g = torch.Generator(device=dev).manual_seed(3)
    feats = 1.0 + 0.1 * torch.randn(n, 1, device=dev, generator=g)
    rand = torch.randint(0, policy.n_dates, (n,), device=dev, generator=g, dtype=torch.int32)
    cases = {"one_date": torch.zeros(n, dtype=torch.int32, device=dev),
             "sorted_dates": torch.sort(rand).values.contiguous(), "random_dates": rand}
    out = {}
    for name, dates in cases.items():
        fn = lambda: megakernel.mixed_head_forward(model, p1, dates, feats, packed=packed)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(200):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 200)
        out[name] = sorted(times)[2]
        print(f"== K2 at {n} rows, {name}: {out[name]:.5f} ms (CUDA-event median of 5x200)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_paths.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.api import (EuropeanConfig, HestonConfig, SimConfig, TrainConfig,
                                   european_oos, heston_hedge)
    from orp_tpu_torch.risk import asian_call_qmc
    from orp_tpu_torch.serve import HedgeEngine, load_bundle
    from orp_tpu_torch.train import bermudan_lsm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__}")
    policy = load_bundle(NORTH_STAR_POLICY)
    engine = HedgeEngine(policy)
    n = 1 << 20
    rng = np.random.default_rng(11)
    dates = rng.integers(0, policy.n_dates, n).astype(np.int32)
    states = (1.0 + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    prices = np.concatenate([states, np.full((n, 1), 0.0108, np.float32)], 1)
    sim = SimConfig(n_paths=n, T=1.0, dt=1 / 364, rebalance_every=7, seed_fund=4321,
                    engine="pallas")
    results = [
        profile("serve", lambda: engine.evaluate_mixed_async(dates, states, prices).result()),
        profile("replay", lambda: european_oos(
            policy, EuropeanConfig(constrain_self_financing=False), sim,
            TrainConfig(dual_mode="mse_only"))),
        profile("train", lambda: heston_hedge(
            HestonConfig(), dataclasses.replace(sim, seed_fund=1235),
            TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"))),
        profile("asian", lambda: asian_call_qmc(n, 100.0, 100.0, 0.08, 0.15, 1.0)),
        profile("lsm", lambda: bermudan_lsm(n, 36.0, 40.0, 0.06, 0.2, 1.0, n_exercise=50,
                                            seed=9)),
    ]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    spread = k2_date_spread(policy, n)
    out.write_text(json.dumps({"card": card, "torch": torch.__version__,
                               "paths": results, "k2_date_spread_ms": spread}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
