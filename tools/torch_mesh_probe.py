"""Two measurements behind the paths mesh's design, on one device.

    python3 tools/torch_mesh_probe.py [--device cuda] [--max-log2 20] [--steps 1000]
        [--paths 65536,1048576]

- ``engine``: the committed north-star policy's per-date forward on a bucket
  of ``b`` rows against the same rows evaluated as four quarter shards, for
  ``b = 2^3 .. 2^max_log2``, through the plain forward (``serve/engine
  ._eval_core``: one product of ``b`` rows) and the engine's row-tiled one
  (``_eval_tiled``): whether the quarters are bitwise the whole. On an H100
  cuBLAS picks another kernel for some shapes, which is why the engine tiles.
- ``exact``: ``simulate_pension`` with exact thinning (threefry-addressed) at
  each of ``paths`` x ``steps`` steps: the wall of each (synchronised host
  clock) and the law of N_T; then the first 4,096 paths of the last run again
  on the CPU and the share of N's knots equal to the device's.

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PENSION = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=1e4,
               store_every=25, binomial_mode="exact", seed=1234)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def engine_quarters(dev, max_log2: int) -> list[dict]:
    import numpy as np
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.serve import HedgeEngine, load_bundle
    from orp_tpu_torch.serve import engine as eng_mod

    eng = HedgeEngine(load_bundle(NORTH_STAR_POLICY), device=dev)
    kw = dict(dual_mode=eng.dual_mode, holdings_combine=eng.holdings_combine, precision="f32")
    rng = np.random.default_rng(1)
    rows = []
    for k in range(3, max_log2 + 1):
        b = 1 << k
        f = torch.as_tensor(rng.uniform(0.7, 1.3, (b, 1)).astype(np.float32), device=dev)
        p = torch.cat([f, torch.full_like(f, 0.97)], 1)
        out = {"rows": b}
        for name, fn in (("plain", eng_mod._eval_core), ("tiled", eng_mod._eval_tiled)):
            whole = fn(eng.model, eng._p1, eng._p2, 3, f, p, eng.cost_of_capital, **kw)
            q = b // 4
            parts = [fn(eng.model, eng._p1, eng._p2, 3, f[i * q:(i + 1) * q],
                        p[i * q:(i + 1) * q], eng.cost_of_capital, **kw) for i in range(4)]
            out[name] = all(torch.equal(w, torch.cat([pp[j] for pp in parts]))
                            for j, w in enumerate(whole))
        rows.append(out)
    return rows


def exact_walls(dev, steps: int, sizes) -> dict:
    import torch

    from orp_tpu_torch.sde import TimeGrid, simulate_pension

    grid = TimeGrid(10.0, steps)
    out = {"steps": steps}
    for n in sizes:
        _sync(dev)
        t0 = time.perf_counter()
        res = simulate_pension(torch.arange(n, device=dev), grid, **PENSION)
        _sync(dev)
        n_t = res["N"][:, -1].double()  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
        out[str(n)] = {"seconds": time.perf_counter() - t0, "mean_NT": float(n_t.mean()),
                       "sd_NT": float(n_t.std())}
    m = min(4096, sizes[-1])
    cpu = simulate_pension(torch.arange(m), grid, **PENSION)["N"]
    out[f"device_vs_cpu_equal_share_{m}"] = float((res["N"][:m].cpu() == cpu).double().mean())  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    return out


def main(argv=None) -> None:
    import torch

    from orp_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--max-log2", type=int, default=20)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--paths", default="65536,1048576")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with torch.no_grad():
        print(json.dumps({"engine_quarters": engine_quarters(dev, args.max_log2)}), flush=True)
        sizes = [int(x) for x in args.paths.split(",")]
        print(json.dumps({"exact": exact_walls(dev, args.steps, sizes)}), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())


if __name__ == "__main__":
    main()
