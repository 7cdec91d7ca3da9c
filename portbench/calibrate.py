"""The readings the limits of ``correct`` are set from, at a cell's own size,
in one process (the set-up is paid once):

- the program on ``--seeds`` seeds, each as a run would check it: ``--jobs``
  jobs on the scramble seeds of ``(seed, i)``, their kept rows, and for a
  training cell the last job in full;
- the control on ``--controls`` seeds: the plain reference put in the
  program's place, computing in TF32 (the precision below the configuration's
  f32 with TF32 off);
- for a training cell, the faults a training step can have, planted in the
  reference put in the program's place: ``half`` (each fit on half the rows,
  the means over that half) and ``frozen`` (each fit returns its start);
- ``altered``, planted in the program on ``--controls`` seeds: path 0's knots
  moved by 5% where the path kernel writes them (``--altered 1``).

    python3 portbench/calibrate.py --workload <cell> --seed <first> [--seeds 12]
        [--controls 3] [--jobs 1] [--faults half,frozen] [--altered 0|1] [--out FILE]

One JSON line per reading, on standard output and appended to ``--out``. Runs
on the card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def _reference_record(cell, seed: int, rows, policy, device, fault=None) -> dict:
    """A kept record of the reference in the program's place (module docstring)."""
    import torch

    from portbench import check
    from portbench.reference import families, ols
    from portbench.reference import walk as ref_walk

    cfg, traffic = cell.cfg, cell.traffic
    if traffic["job"] == "revalue":
        idx = rows.to(device)
        inp = families.inputs(cfg, families.knots(
            cfg, idx, torch.full_like(idx, seed)))
        if fault is None:
            check.tf32()
        values, phi, psi, var = families.replay(
            cfg, {k: v.to(device) for k, v in policy.items()}, inp)
        adj, hadj = families.adjustment(cfg)
        rec = {"seed": seed, "rows": {"values": values, "phi": phi, "psi": psi, "var": var},
               "report": {"v0": float(torch.mean(values[:, 0])) * adj,
                          "phi0": float(torch.mean(phi[:, 0])) * hadj,
                          "psi0": float(torch.mean(psi[:, 0])) * hadj}}
        check.full_f32()
        return rec
    inp = check.full_inputs(cfg, traffic["n_paths"], seed, device)
    if fault is None:
        check.tf32()
    out = ref_walk.walk(cfg, inp, fault)
    rd = rows.to(device)
    rec = {"seed": seed,
           "rows": {k: out[k].index_select(0, rd) for k in ("values", "phi", "psi", "var")},
           "report": {k: out[k] for k in ("v0", "phi0", "psi0")},
           "params": out["params"], "full": {"values": out["values"]}}
    if cfg["family"] == "european":
        rec["full"]["knots"] = inp.knots
        s = inp.knots["S"]
        times = torch.linspace(0.0, cfg["T"], s.shape[1], dtype=torch.float32).numpy()
        rec["report"]["v0_acv"] = ols.martingale_ols_price(
            s, torch.clamp(s[:, -1] - cfg["strike"], min=0.0), cfg["r"], times,
            strike_over_s0=cfg["strike"] / cfg["s0"], phi=out["phi"])
    check.full_f32()
    return rec


def _alter_knots():
    """Plant ``altered`` in the program; returns the undo."""
    from orp_tpu_torch.api import pipelines

    kernels = {n: getattr(pipelines, n) for n in ("gbm_log_fused", "pension_fused")}

    def bump(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            for t in out.values() if isinstance(out, dict) else (out,):
                t[0] = t[0] * 1.05
            return out
        return wrapped

    for n, fn in kernels.items():
        setattr(pipelines, n, bump(fn))
    return lambda: [setattr(pipelines, n, fn) for n, fn in kernels.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--faults", default="half,frozen")
    ap.add_argument("--altered", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", type=int, default=None, help="a smaller cell, for a rehearsal")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if pathlib.Path(p or ".").resolve() != BENCH]
    from portbench.run import pin_caches

    pin_caches()
    import torch

    from portbench import check, harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    small = {} if args.paths is None else {"n_paths": args.paths, "sample_rows": 64}
    cell = harness.Cell(bench, args.workload, small)
    entry = harness.load_module(cell.entry)
    job = entry.Job(cell.cfg, cell.traffic, args.device)
    avoid = set(job.avoid_seeds)
    policy = job.reference_policy()
    out = open(args.out, "a") if args.out else None

    def emit(who: str, seed: int, numbers: dict, wall: float) -> None:
        line = json.dumps({"cell": args.workload, "who": who, "seed": seed, **numbers,
                           "check_s": wall, "detail": check.DETAIL})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    job.run(harness.job_seed(args.seed, 0, avoid))
    runs = [("program", args.seed + k) for k in range(args.seeds)]
    runs += [("altered", args.seed + 2000 + k) for k in range(args.controls * args.altered)]
    for who, seed in runs:
        undo = _alter_knots() if who == "altered" else (lambda: None)
        rows = harness.sample_rows(seed, cell.traffic["n_paths"], cell.traffic["sample_rows"])
        kept, last = [], None
        for i in range(1, args.jobs + 1):
            s = harness.job_seed(seed, i, avoid)
            res = job.run(s)
            kept.append(job.keep(res, s, rows.to(args.device)))
            last = res
        if job.train:
            kept[-1]["full"] = job.full(last)
        last = res = None
        t = time.perf_counter()
        undo()
        numbers, _ = check.readings(cell.cfg, cell.traffic, kept, rows, policy, args.device)
        emit(who, seed, numbers, time.perf_counter() - t)
    torch.cuda.empty_cache() if args.device == "cuda" else None
    plans = [("control", None)] * args.controls
    if job.train:
        plans += [(f, f) for f in args.faults.split(",") if f] * args.controls
    for n, (who, fault) in enumerate(plans):
        seed = args.seed + 1000 + n
        rows = harness.sample_rows(seed, cell.traffic["n_paths"], cell.traffic["sample_rows"])
        kept = [_reference_record(cell, harness.job_seed(seed, i, avoid), rows, policy,
                                  args.device, fault)
                for i in range(1, args.jobs + 1)]
        t = time.perf_counter()
        numbers, _ = check.readings(cell.cfg, cell.traffic, kept, rows, policy, args.device)
        emit(who, seed, numbers, time.perf_counter() - t)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
