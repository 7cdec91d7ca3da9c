"""Run the port's paths-mesh programs on N ranks, one process each.

``launch(world, jobs, out_dir)`` starts ``world`` children of this script
(``python tools/torch_mesh_ranks.py --rank R --world N ...``). They meet
through a ``FileStore`` under ``out_dir`` (no TCP port), form a
``torch.distributed`` group (``gloo`` by default, on the CPU or, with
``device="cuda"``, every rank on its card), run the jobs named in ``jobs`` and
each write their results, with the launch counts of every CUDA kernel's
wrapper, to ``out_dir/rank<R>.pt``. A rank that exits non-zero
ends the launch at once (the others are killed: they would wait on its
collectives), and so does the launch's hard timeout. The children import
``torch`` and the port only.

Jobs (keys of ``jobs``, run in this order on every rank):

- ``walks``: a list of ``european_hedge`` runs (``EuropeanConfig`` /
  ``SimConfig`` / ``TrainConfig`` fields, each ``repeat`` times) with
  ``mesh=make_mesh()``: the walls, the last run's prices and this rank's
  ledger block;
- ``engine``: a policy (the bundle at ``bundle``, else a small one trained
  without a mesh), then ``HedgeEngine(policy, mesh=)`` against
  ``HedgeEngine(policy)`` on seeded requests of each size: whether they are
  bitwise equal, the buckets, ``cache_info()``;
- ``guard``: a guarded walk with one rank's fit target NaN-poisoned at one date
  (``FaultPlan``): the rungs this rank took and the prices;
- ``kill``: a checkpointed walk killed after a step (``FaultPlan``);
- ``pension``: ``simulate_pension`` (exact thinning) on this rank's block;
- ``refusals``: the error texts of ``engine="pallas"`` with a mesh and (on a
  card over ``gloo``) of ``fused=True``;
- ``telemetry``: one ``european_hedge`` run on every rank, with a telemetry
  session (``obs.telemetry``, its bundle under ``out_dir/telemetry``) on the
  ranks listed in ``telemetry_ranks`` only: the bundle's manifest, its
  ``train/walk`` span and the mesh's ``describe()`` as this rank sees it;
- ``fail_rank``: that rank raises before the walks, while the others enter
  them (a launch must fail, not hang);
- ``sync_check``: the fused walks' date loops run under
  ``utils/measure.no_host_sync`` (a host sync there raises; on a card).

``chip_smoke.py`` [mesh] runs it on the card; ``tests/test_torch_mesh.py`` on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def launch(world: int, jobs: dict, out_dir, *, device: str = "cpu", backend: str = "gloo",
           timeout: float = 180.0) -> list[dict]:
    """Run ``jobs`` on ``world`` ranks and return each rank's results, in rank
    order. Raises (after killing every rank) when a rank fails or the launch
    outlives ``timeout`` seconds."""
    import torch

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "jobs.json").write_text(json.dumps(jobs))
    store = out / f"store-{time.monotonic_ns()}"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the ranks share the host's cores
    procs, logs = [], []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--rank", str(r),
             "--world", str(world), "--store", str(store), "--out", str(out),
             "--device", device, "--backend", backend],
            env=dict(env, LOCAL_RANK=str(r)), stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:  # a rank whose peer died may fail in the same poll: show each
                raise RuntimeError("\n".join(
                    f"rank {r} exited with {codes[r]}:\n" + _tail(out / f"rank{r}.log")
                    for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks outlived {timeout:.0f} s; rank 0's log:\n"
                                   + _tail(out / "rank0.log"))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _tail(path: pathlib.Path, n: int = 4000) -> str:
    return path.read_text()[-n:] if path.exists() else "(no log)"


# -- the rank side ------------------------------------------------------------


def _configs(spec: dict):
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig

    return (EuropeanConfig(**spec.get("euro", {})), SimConfig(**spec["sim"]),
            TrainConfig(**spec["train"]))


def _walk(spec: dict, mesh, device):
    from orp_tpu_torch.api import european_hedge

    import torch

    walls = []
    for _ in range(spec.get("repeat", 1)):  # the first run in a process is cold
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = european_hedge(*_configs(spec), mesh=mesh, device=device)
        if device is None:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    bw = res.backward
    return {"seconds": walls, "v0_cv": res.report.v0_cv,
            "v0_acv": res.report.v0_acv, "v0": res.v0,
            "v0_plain": res.report.v0_plain, "var_overall": res.report.var_overall,
            "values": bw.values.cpu(), "phi": bw.phi.cpu(), "epochs_ran": bw.epochs_ran}


def _engine(spec: dict, mesh, device):
    import numpy as np

    from orp_tpu_torch.api import european_hedge
    from orp_tpu_torch.serve import HedgeEngine, load_bundle

    policy = (load_bundle(spec["bundle"]) if "bundle" in spec
              else european_hedge(*_configs(spec), device=device))
    whole = HedgeEngine(policy, device=device)
    sharded = HedgeEngine(policy, mesh=mesh)
    rng = np.random.default_rng(spec.get("seed", 7))
    out = {"buckets": {}, "equal": {}, "rows": {}}
    for n in spec["sizes"]:
        t = int(rng.integers(0, whole.n_dates))
        states = rng.uniform(0.7, 1.3, (n, 1)).astype(np.float32)
        prices = np.column_stack([states[:, 0], np.full(n, 0.97)]).astype(np.float32)
        a = whole.evaluate(t, states, prices)
        b = sharded.evaluate(t, states, prices)
        out["equal"][n] = all(np.array_equal(x, y) for x, y in zip(a, b))
        out["buckets"][n] = sharded.bucket_for(n)
        out["rows"][n] = b[0].shape[0]
    out["cache_info"] = sharded.cache_info()
    try:
        sharded.evaluate_mixed_async(np.zeros(4, np.int32), np.ones((4, 1), np.float32))
        out["mixed_refusal"] = None
    except ValueError as e:
        out["mixed_refusal"] = str(e)
    return out


def _guard(spec: dict, mesh, device, rank: int):
    from orp_tpu_torch.api import european_hedge
    from orp_tpu_torch.guard import inject, sentinel

    rungs = []
    record = sentinel.record_degrade
    sentinel.record_degrade = lambda t, rung: (rungs.append((t, rung)), record(t, rung))
    try:
        plan = inject.FaultPlan(seed=spec.get("seed", 0), nan_dates=frozenset(spec["nan_dates"]),
                                nan_frac=spec.get("nan_frac", 0.05))
        if rank == spec["poison_rank"]:
            with inject.faults(plan):
                res = european_hedge(*_configs(spec), mesh=mesh, device=device)
        else:
            res = european_hedge(*_configs(spec), mesh=mesh, device=device)
    finally:
        sentinel.record_degrade = record
    return {"rungs": rungs, "v0_cv": res.report.v0_cv, "v0": res.v0}


def _kill(spec: dict, mesh, device):
    from orp_tpu_torch.api import european_hedge
    from orp_tpu_torch.guard import inject

    with inject.faults(inject.FaultPlan(kill_after_step=spec["kill_after_step"])):
        try:
            european_hedge(*_configs(spec), mesh=mesh, device=device)
        except inject.WalkKilled as e:
            return {"killed": str(e)}
    return {"killed": None}


def _pension(spec: dict, mesh, device):
    from orp_tpu_torch.parallel import path_indices
    from orp_tpu_torch.sde import TimeGrid, simulate_pension

    idx = path_indices(spec["n_paths"], mesh, device)
    t0 = time.perf_counter()
    out = simulate_pension(idx, TimeGrid(spec["T"], spec["n_steps"]), **spec["kw"])
    if idx.device.type == "cuda":
        import torch

        torch.cuda.synchronize(idx.device)
    return {"N": out["N"].cpu(), "first_index": int(idx[0]), "seconds": time.perf_counter() - t0}


def _refusals(spec: dict, mesh, device, backend: str):
    import dataclasses as dc

    from orp_tpu_torch.api import european_hedge

    euro, sim, train = _configs(spec)
    out = {}
    try:
        european_hedge(euro, dc.replace(sim, engine="pallas"), train, mesh=mesh, device=device)
        out["pallas"] = None
    except ValueError as e:
        out["pallas"] = str(e)
    if device != "cpu" and backend != "nccl":
        try:
            european_hedge(euro, sim, dc.replace(train, fused=True), mesh=mesh, device=device)
            out["fused"] = None
        except ValueError as e:
            out["fused"] = str(e)
    return out


def _telemetry(spec: dict, mesh, device, rank: int, out: pathlib.Path):
    from orp_tpu_torch import obs
    from orp_tpu_torch.api import european_hedge
    from orp_tpu_torch.parallel import MeshSpec

    if rank not in spec["telemetry_ranks"]:
        res = european_hedge(*_configs(spec), mesh=mesh, device=device)
        return {"v0_cv": res.report.v0_cv, "bundle": None}
    bundle = out / "telemetry"
    with obs.telemetry(bundle, flush_every_s=None):
        res = european_hedge(*_configs(spec), mesh=mesh, device=device)
    walk = [e for e in obs.read_events(bundle / obs.EVENTS_FILE)
            if e["type"] == "span" and e["name"] == "train/walk"]
    return {"v0_cv": res.report.v0_cv, "bundle": str(bundle),
            "manifest": obs.read_manifest(bundle), "walk": walk,
            "describe": MeshSpec(mesh.size()).describe(device)}


def _kernel_wrappers() -> dict:
    """Each CUDA kernel's wrapper and its launch counter: a rank reports what
    its jobs launched (the mesh path launches none)."""
    from orp_tpu_torch.qmc import fused_gbm, fused_mf
    from orp_tpu_torch.serve import megakernel

    return {"fused_gbm": (fused_gbm.gbm_log_fused, "launches"),
            "heston_qe": (fused_mf.heston_qe_fused, "launches"),
            "heston_euler": (fused_mf.heston_log_fused, "launches"),
            "pension": (fused_mf.pension_fused, "launches"),
            "mixed_head": (megakernel.mixed_head_forward, "launches"),
            "mixed_head_bf16": (megakernel.mixed_head_forward, "launches_bf16")}


def _rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from orp_tpu_torch.parallel import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    device = None if args.device == "cuda" else args.device
    address = f"file://{args.store}"
    if args.world > 1:
        initialize_multihost(coordinator_address=address, num_processes=args.world,
                             process_id=args.rank, backend=args.backend)
    else:
        dist.init_process_group(args.backend, init_method=address, world_size=1, rank=0)
    mesh = make_mesh(device=device)
    jobs = json.loads((pathlib.Path(args.out) / "jobs.json").read_text())
    res = {"rank": args.rank, "world": args.world, "mesh_size": mesh.size()}
    kernels = _kernel_wrappers()
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    if jobs.get("fail_rank") == args.rank:
        raise RuntimeError(f"rank {args.rank} fails on purpose")
    if jobs.get("sync_check"):
        from orp_tpu_torch.train import backward
        from orp_tpu_torch.utils import measure

        backward.fused_loop_scope = measure.no_host_sync
    for spec in jobs.get("walks", []):
        res.setdefault("walks", []).append(_walk(spec, mesh, device))
    if "engine" in jobs:
        res["engine"] = _engine(jobs["engine"], mesh, device)
    if "guard" in jobs:
        res["guard"] = _guard(jobs["guard"], mesh, device, args.rank)
    if "kill" in jobs:
        res["kill"] = _kill(jobs["kill"], mesh, device)
    if "pension" in jobs:
        res["pension"] = _pension(jobs["pension"], mesh, device)
    if "refusals" in jobs:
        res["refusals"] = _refusals(jobs["refusals"], mesh, device, args.backend)
    if "telemetry" in jobs:
        res["telemetry"] = _telemetry(jobs["telemetry"], mesh, device, args.rank,
                                      pathlib.Path(args.out))
    res["kernel_launches"] = {k: getattr(fn, attr, 0) for k, (fn, attr) in kernels.items()}
    torch.save(res, pathlib.Path(args.out) / f"rank{args.rank}.pt")
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    _rank_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
