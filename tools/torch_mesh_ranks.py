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
- ``aot``: the bundle at ``bundle`` (exported with a set for this world,
  ``aot/bundle_exec.export_aot(meshes=...)``) loaded into
  ``HedgeEngine(policy, mesh=)``: the ``nvcc`` runs, graph captures and
  capture fallbacks of the load, the buckets served by graphs, and each of
  ``sizes`` bitwise the unsharded eager engine and the eager mesh engine;
- ``degrade``: each of ``scenarios`` through ``DegradeManager(policy,
  mesh=world)`` on the bundle at ``bundle``: rank 0 (the front) streams
  ``requests`` single-row requests with a device loss at request ``loss_at``
  reporting ``survivors`` (``loss_budget`` losses, ``replay_timeout_s``) and
  ``block_rows``-row blocks before and after (``block_loss``: the loss under
  a block instead; ``sync``: each request answered before the next is sent;
  ``max_batch``, ``hard_wall_ms``: the batcher's), against its single-device
  eager engine, recording the
  served bits, ``stats()``, the ``guard/`` counters and events; every other
  rank records its part (follower or stood down), its rebuilds and the text
  of a ``submit`` there;
- ``stand_in`` (with ``aot`` / ``degrade`` on the CPU): a bucket's graph
  capture becomes an eager stand-in on the graph's static buffers (counted as
  a capture), since the CPU captures no CUDA graph;
- ``device_mesh_probe``: what this torch's ``DeviceMesh`` does on a rank
  outside its rank list (every rank builds one over ranks 0 and 1): its
  coordinate there, or the refusal's text;
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


class _EagerGraph:
    """A stand-in for a captured bucket graph on the CPU: its static buffers,
    and a replay that runs the engine's forward on them eagerly into fixed
    output buffers (a graph's replay overwrites its outputs the same way)."""

    def __init__(self, engine, rows: int):
        import torch

        dt = engine.model.dtype
        self.args = (torch.zeros((), dtype=torch.int64),
                     torch.zeros((rows, engine.model.n_features), dtype=dt),
                     torch.zeros((rows, engine.n_instruments), dtype=dt))
        self.engine = engine
        self.outputs = None

    def replay(self):
        import torch

        from orp_tpu_torch.serve.engine import _eval_tiled

        e = self.engine
        outs = _eval_tiled(e.model, e._p1, e._p2, *self.args, e.cost_of_capital,
                           dual_mode=e.dual_mode, holdings_combine=e.holdings_combine,
                           precision=e.precision.tier)
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(o) for o in outs)
        for buf, o in zip(self.outputs, outs):
            buf.copy_(o)
        return self.outputs


def _stand_in_captures(device) -> None:
    """Bucket graphs captured as :class:`_EagerGraph` (the CPU has no CUDA graph)."""
    from orp_tpu_torch.aot import bundle_exec
    from orp_tpu_torch.parallel.mesh import mesh_size
    from orp_tpu_torch.utils import cuda_build

    if device != "cpu":
        raise ValueError("stand_in is the CPU's: a card captures its graphs")

    def capture(cls, engine, bucket):
        cuda_build.count_capture(0.0, site="serve_bucket")
        return cls(bucket, _EagerGraph(engine, int(bucket) // mesh_size(engine.mesh)), {})

    bundle_exec.AotExecutable.capture = classmethod(capture)


def _requests(n: int, n_features: int, n_instruments: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 1.3, (n, n_features)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n, n_instruments)).astype(np.float32))


def _same(a, b) -> bool:
    import numpy as np

    return all((x is None and y is None) or np.array_equal(x, y) for x, y in zip(a, b))


def _aot(spec: dict, mesh, device):
    from orp_tpu_torch.aot import bundle_exec
    from orp_tpu_torch.parallel.mesh import topology_fingerprint
    from orp_tpu_torch.serve import HedgeEngine, load_bundle
    from orp_tpu_torch.utils import cuda_build

    t_job = time.perf_counter()
    policy = load_bundle(spec["bundle"])
    whole = HedgeEngine(policy, device=device, use_aot=False)
    eager = HedgeEngine(policy, mesh=mesh, use_aot=False)
    b0, f0 = dict(cuda_build.BUILD_STATS), dict(bundle_exec.FALLBACKS)
    t0 = time.perf_counter()
    sharded = HedgeEngine(policy, mesh=mesh)
    load_s = time.perf_counter() - t0
    out = {"topology": topology_fingerprint(mesh), "load_s": load_s,
           "nvcc": cuda_build.BUILD_STATS["nvcc"] - b0["nvcc"],
           "captures": cuda_build.BUILD_STATS["captures"] - b0["captures"],
           "fallbacks": {k: bundle_exec.FALLBACKS[k] - f0[k] for k in f0},
           "status": bundle_exec.aot_status(spec["bundle"], mesh=mesh,
                                            device=sharded.device)["detail"],
           "equal": {}, "equal_eager_mesh": {}, "buckets": {}}
    for i, n in enumerate(spec["sizes"]):
        states, prices = _requests(n, whole.model.n_features, whole.n_instruments,
                                   spec.get("seed", 7) + i)
        t = i % whole.n_dates
        got = sharded.evaluate(t, states, prices)
        out["equal"][n] = _same(got, whole.evaluate(t, states, prices))
        out["equal_eager_mesh"][n] = _same(got, eager.evaluate(t, states, prices))
        out["buckets"][n] = sharded.bucket_for(n)
    out["cache_info"] = sharded.cache_info()
    out["wall_s"] = time.perf_counter() - t_job
    return out


def _degrade(spec: dict, mesh, device, rank: int):
    from orp_tpu_torch.serve import load_bundle

    policy = load_bundle(spec["bundle"])
    return [_degrade_one(policy, sc, mesh.size(), device, rank) for sc in spec["scenarios"]]


def _degrade_one(policy, sc: dict, world: int, device, rank: int) -> dict:
    import numpy as np

    from orp_tpu_torch import guard, obs
    from orp_tpu_torch.guard import DegradeManager, FaultPlan, GuardPolicy
    from orp_tpu_torch.serve import HedgeEngine
    from orp_tpu_torch.utils import cuda_build

    kw = dict(mesh=world, engine_kwargs={"device": device},
              replay_timeout_s=sc.get("replay_timeout_s", 30.0),
              batcher_kwargs={"max_batch": sc.get("max_batch", 1024)},
              guard_policy=(GuardPolicy(hard_wall_ms=sc["hard_wall_ms"])
                            if "hard_wall_ms" in sc else None))
    b0 = dict(cuda_build.BUILD_STATS)
    if rank != 0:
        with DegradeManager(policy, **kw) as mgr:
            role = mgr.role
            try:
                mgr.submit(0, np.ones((1, mgr.engine.model.n_features), np.float32))
                refusal = None
            except RuntimeError as e:
                refusal = str(e)
        return {"role_at_start": role, "role": mgr.role, "rebuilds": mgr.rebuilds,
                "refusal": refusal, "mesh_devices": mgr.stats()["mesh_devices"]}
    ref = HedgeEngine(policy, device=device, use_aot=False)
    nf, ni, nd = ref.model.n_features, ref.n_instruments, ref.n_dates
    n_req, seed = sc["requests"], sc.get("seed", 0)
    states, prices = _requests(n_req, nf, ni, seed)
    want = [ref.evaluate(i % nd, states[i:i + 1], prices[i:i + 1]) for i in range(n_req)]
    rows = sc.get("block_rows", 0)
    if rows:
        bstates, bprices = _requests(rows, nf, ni, seed + 1)
        bwant = ref.evaluate(1 % nd, bstates, bprices)
    plan = FaultPlan(device_loss={"serve/dispatch": sc.get("loss_budget", 1)},
                     survivors=sc.get("survivors"))
    reg, sink = obs.Registry(), obs.ListSink()
    log, blocks, loss_error = [], {}, None
    t0 = time.perf_counter()
    with obs.active(reg, sink):
        with DegradeManager(policy, **kw) as mgr:
            if rows:
                blocks["healthy"] = mgr.submit_block(1 % nd, bstates, bprices).result(timeout=600)
            futures = []
            for i in range(n_req):
                args = (i % nd, states[i:i + 1], prices[i:i + 1])
                if i == sc.get("loss_at"):
                    with guard.faults(plan) as inj:
                        futures.append(mgr.submit(*args))
                        loss_error = futures[-1].exception(timeout=600)
                    log += [site for site, _ in inj.log]
                else:
                    futures.append(mgr.submit(*args))
                if sc.get("sync"):  # one request in flight at a time
                    futures[-1].exception(timeout=600)
            if rows and sc.get("block_loss"):
                with guard.faults(plan) as inj:
                    blocks["replayed"] = mgr.submit_block(1 % nd, bstates, bprices).result(
                        timeout=600)
                log += [site for site, _ in inj.log]
            errors = [f.exception(timeout=600) for f in futures]
            got = [f.result() if e is None else None for f, e in zip(futures, errors)]
            if rows:
                blocks["recovered"] = mgr.submit_block(1 % nd, bstates, bprices).result(
                    timeout=600)
            if mgr._recovery_thread is not None:  # the replays resolve before the record
                mgr._recovery_thread.join(timeout=600)
            st = mgr.stats()
    return {"role": mgr.role, "wall_s": time.perf_counter() - t0, "stats": st,
            "injected": log, "loss_error": None if loss_error is None else str(loss_error),
            "failed": sum(e is not None for e in errors),
            "errors": [None if e is None else repr(e) for e in errors],
            "bitwise": [g is not None and _same(g, w) for g, w in zip(got, want)],
            "got": got, "states": states, "prices": prices,
            "block_inputs": (bstates, bprices) if rows else None,
            "blocks": {k: {"n_served": b.n_served, "bitwise": _same((b.phi, b.psi, b.value),
                                                                    bwant),
                           "phi": b.phi[:64], "psi": b.psi[:64]}
                       for k, b in blocks.items()},
            "counters": {k: v["value"] for k, v in reg.collect().items()
                         if k.startswith("guard/")},
            "guard_events": [e.get("name") for e in sink.events
                             if str(e.get("name", "")).startswith("guard/")],
            "nvcc": cuda_build.BUILD_STATS["nvcc"] - b0["nvcc"],
            "captures": cuda_build.BUILD_STATS["captures"] - b0["captures"]}


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


def _device_mesh_cls():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh


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
    if jobs.get("device_mesh_probe"):
        from orp_tpu_torch.parallel.mesh import mesh_device

        try:
            probe = _device_mesh_cls()(mesh_device(mesh).type, [0, 1],
                                       mesh_dim_names=("probe",))
            res["device_mesh_probe"] = {"coordinate": probe.get_coordinate()}
        except Exception as e:  # orp: noqa[ORP009] -- the refusal is the probe's answer, recorded
            res["device_mesh_probe"] = {"refused": f"{type(e).__name__}: {e}"[:300]}
    if jobs.get("stand_in"):
        _stand_in_captures(args.device)
    if "aot" in jobs:
        res["aot"] = _aot(jobs["aot"], mesh, device)
    if "degrade" in jobs:
        res["degrade"] = _degrade(jobs["degrade"], mesh, device, args.rank)
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
