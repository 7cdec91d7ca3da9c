"""The benchmark's driver: finds a cell's configuration, traffic, job entry,
limits and per-layer readers by name, runs the set-up and the closed-loop
window, reads the trace, and decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found from the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of the configuration's entry);
- ``workloads/<traffic>.json``: the job kind (``train`` or ``revalue``), the
  paths a job simulates, the rows the check keeps a job, the jobs profiled;
- ``entries/<family>_<job>.py``: a ``Job`` class that drives the program's
  entry point for that configuration family and job kind;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a ``read(ctx)`` returning the metric or None.

One caller runs whole jobs back to back (a risk team's batch): set-up ends
with one warm job, which is not timed; jobs then start until ``seconds`` have
passed, and the job running at that moment completes. Job ``i`` draws its
Sobol scramble seed from ``(seed, i)``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from portbench.reference import mlp as reference_mlp

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "orp_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``), each
    compared whole: ``orp_tpu_torch`` is not ``orp_tpu``."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module from its file, by path (metric names carry dots)."""
    name = "portbench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` and everything found by its names."""

    def __init__(self, bench: dict, name: str, overrides: dict | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        self.spec = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.cfg = load_json(ROOT / conf["file"])
        reference_mlp.check_model(self.cfg["model"])
        self.traffic = load_json(BENCH / "workloads" / f"{self.spec['traffic']}.json")
        self.traffic.update(overrides or {})
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.entry = BENCH / "entries" / f"{self.cfg['family']}_{self.traffic['job']}.py"
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def job_seed(run_seed: int, i: int, avoid=()) -> int:
    """Job ``i``'s scramble seed, a 32-bit word from ``(run_seed, i)``; never a
    seed in ``avoid`` (a committed policy's training seed)."""
    extra = 0
    while True:
        seq = np.random.SeedSequence([int(run_seed), int(i), extra])
        s = int(seq.generate_state(1, np.uint32)[0])
        if s not in avoid:
            return s
        extra += 1


def sample_rows(run_seed: int, n_paths: int, n_rows: int) -> torch.Tensor:
    """The rows the check keeps of every job: the first and the last path and
    ``n_rows - 2`` more drawn from the run's seed, ascending."""
    gen = torch.Generator().manual_seed(int(run_seed) & ((1 << 63) - 1))
    pick = torch.randperm(n_paths - 2, generator=gen)[:max(n_rows - 2, 0)] + 1
    return torch.sort(torch.cat([torch.tensor([0, n_paths - 1]), pick]))[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, name: str, *, seed: int, seconds: float, trace: bool, device,
             t0: float, overrides: dict | None = None) -> dict:
    """One run of cell ``name``: the result line as a dict, its last key
    ``compared`` holding each number the check compared beside its limit.
    ``overrides`` replace fields of the traffic (the tests' small cells)."""
    cell = Cell(bench, name, overrides)
    entry = load_module(cell.entry)
    job = entry.Job(cell.cfg, cell.traffic, device)
    avoid = set(job.avoid_seeds)
    rows = sample_rows(seed, cell.traffic["n_paths"], cell.traffic["sample_rows"])
    rows_dev = rows.to(device)
    job.run(job_seed(seed, 0, avoid))
    _sync(device)

    from portbench import tracing

    kept, times, failed = [], [], 0
    # the allocator's reserved GiB after each job: a look at its stalls, beside ``job_s``
    on_card, reserved = torch.device(device).type == "cuda", []
    prof, telemetry, span_counts = None, None, []
    n_prof = int(cell.traffic["profile_jobs"]) if trace else 0
    last = None
    t_start = time.perf_counter()
    i = 0
    while True:
        i += 1
        s = job_seed(seed, i, avoid)
        if trace and i == 1:
            prof = tracing.start(device)
            t_prof0 = time.perf_counter()
        if trace and i == n_prof + 1:
            prof_s = time.perf_counter() - t_prof0
            tracing.stop(prof)
            telemetry = tracing.telemetry_session()
        t_job = time.perf_counter()
        try:
            res = job.run(s)
            rec = job.keep(res, s, rows_dev)
            _sync(device)
        except Exception as exc:  # a failed job is counted, and the run is not correct
            failed += 1
            print(f"job {i} (seed {s}) failed: {exc!r}", file=sys.stderr)
            res = rec = None
        dt = time.perf_counter() - t_job
        if on_card:
            reserved.append(torch.cuda.memory_reserved() / 2 ** 30)
        if rec is not None:
            kept.append(rec)
            if job.train:
                # the whole value ledger of the job that may prove the last;
                # the rest of its result is freed before the next job starts
                last = (rec, job.full(res))
        res = None
        if i > n_prof:
            times.append(dt)
            if telemetry is not None:
                span_counts.append(tracing.span_durations(telemetry))
        if time.perf_counter() - t_start >= seconds and i > n_prof:
            break
    window_s = time.perf_counter() - t_start
    setup_s = t_start - t0
    n_jobs = i
    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    if telemetry is not None:
        tracing.close_session(telemetry)
    if last is not None:
        last[0]["full"] = last[1]
    last = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    from portbench import check

    numbers, extra = {}, {}
    if kept:
        numbers, extra = check.readings(cell.cfg, cell.traffic, kept, rows, job.reference_policy(),
                                        device)
    compared = {k: (numbers.get(k, math.nan), float(v)) for k, v in cell.limits.items()}
    correct = (failed == 0 and bool(kept)
               and all(math.isfinite(v) and v <= lim for v, lim in compared.values()))

    metrics = {}
    result = {"correct": correct, "attempted": n_jobs, "failed": failed, "metrics": metrics,
              "job_s": times, "reserved_gib": reserved}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if not trace:
        per_job = window_s / n_jobs
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": per_job, "unit": m["unit"]}
    else:
        summary = tracing.summarize(prof, prof_s)
        ctx = {"cfg": cell.cfg, "traffic": cell.traffic, "cell": name, "trace": summary,
               "job_times": times, "spans": span_counts, "extra": extra, "n_profiled": n_prof}
        for m in cell.per_layer:
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["device"] = dev
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result
