"""What several readers share: the job's mean wall, the simulation kernel's
f32 work and its device time per launch."""

from __future__ import annotations

import statistics

from portbench.costs.k1_bound_ms import k1_work
from portbench.costs.k3c_bound_ms import k3c_work


def job_s(ctx: dict) -> float | None:
    """Mean wall of the traced run's jobs the profiler did not cover."""
    return statistics.fmean(ctx["job_times"]) if ctx["job_times"] else None


def walk_trips(ctx: dict) -> float:
    """The CDF walk's trips of one job: one per death, from the reference's paths."""
    return ctx["extra"].get("deaths_per_path", 0.0) * ctx["traffic"]["n_paths"]


def sim_work(ctx: dict) -> tuple[float, float, float]:
    """``(bytes, int ops, f32 ops)`` of the job's path kernel."""
    cfg, n = ctx["cfg"], ctx["traffic"]["n_paths"]
    if cfg["family"] == "european":
        return k1_work(n, cfg["n_steps"], cfg["rebalance_every"])
    return k3c_work(n, cfg["n_steps"], cfg["rebalance_every"], False,
                    cfg["binomial_mode"] == "inversion", walk_trips(ctx))


def kernel_ms(ctx: dict, tag: str) -> float | None:
    """Mean device ms a launch of the kernels whose name holds ``tag``."""
    hits = [v for k, v in ctx["trace"]["by_name"].items() if tag in k]
    count = sum(c for _, c in hits)
    return sum(s for s, _ in hits) / count * 1e3 if count else None


def idle_pct(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
