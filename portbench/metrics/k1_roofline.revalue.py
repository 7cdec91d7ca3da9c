"""Kernel K1's share of its roofline in a revaluation: ``costs/k1_bound_ms`` at
the job's shapes over K1's device time a launch in the profiled jobs."""

from portbench.costs.k1_bound_ms import k1_bound_ms
from portbench.metrics._common import kernel_ms


def read(ctx):
    ms = kernel_ms(ctx, "GbmLog")
    if ms is None:
        return None
    cfg = ctx["cfg"]
    least, _ = k1_bound_ms(ctx["traffic"]["n_paths"], cfg["n_steps"], cfg["rebalance_every"])
    return 100.0 * least / ms
