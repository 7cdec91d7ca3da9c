"""Kernel K3c's share of its roofline in a revaluation: ``costs/k3c_bound_ms``
at the job's shapes, the walk's trips from the reference's deaths, over
K3c's device time a launch in the profiled jobs."""

from portbench.costs.k3c_bound_ms import k3c_bound_ms
from portbench.metrics._common import kernel_ms, walk_trips


def read(ctx):
    ms = kernel_ms(ctx, "Pension")
    if ms is None:
        return None
    cfg = ctx["cfg"]
    least, _ = k3c_bound_ms(ctx["traffic"]["n_paths"], cfg["n_steps"], cfg["rebalance_every"],
                            False, cfg["binomial_mode"] == "inversion", walk_trips(ctx))
    return 100.0 * least / ms
