"""The whole training job's share of the card's f32 peak: the useful FLOPs a
job needs (the Gauss-Newton walk, both legs for the pension, at the
configured iterations; the path kernel's f32 work), over the job's wall and
the 67 TFLOP/s data-sheet peak."""

from portbench.costs.gn_walk_flops import gn_walk_flops
from portbench.costs.peaks import F32_FLOP_PER_S
from portbench.metrics._common import job_s, sim_work


def read(ctx):
    wall = job_s(ctx)
    if wall is None:
        return None
    cfg, tr = ctx["cfg"], ctx["cfg"]["train"]
    flops = gn_walk_flops(ctx["traffic"]["n_paths"], cfg["n_steps"] // cfg["rebalance_every"],
                          tr["gn_iters_first"], tr["gn_iters_warm"], cfg["model"]["n_features"],
                          tr["dual_mode"] != "mse_only") + sim_work(ctx)[2]
    return 100.0 * flops / wall / F32_FLOP_PER_S
