"""The whole revaluation's share of the card's f32 peak: the path kernel's
f32 work and the replay's (``costs/replay_flops``), over the job's wall and
the 67 TFLOP/s data-sheet peak."""

from portbench.costs.peaks import F32_FLOP_PER_S
from portbench.costs.replay_flops import replay_flops
from portbench.metrics._common import job_s, sim_work


def read(ctx):
    wall = job_s(ctx)
    if wall is None:
        return None
    cfg = ctx["cfg"]
    flops = sim_work(ctx)[2] + replay_flops(ctx["traffic"]["n_paths"],
                                            cfg["n_steps"] // cfg["rebalance_every"],
                                            cfg["model"]["n_features"])
    return 100.0 * flops / wall / F32_FLOP_PER_S
