"""One job: ``api.european_hedge`` at the traffic's paths, the fused
Gauss-Newton walk on the paths of kernel K1, then the prices and the report.

The job keeps the knots K1 wrote for the walk (the program's state, by
reference: no copy and no second launch), so that the check follows the walk
on the very rows it was fitted on and holds the knots to the reference's at
every row by themselves (``check.py``)."""

from __future__ import annotations

from orp_tpu_torch.api import european_hedge, pipelines

from portbench.jobs import Job as _Job
from portbench.program_configs import euro_configs


class Job(_Job):
    train = True

    def __init__(self, cfg: dict, traffic: dict, device):
        self.euro, self.sim, self.train_cfg = euro_configs(cfg, traffic["n_paths"])
        self.device = device
        self.avoid_seeds = (cfg["policy_seed"],)
        self.knots = None

    def run(self, seed: int):
        kernel = pipelines.gbm_log_fused

        def keep_knots(*args, **kwargs):
            self.knots = kernel(*args, **kwargs)
            return self.knots

        self.knots = None
        pipelines.gbm_log_fused = keep_knots
        try:
            return european_hedge(self.euro, self.sim(seed), self.train_cfg, device=self.device)
        finally:
            pipelines.gbm_log_fused = kernel

    def full(self, res) -> dict:
        return {**super().full(res), "knots": {"S": self.knots}}
