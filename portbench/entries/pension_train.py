"""One job: ``api.pension_hedge`` at the traffic's paths, the fused walk of
both legs (Gauss-Newton, then the IRLS quantile leg) on the paths of kernel
K3c, then the report."""

from __future__ import annotations

from orp_tpu_torch.api import pension_hedge

from portbench.jobs import Job as _Job
from portbench.program_configs import pension_config


class Job(_Job):
    train = True

    def __init__(self, cfg: dict, traffic: dict, device):
        self.cfg, self.n_paths, self.device = cfg, traffic["n_paths"], device
        self.avoid_seeds = (cfg["policy_seed"],)

    def run(self, seed: int):
        return pension_hedge(pension_config(self.cfg, self.n_paths, seed), device=self.device)
