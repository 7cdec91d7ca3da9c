"""One job: ``api.pension_oos`` of the committed pension policy on fresh
scenarios of kernel K3c (the replay, then the report); no training."""

from __future__ import annotations

import warnings

from orp_tpu_torch.api import pension_oos
from orp_tpu_torch.serve.bundle import load_bundle

from portbench.jobs import Job as _Job
from portbench.jobs import policy_dir, reference_policy
from portbench.program_configs import pension_config


class Job(_Job):
    def __init__(self, cfg: dict, traffic: dict, device):
        self.cfg, self.n_paths, self.device = cfg, traffic["n_paths"], device
        self.policy = load_bundle(policy_dir(cfg))
        self.avoid_seeds = (cfg["policy_seed"],)

    def run(self, seed: int):
        with warnings.catch_warnings():
            # the replay's note that shared-weight values collapse to the
            # quantile leg's, once a job
            warnings.simplefilter("ignore", UserWarning)
            return pension_oos(self.policy, pension_config(self.cfg, self.n_paths, seed),
                               device=self.device)

    def reference_policy(self):
        return reference_policy(self.cfg)
