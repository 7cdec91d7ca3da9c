"""One job: ``api.european_oos`` of the committed north-star policy on fresh
paths of kernel K1 (the replay, the prices, the report); no training."""

from __future__ import annotations

from orp_tpu_torch.api import european_oos
from orp_tpu_torch.serve.bundle import load_bundle

from portbench.jobs import Job as _Job
from portbench.jobs import policy_dir, reference_policy
from portbench.program_configs import euro_configs


class Job(_Job):
    def __init__(self, cfg: dict, traffic: dict, device):
        self.cfg = cfg
        self.euro, self.sim, self.train_cfg = euro_configs(cfg, traffic["n_paths"])
        self.device = device
        self.policy = load_bundle(policy_dir(cfg))
        self.avoid_seeds = (cfg["policy_seed"],)

    def run(self, seed: int):
        return european_oos(self.policy, self.euro, self.sim(seed), self.train_cfg,
                            device=self.device)

    def reference_policy(self):
        return reference_policy(self.cfg)
