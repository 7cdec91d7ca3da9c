"""The Gauss-Newton backward walk, its result types and out-of-sample replay."""

from orp_tpu_torch.train.backward import BackwardConfig, BackwardResult, backward_induction
from orp_tpu_torch.train.gn import GNConfig, fit_gn
from orp_tpu_torch.train.replay import replay_walk

__all__ = ["BackwardConfig", "BackwardResult", "GNConfig", "backward_induction", "fit_gn",
           "replay_walk"]
