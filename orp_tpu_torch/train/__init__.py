"""Walk result types and out-of-sample replay (the training walk is not ported yet)."""

from orp_tpu_torch.train.backward import BackwardConfig, BackwardResult
from orp_tpu_torch.train.replay import replay_walk

__all__ = ["BackwardConfig", "BackwardResult", "replay_walk"]
