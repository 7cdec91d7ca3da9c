"""Config-driven entry points (the European inference path)."""

from orp_tpu_torch.api.config import EuropeanConfig, SimConfig, TrainConfig
from orp_tpu_torch.api.pipelines import PipelineResult, european_oos

__all__ = ["EuropeanConfig", "PipelineResult", "SimConfig", "TrainConfig", "european_oos"]
