"""Config-driven entry points (the European and Heston pipelines)."""

from orp_tpu_torch.api.config import EuropeanConfig, HestonConfig, SimConfig, TrainConfig
from orp_tpu_torch.api.pipelines import (PipelineResult, european_hedge, european_oos,
                                         heston_hedge, heston_oos, resolve_heston_scheme)

__all__ = ["EuropeanConfig", "HestonConfig", "PipelineResult", "SimConfig", "TrainConfig",
           "european_hedge", "european_oos", "heston_hedge", "heston_oos",
           "resolve_heston_scheme"]
