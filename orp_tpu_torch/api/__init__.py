"""Config-driven entry points (the European, Heston, basket and pension pipelines)."""

from orp_tpu_torch.api.config import (ActuarialConfig, BasketConfig, EuropeanConfig,
                                      HedgeRunConfig, HestonConfig, MarketConfig, SimConfig,
                                      StochVolConfig, TrainConfig)
from orp_tpu_torch.api.pipelines import (PipelineResult, basket_hedge, basket_oos,
                                         european_hedge, european_oos, heston_hedge, heston_oos,
                                         pension_hedge, pension_oos, replicating_portfolio,
                                         replicating_portfolio_sv, resolve_heston_scheme,
                                         sigma_sweep)
from orp_tpu_torch.train.fit import FitConfig, fit_core, reference_lr_schedule

__all__ = ["ActuarialConfig", "BasketConfig", "EuropeanConfig", "FitConfig", "HedgeRunConfig",
           "HestonConfig", "MarketConfig", "PipelineResult", "SimConfig", "StochVolConfig",
           "TrainConfig", "basket_hedge", "basket_oos", "european_hedge", "european_oos",
           "heston_hedge", "heston_oos", "pension_hedge", "pension_oos", "fit_core",
           "reference_lr_schedule", "replicating_portfolio", "replicating_portfolio_sv",
           "resolve_heston_scheme", "sigma_sweep"]
