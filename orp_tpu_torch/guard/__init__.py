"""Fault tolerance of the backward walk: the NaN sentinel and its trainer ladder, and the fault injector that proves it and checkpoint/resume."""

from orp_tpu_torch.guard.inject import FaultInjector, FaultPlan, WalkKilled, active, faults
from orp_tpu_torch.guard.sentinel import (TRAINER_LADDER, all_finite, degradation_ladder,
                                          finite_flag, record_degrade, record_nan_event,
                                          sanitize_target)

__all__ = ["FaultInjector", "FaultPlan", "TRAINER_LADDER", "WalkKilled", "active", "all_finite",
           "degradation_ladder", "faults", "finite_flag", "record_degrade", "record_nan_event",
           "sanitize_target"]
