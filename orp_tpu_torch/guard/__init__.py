"""Fault tolerance of the backward walk and the serve path: the NaN sentinel and
its trainer ladder, the serving resilience policy (deadlines, shedding, retries,
the circuit breaker), the cool-down gate, topology degradation (drain, rebuild,
replay), and the fault injector that proves them and checkpoint/resume."""

from orp_tpu_torch.guard.cooldown import Cooldown
from orp_tpu_torch.guard.degrade import DegradeManager
from orp_tpu_torch.guard.inject import (FaultInjector, FaultPlan, InjectedDeviceLoss,
                                        InjectedFault, WalkKilled, active, faults)
from orp_tpu_torch.guard.sentinel import (TRAINER_LADDER, all_finite, degradation_ladder,
                                          finite_flag, record_degrade, record_nan_event,
                                          sanitize_target)
from orp_tpu_torch.guard.serve import (CircuitBreaker, DeviceLostError, GuardPolicy, Rejection,
                                       TransientDispatchError, WatchdogTrip, is_rejection)

__all__ = ["CircuitBreaker", "Cooldown", "DegradeManager", "DeviceLostError", "FaultInjector", "FaultPlan",
           "GuardPolicy", "InjectedDeviceLoss", "InjectedFault", "Rejection", "TRAINER_LADDER",
           "TransientDispatchError", "WalkKilled", "WatchdogTrip", "active", "all_finite",
           "degradation_ladder", "faults", "finite_flag", "record_degrade", "record_nan_event",
           "sanitize_target", "is_rejection"]
