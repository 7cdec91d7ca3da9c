"""Path simulation on the Sobol stream (GBM slice)."""

from orp_tpu_torch.sde import payoffs
from orp_tpu_torch.sde.grid import TimeGrid, bond_curve, reduce_grid
from orp_tpu_torch.sde.kernels import scan_sde, simulate_gbm_log

__all__ = ["TimeGrid", "bond_curve", "payoffs", "reduce_grid", "scan_sde",
           "simulate_gbm_log"]
