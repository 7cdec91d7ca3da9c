"""Path simulation on the Sobol stream (GBM, Heston and the pension system)."""

from orp_tpu_torch.sde import payoffs
from orp_tpu_torch.sde.grid import TimeGrid, bond_curve, reduce_grid
from orp_tpu_torch.sde.kernels import (binomial_inversion_deaths, qe_mgf_argument,
                                       qe_step_constants, scan_sde, simulate_gbm_log,
                                       simulate_heston_log, simulate_heston_qe,
                                       simulate_pension)

__all__ = ["TimeGrid", "binomial_inversion_deaths", "bond_curve", "payoffs",
           "qe_mgf_argument", "qe_step_constants", "reduce_grid", "scan_sde",
           "simulate_gbm_log", "simulate_heston_log", "simulate_heston_qe",
           "simulate_pension"]
