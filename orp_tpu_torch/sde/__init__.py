"""Path simulation on the Sobol stream (GBM, Heston, the pension system and the basket)."""

from orp_tpu_torch.sde import payoffs
from orp_tpu_torch.sde.grid import TimeGrid, bond_curve, reduce_grid
from orp_tpu_torch.sde.kernels import (basket_factor, binomial_inversion_deaths,
                                       heston_sim_fn, qe_mgf_argument, qe_step_constants,
                                       resolve_sim_fn, scan_sde, simulate_gbm_arithmetic,
                                       simulate_gbm_basket, simulate_gbm_log,
                                       simulate_heston_log, simulate_heston_qe,
                                       simulate_pension)

__all__ = ["TimeGrid", "basket_factor", "binomial_inversion_deaths", "bond_curve",
           "heston_sim_fn", "payoffs", "qe_mgf_argument", "qe_step_constants", "reduce_grid",
           "resolve_sim_fn", "scan_sde", "simulate_gbm_arithmetic", "simulate_gbm_basket",
           "simulate_gbm_log", "simulate_heston_log", "simulate_heston_qe",
           "simulate_pension"]
