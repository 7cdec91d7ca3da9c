"""Sobol QMC: the plain generator, Brownian helpers and the fused path kernels' wrappers (GBM, Heston, pension)."""

from orp_tpu_torch.qmc import brownian
from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused, gbm_log_plain, ndtri_as241
from orp_tpu_torch.qmc.fused_mf import (heston_log_fused, heston_log_plain, heston_qe_fused,
                                        heston_qe_plain, pension_fused, pension_plain)
from orp_tpu_torch.qmc.sobol import (direction_numbers, sobol_normal, sobol_normal_matrix,
                                     sobol_uniform)

__all__ = ["brownian", "direction_numbers", "gbm_log_fused", "gbm_log_plain", "heston_log_fused",
           "heston_log_plain", "heston_qe_fused", "heston_qe_plain", "ndtri_as241",
           "pension_fused", "pension_plain", "sobol_normal", "sobol_normal_matrix",
           "sobol_uniform"]
