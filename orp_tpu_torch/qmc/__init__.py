"""Sobol QMC: the plain generator and the fused log-GBM kernel's wrapper."""

from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused, gbm_log_plain, ndtri_as241
from orp_tpu_torch.qmc.sobol import direction_numbers, sobol_normal, sobol_uniform

__all__ = ["direction_numbers", "gbm_log_fused", "gbm_log_plain", "ndtri_as241",
           "sobol_normal", "sobol_uniform"]
