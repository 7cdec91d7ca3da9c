"""Risk analytics and the OLS-martingale price."""

from orp_tpu_torch.risk.analytics import HedgeReport, build_report
from orp_tpu_torch.risk.controls import martingale_ols_price

__all__ = ["HedgeReport", "build_report", "martingale_ols_price"]
