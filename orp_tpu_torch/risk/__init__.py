"""Risk analytics, the OLS-martingale price and the pathwise greeks."""

from orp_tpu_torch.risk.analytics import HedgeReport, build_report
from orp_tpu_torch.risk.controls import martingale_ols_price
from orp_tpu_torch.risk.greeks import (GreeksResult, HestonGreeks, basket_greeks,
                                       digital_greeks, european_greeks, heston_greeks)

__all__ = ["GreeksResult", "HedgeReport", "HestonGreeks", "basket_greeks", "build_report",
           "digital_greeks", "european_greeks", "heston_greeks", "martingale_ols_price"]
