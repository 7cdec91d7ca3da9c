"""Risk analytics and reporting, the OLS-martingale price, the pathwise greeks
and the option-analytics pricers (Asian, barrier, lookback, price surfaces)."""

from orp_tpu_torch.risk.analytics import (FanChart, HedgeReport, build_report,
                                          discounted_payoff_compare, fan_chart,
                                          holdings_summary, residual_pnl_stats, to_frames,
                                          var_by_date, var_overall)
from orp_tpu_torch.risk.asian import asian_call_qmc, geometric_asian_call
from orp_tpu_torch.risk.barrier import down_and_out_call, down_and_out_call_qmc
from orp_tpu_torch.risk.controls import martingale_ols_price
from orp_tpu_torch.risk.greeks import (GreeksResult, HestonGreeks, basket_greeks,
                                       digital_greeks, european_greeks, heston_greeks)
from orp_tpu_torch.risk.lookback import (lookback_call_fixed, lookback_call_floating,
                                         lookback_call_qmc, lookback_floating_qmc)
from orp_tpu_torch.risk.surface import heston_price_surface, implied_vol, price_surface

__all__ = ["FanChart", "GreeksResult", "HedgeReport", "HestonGreeks", "asian_call_qmc",
           "basket_greeks", "build_report", "digital_greeks", "discounted_payoff_compare",
           "down_and_out_call", "down_and_out_call_qmc", "european_greeks", "fan_chart",
           "geometric_asian_call", "heston_greeks", "heston_price_surface", "holdings_summary",
           "implied_vol", "lookback_call_fixed", "lookback_call_floating", "lookback_call_qmc",
           "lookback_floating_qmc", "martingale_ols_price", "price_surface",
           "residual_pnl_stats", "to_frames", "var_by_date", "var_overall"]
