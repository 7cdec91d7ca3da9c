"""Side pipeline: CIR volatility-parameter calibration (SURVEY.md §2 row 16)."""

from orp_tpu_torch.calib.cir import (
    CalibrationFit,
    CIRParams,
    annualized_drift,
    calibrate_prices,
    estimate_cir_params,
    log_returns,
    rolling_volatility,
)

__all__ = [
    "CalibrationFit",
    "CIRParams",
    "annualized_drift",
    "calibrate_prices",
    "estimate_cir_params",
    "log_returns",
    "rolling_volatility",
]
