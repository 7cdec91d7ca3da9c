"""CIR vol-parameter calibration from a price history (closed-form OLS;
counterpart of ``orp_tpu/calib/cir.py``, copied: host NumPy f64).

Re-design of ``Extra: Stochastic Volatility.ipynb``:

- ``CIRParams`` dataclass with the Feller-type ``2ab >= c^2`` validation (#3 —
  the single input validation in the whole reference);
- ``estimate_cir_params`` (#4): OLS of ``dsigma/sqrt(sigma)`` on
  ``[1/sqrt(sigma), sqrt(sigma)]`` without intercept — solved in closed form
  by ``np.linalg.lstsq`` instead of sklearn's LinearRegression. Calibration is
  a host-side pipeline (tiny data, float64) so it runs in NumPy, keeping the
  device path free of it;
- ``rolling_volatility`` (#7): 40-day rolling std of log returns x sqrt(252);
- ``annualized_drift`` (#7): ``mu = log(P_T / P_0) / years``.

Market-data *ingestion* stays host-side and offline (the reference pulls ^GSPC
via yfinance — a network boundary this framework deliberately keeps outside the
compute path): callers pass a price/return array from any source. The
calibrated constants feed ``orp_tpu_torch.api.StochVolConfig`` directly instead of
being hand-pasted into notebook cells (the reference copies ``#8(out)`` into
``Multi Time Step.ipynb#9/#32`` manually).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CIRParams:
    """CIR process parameters; requires the Feller-type condition 2ab >= c^2
    (``Extra: Stochastic Volatility.ipynb#3`` — whose error message states the
    inequality backwards; the *check* is reproduced, the message corrected)."""

    a: float  # mean-reversion speed
    b: float  # asymptotic mean
    c: float  # Brownian scale (vol-of-vol)

    def __post_init__(self):
        if 2 * self.a * self.b < self.c**2:
            raise ValueError(
                f"Feller condition violated: 2ab = {2 * self.a * self.b:.3e} "
                f"< c^2 = {self.c**2:.3e}"
            )


def log_returns(prices) -> np.ndarray:
    """Daily log returns ``log(P_t / P_{t-1})`` (#5)."""
    p = np.asarray(prices, np.float64)
    return np.log(p[1:] / p[:-1])


def rolling_volatility(
    returns, window: int = 40, annualization: float = 252.0
) -> np.ndarray:
    """Rolling-window std of returns x sqrt(annualization) (#7, ``HV40D``).

    Sample std (ddof=1, pandas ``rolling().std()`` semantics). Computed with
    cumulative sums — O(n), no Python loop.
    """
    r = np.asarray(returns, np.float64)
    n = r.shape[0]
    if n < window:
        raise ValueError(f"need >= {window} returns, got {n}")
    c1 = np.concatenate([np.zeros(1), np.cumsum(r)])
    c2 = np.concatenate([np.zeros(1), np.cumsum(r * r)])
    s1 = c1[window:] - c1[:-window]
    s2 = c2[window:] - c2[:-window]
    var = (s2 - s1 * s1 / window) / (window - 1)
    return np.sqrt(np.maximum(var, 0.0) * annualization)


def annualized_drift(prices, years: float) -> float:
    """``mu = log(P_end / P_0) / years`` (#7)."""
    p = np.asarray(prices)
    return float(np.log(p[-1] / p[0]) / years)


def estimate_cir_params(sigma_t) -> CIRParams:
    """OLS CIR estimate from a vol series (#4 semantics, lstsq closed form).

    Regression: ``dsigma_t / sqrt(sigma_t) = ab * (1/sqrt(sigma_t))
    - a * sqrt(sigma_t) + eps``; ``c`` is the residual std (population std,
    matching the notebook's ``np.std``).
    """
    s = np.asarray(sigma_t, np.float64)
    if s.shape[0] < 3:
        raise ValueError("need at least 3 observations")
    if (s <= 0).any():
        raise ValueError("vol series must be strictly positive")
    sqrt_s = np.sqrt(s[:-1])
    y = np.diff(s) / sqrt_s
    X = np.stack([1.0 / sqrt_s, sqrt_s], axis=-1)
    coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
    ab, neg_a = float(coef[0]), float(coef[1])
    a = -neg_a
    if a <= 1e-12:
        # a trending/non-mean-reverting series: the OLS speed is <= 0 and
        # b = ab/a would be negative or blow up — refuse rather than return an
        # explosive CIR parameterisation
        raise ValueError(
            f"series shows no mean reversion (estimated speed a = {a:.3e} <= 0); "
            "CIR calibration is not applicable"
        )
    b = ab / a
    resid = y - X @ coef
    c = float(np.std(resid))
    return CIRParams(a=a, b=b, c=c)  # __post_init__ enforces Feller 2ab >= c^2


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """One complete calibration from a raw price series: the CIR vol
    parameters plus the drift and current-vol state the hedging pipelines
    consume (``StochVolConfig(a, b, c, v0)`` / ``EuropeanConfig(sigma=...)``).
    """

    params: CIRParams
    mu: float        # annualized drift over the series
    sigma0: float    # last rolling-window vol — the current vol state
    n_prices: int
    vol_window: int

    def as_dict(self) -> dict:
        return {"a": self.params.a, "b": self.params.b, "c": self.params.c,
                "mu": self.mu, "sigma0": self.sigma0,
                "n_prices": self.n_prices, "vol_window": self.vol_window}


def calibrate_prices(prices, *, vol_window: int = 40, years: float | None = None,
                     annualization: float = 252.0) -> CalibrationFit:
    """The one-call calibration the CLI and the pilot loop drive: prices ->
    log returns -> rolling vol -> OLS CIR params + drift + current vol.

    ``years`` defaults to ``n_returns / annualization`` (daily prices);
    pass it explicitly for non-daily sampling. Needs at least
    ``vol_window + 3`` prices (``vol_window + 2`` returns give the 3 vol
    observations the OLS requires)."""
    p = np.asarray(prices, np.float64)
    if p.ndim != 1:
        raise ValueError(f"prices must be 1-D, got shape {p.shape}")
    if p.shape[0] < vol_window + 3:
        raise ValueError(
            f"need >= {vol_window + 3} prices for vol_window={vol_window} "
            f"(got {p.shape[0]}): the rolling vol needs vol_window + 2 "
            "returns to yield the 3 observations the CIR OLS requires")
    if (p <= 0).any():
        raise ValueError("prices must be strictly positive")
    r = log_returns(p)
    sigma = rolling_volatility(r, window=vol_window,
                               annualization=annualization)
    if years is None:
        years = r.shape[0] / annualization
    return CalibrationFit(
        params=estimate_cir_params(sigma),
        mu=annualized_drift(p, years),
        sigma0=float(sigma[-1]),
        n_prices=int(p.shape[0]),
        vol_window=int(vol_window),
    )
