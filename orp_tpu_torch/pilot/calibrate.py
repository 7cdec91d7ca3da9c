"""Rolling-window calibration with RQMC-bootstrap error bars and the
significance gate that decides when a parameter shift is SIGNAL
(counterpart of ``orp_tpu/pilot/calibrate.py``).

Generalizes ``calib/cir.py`` (one OLS fit over one series) to the pilot's
streaming setting: fit every rolling window of the price history, attach a
moving-block-bootstrap confidence band to each fitted parameter, and fire a
retrain only when the freshly fitted params leave the SERVING bundle's baked
band (churn control — a window that wobbles inside its own noise floor must
not retrain-storm the fleet).

The bootstrap is RQMC-driven (Owen 1997, the same machinery as the pricing
paths): resampled block start positions come from an Owen-scrambled Sobol
matrix (the port's ``qmc.sobol_uniform``, bitwise the JAX package's, run
on the CPU), not iid uniforms, so ``n_boot`` resamples
cover the index space as a low-discrepancy design — visibly tighter CI
estimates at the small ``n_boot`` a serving-side probe can afford. Blocks
(not single returns) preserve the autocorrelation the CIR OLS feeds on.

The accepted fit is BAKED into the candidate bundle directory as
``calibration.json`` at export, becoming the next cycle's comparison band —
the loop carries its own baseline forward.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from orp_tpu_torch.calib.cir import (CalibrationFit, calibrate_prices,
                               log_returns)
from orp_tpu_torch.utils.atomic import atomic_write_text

CALIBRATION_FILE = "calibration.json"
_PARAM_KEYS = ("a", "b", "c", "mu", "sigma0")


@dataclasses.dataclass(frozen=True)
class CalibrationWindow:
    """One rolling-window fit + its bootstrap confidence band.

    ``ci`` maps each of ``a/b/c/mu/sigma0`` to a ``(lo, hi)`` percentile
    interval over ``n_boot`` block-bootstrap refits; resamples whose refit
    failed (no mean reversion / Feller violation on a pathological
    resample) are skipped and counted in ``n_failed`` — a band built from
    fewer than ``n_boot // 2`` survivors raises rather than pretending to
    a confidence it does not have."""

    fit: CalibrationFit
    ci: dict
    n_boot: int
    n_failed: int
    start: int   # index of the window's first price in the full series
    level: float = 0.95

    def to_meta(self) -> dict:
        return {"fit": self.fit.as_dict(),
                "ci": {k: [float(lo), float(hi)]
                       for k, (lo, hi) in self.ci.items()},
                "n_boot": self.n_boot, "n_failed": self.n_failed,
                "start": self.start, "level": self.level}


def _sobol_unit(n_boot: int, n_blocks: int, seed: int) -> np.ndarray:
    """(n_boot, n_blocks) Owen-scrambled Sobol uniforms on the host (f32
    points widened to f64, as the JAX package's)."""
    import torch

    from orp_tpu_torch.qmc.sobol import sobol_uniform

    u = sobol_uniform(torch.arange(n_boot), torch.arange(n_blocks), seed)
    return u.numpy().astype(np.float64)


def bootstrap_ci(prices, *, vol_window: int = 40, n_boot: int = 64,
                 seed: int = 0, level: float = 0.95,
                 block: int | None = None,
                 annualization: float = 252.0) -> tuple[dict, int]:
    """Moving-block bootstrap band for every calibrated parameter.

    Returns ``(ci, n_failed)``. Each resample rebuilds a synthetic price
    path from ``n_blocks`` contiguous return blocks whose start positions
    are one row of the scrambled Sobol matrix, then refits the full
    calibration on it. Percentile interval at ``level`` over the surviving
    refits."""
    p = np.asarray(prices, np.float64)
    r = log_returns(p)
    n = r.shape[0]
    if block is None:
        # sqrt-of-n block length, floored at the vol window's quarter so a
        # block spans several vol observations (the autocorrelation the
        # OLS regresses on survives the resampling)
        block = max(4, min(n // 4, max(int(np.sqrt(n)), vol_window // 4)))
    n_blocks = int(np.ceil(n / block))
    starts_u = _sobol_unit(int(n_boot), n_blocks, seed)
    fits = {k: [] for k in _PARAM_KEYS}
    n_failed = 0
    for i in range(int(n_boot)):
        starts = (starts_u[i] * (n - block + 1)).astype(np.int64)
        resampled = np.concatenate(
            [r[s:s + block] for s in starts])[:n]
        path = p[0] * np.exp(np.concatenate(
            [np.zeros(1), np.cumsum(resampled)]))
        try:
            f = calibrate_prices(path, vol_window=vol_window,
                                 annualization=annualization)
        except ValueError:
            n_failed += 1
            continue
        for k, v in f.as_dict().items():
            if k in fits:
                fits[k].append(v)
    survivors = int(n_boot) - n_failed
    if survivors < max(2, int(n_boot) // 2):
        raise ValueError(
            f"bootstrap collapsed: only {survivors}/{n_boot} resamples "
            "calibrated (no mean reversion / Feller violations) — the "
            "window is too unstable for a confidence band; widen it or "
            "wait for more history")
    lo_q, hi_q = (1 - level) / 2, 1 - (1 - level) / 2
    ci = {k: (float(np.quantile(v, lo_q)), float(np.quantile(v, hi_q)))
          for k, v in fits.items()}
    return ci, n_failed


def calibrate_window(prices, *, vol_window: int = 40, n_boot: int = 64,
                     seed: int = 0, level: float = 0.95, start: int = 0,
                     annualization: float = 252.0) -> CalibrationWindow:
    """Fit one window and attach its bootstrap band."""
    fit = calibrate_prices(prices, vol_window=vol_window,
                           annualization=annualization)
    ci, n_failed = bootstrap_ci(prices, vol_window=vol_window,
                                n_boot=n_boot, seed=seed, level=level,
                                annualization=annualization)
    return CalibrationWindow(fit=fit, ci=ci, n_boot=int(n_boot),
                             n_failed=n_failed, start=int(start),
                             level=float(level))


def calibrate_rolling(prices, *, window: int, stride: int | None = None,
                      vol_window: int = 40, n_boot: int = 64, seed: int = 0,
                      annualization: float = 252.0) -> list[CalibrationWindow]:
    """Fit every rolling window of ``window`` prices (default stride: half a
    window — adjacent fits share half their data, so the parameter
    trajectory is smooth enough to gate on). Windows that fail to calibrate
    (no mean reversion yet) are skipped — early history is allowed to be
    boring."""
    p = np.asarray(prices, np.float64)
    if stride is None:
        stride = max(1, window // 2)
    out: list[CalibrationWindow] = []
    for start in range(0, p.shape[0] - window + 1, stride):
        try:
            out.append(calibrate_window(
                p[start:start + window], vol_window=vol_window,
                n_boot=n_boot, seed=seed + start, start=start,
                annualization=annualization))
        except ValueError:
            continue
    return out


def shift_significant(fitted: CalibrationFit, baseline: dict) -> tuple[bool, dict]:
    """The churn gate: is ``fitted`` OUTSIDE the serving bundle's baked
    confidence band?

    ``baseline`` is a baked ``CalibrationWindow.to_meta()`` dict
    (``read_calibration``). A parameter counts as shifted only when its
    fresh POINT estimate leaves the baked ``(lo, hi)`` band — the band
    already prices in the estimator's noise, so anything inside it is
    indistinguishable from the regime the serving policy was trained on.
    Returns ``(fired, detail)`` with per-parameter verdicts."""
    band = baseline.get("ci") or {}
    point = fitted.as_dict()
    detail: dict = {}
    fired = False
    for k in _PARAM_KEYS:
        if k not in band:
            continue
        lo, hi = band[k]
        outside = not (lo <= point[k] <= hi)
        detail[k] = {"value": point[k], "band": [lo, hi],
                     "outside": outside}
        fired = fired or outside
    return fired, detail


def bake_calibration(bundle_dir, window: CalibrationWindow) -> pathlib.Path:
    """Atomically write the accepted fit into a bundle directory as
    ``calibration.json`` — the band the NEXT cycle's significance gate
    compares against."""
    path = pathlib.Path(bundle_dir) / CALIBRATION_FILE
    atomic_write_text(path, json.dumps(window.to_meta(), indent=2,
                                       sort_keys=True) + "\n")
    return path


def read_calibration(bundle_dir) -> dict | None:
    """The baked calibration of a bundle directory (None on pre-pilot
    bundles — the gate then treats ANY calibration trigger as significant,
    because there is no band to hide inside)."""
    path = pathlib.Path(bundle_dir) / CALIBRATION_FILE
    if not path.exists():
        return None
    return json.loads(path.read_text())
