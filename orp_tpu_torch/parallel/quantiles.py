"""Quantiles for the risk analytics (counterpart of ``orp_tpu/parallel/quantiles.py``).

- ``method="sort"``: exact, a sort plus ``jnp.quantile``'s default linear
  rule. ``torch.quantile`` refuses inputs above 2^24 elements, and
  ``var_overall`` at the north-star width pools 1M paths x 52 dates = 54.5M
  residuals, so the rule is written out. The position ``q (n - 1)`` is taken
  in the data's dtype, as ``jnp.quantile`` does.
- ``method="histogram"``: fixed-bin histogram inversion with linear
  interpolation inside the selected bin; error <= (max - min) / bins.
"""

from __future__ import annotations

import torch


def sort_quantile(x: torch.Tensor, qs: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Linear-interpolated quantiles of ``x`` along ``dim``: ``(len(qs), *rest)``."""
    xs = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    q = qs.to(x.dtype) * (torch.tensor(n, dtype=x.dtype) - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    low_i = low.clamp(0, n - 1).long().to(x.device)
    high_i = high.clamp(0, n - 1).long().to(x.device)
    xs = xs.movedim(dim, 0)
    shape = (-1,) + (1,) * (xs.ndim - 1)
    lo_v, hi_v = xs[low_i], xs[high_i]
    return lo_v * low_w.to(x.device).reshape(shape) + hi_v * high_w.to(x.device).reshape(shape)


def histogram_quantile(x: torch.Tensor, qs: torch.Tensor, n_bins: int = 16384) -> torch.Tensor:
    """Approximate quantiles of flat ``x`` by CDF inversion over ``n_bins`` bins."""
    x = x.reshape(-1)
    qs = torch.atleast_1d(qs.to(device=x.device, dtype=x.dtype))
    n = x.shape[0]
    lo, hi = torch.min(x), torch.max(x)
    tiny = torch.finfo(x.dtype).tiny
    span = torch.clamp(hi - lo, min=tiny)
    b = torch.clamp(((x - lo) / span * n_bins).to(torch.int32), 0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=x.device)
    counts.index_add_(0, b.long(), torch.ones_like(b, dtype=torch.int64))
    cdf = torch.cumsum(counts, 0).to(x.dtype) / n
    idx = torch.clamp(torch.searchsorted(cdf, qs, side="left"), 0, n_bins - 1)
    cdf_lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    mass = torch.clamp(cdf[idx] - cdf_lo, min=tiny)
    frac = torch.clamp((qs - cdf_lo) / mass, 0.0, 1.0)
    edges_lo = lo + span * idx.to(x.dtype) / n_bins
    return edges_lo + span / n_bins * frac


def quantile(x: torch.Tensor, qs, method: str = "sort", n_bins: int = 16384) -> torch.Tensor:
    """Quantiles of flattened ``x`` at levels ``qs``, dispatching on ``method``."""
    qs_t = torch.atleast_1d(torch.as_tensor(qs, dtype=x.dtype))
    if method == "sort":
        return sort_quantile(x.reshape(-1), qs_t)
    if method == "histogram":
        return histogram_quantile(x, qs_t, n_bins=n_bins)
    raise ValueError(f"unknown quantile method {method!r}")
