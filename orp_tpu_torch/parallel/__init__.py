"""Reductions over the path axis (single device in this slice)."""

from orp_tpu_torch.parallel.quantiles import histogram_quantile, quantile, sort_quantile

__all__ = ["histogram_quantile", "quantile", "sort_quantile"]
