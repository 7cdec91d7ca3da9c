"""Hedge networks (forward only)."""

from orp_tpu_torch.models.mlp import HedgeMLP

__all__ = ["HedgeMLP"]
