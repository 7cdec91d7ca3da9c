"""The hedge network (forward, init, closed-form readout and Jacobian)."""

from orp_tpu_torch.models.mlp import HedgeMLP

__all__ = ["HedgeMLP"]
