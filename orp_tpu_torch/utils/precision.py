"""Full-f32 matmul guard for the port (counterpart of ``orp_tpu/utils/precision.py``).

The JAX package traces every forward and every Gram under
``jax.default_matmul_precision("highest")``. On an NVIDIA card the hazard with
the same effect is TF32: it keeps ~10 mantissa bits, and a reduced-precision
Gram moved the OLS-martingale price by -2.4bp (SCALING.md §6b). So every entry
point of the port calls :func:`full_f32` before it computes, which pins both
PyTorch switches that could lower an f32 product to TF32.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Pin f32 matmuls and convolutions to full f32 (no TF32). Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
