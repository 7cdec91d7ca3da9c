"""Full-f32 matmul guard for the port (counterpart of ``orp_tpu/utils/precision.py``).

The JAX package traces every forward and every Gram under
``jax.default_matmul_precision("highest")``. On an NVIDIA card the hazard with
the same effect is TF32: it keeps ~10 mantissa bits, and a reduced-precision
Gram moved the OLS-martingale price by -2.4bp (SCALING.md §6b). So every entry
point of the port calls :func:`full_f32` before it computes, which pins both
PyTorch switches that could lower an f32 product to TF32.

It also pins the bf16 serve tier's reduction: XLA's bf16 dot accumulates in
f32 and rounds once to bf16, while cuBLAS may reduce a bf16 GEMM in bf16
(``allow_bf16_reduced_precision_reduction`` defaults to True), which would
round every partial sum of the bucketed bf16 forward.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Pin f32 matmuls and convolutions to full f32 (no TF32) and bf16 matmuls
    to an f32 reduction. Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def typed_scalar(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` as a 0-dim CPU tensor of ``dtype`` (a tensor already of ``dtype``
    passes through).

    JAX rounds a Python scalar to the array's dtype before it multiplies (bf16:
    0.3 -> 0.30078125); PyTorch multiplies a bf16 tensor by the f32 value of a
    Python scalar. A 0-dim tensor of the working dtype gives JAX's rounding, and
    a CPU one enters a CUDA op as a scalar, with no copy to the card. In f32 and
    f64 it is the Python scalar's value, so no bit moves."""
    return torch.as_tensor(value, dtype=dtype)
