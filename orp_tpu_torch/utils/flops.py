"""Achieved-FLOP/s and MFU accounting for the hedge workload (counterpart of
``orp_tpu/utils/flops.py``).

The analytic model counts the algorithm's USEFUL arithmetic (the number a
user would compute from the math, not a census of the launched kernels), so
MFU here answers "what fraction of the card's ceiling does the *algorithm*
extract". The dominant GN term is the Gram pair ``JᵀWJ`` / ``Jᵀr`` (2nP² +
2nP per iteration, P = 106 for the 1-feature hedge MLP, whose Phi_Psi head
is always 2-wide); the per-sample gradients (~3x a forward pass), the P x P
solve and the line-search loss are sub-percent at benchmark shapes.
``tests/test_torch_risk_tools.py`` holds it against
``torch.utils.flop_counter.FlopCounterMode``.

Peaks: the card's own, from NVIDIA's H100 SXM data sheet (dense, no
sparsity), for the NVIDIA H100 80GB HBM3 at its 700 W power limit: 989
TFLOP/s bf16 on the tensor cores and 67 TFLOP/s f32 outside them. The port
pins TF32 off (``utils/precision.full_f32``), so its f32 matmuls run at the
f32 rate and ``mfu_f32_ceiling`` is FLOP/s over that peak; both denominators
are reported.
"""

from __future__ import annotations

# The card's ceilings, read from here by ``obs/perf.PEAK_TABLE`` and
# ``chip_smoke.py``: NVIDIA H100 80GB HBM3 at its 700 W limit, from NVIDIA's
# H100 SXM data sheet (dense rates, no sparsity).
PEAK_BF16_H100 = 989e12   # bf16 on the tensor cores, FLOP/s (data sheet: BF16 Tensor Core)
PEAK_F32_H100 = 67e12     # f32 outside the tensor cores, FLOP/s (data sheet: FP32;
#                           132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz)
PEAK_INT32_H100 = 16.7e12  # int32 ops/s: 132 SMs x 64 INT32 lanes x 1.98 GHz (the
#                            data sheet's SM count and boost clock)
HBM_BYTES_H100 = 3.35e12  # HBM3 bytes/s (data sheet: GPU memory bandwidth)

# GBM log-Euler per path-step: inverse normal (~25) + mul/add chain (~5).
# Sobol itself is uint32 bit arithmetic — integer ops, not FLOPs.
SIM_FLOPS_PER_PATH_STEP = 30


def mlp_param_count(n_features: int, hidden=(8, 8), n_outputs: int = 2) -> int:
    """Parameter count of models.mlp.HedgeMLP (dense chain + biases):
    106 for the 1-feature European config (2-wide Phi_Psi head)."""
    sizes = (n_features, *hidden, n_outputs)
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def mlp_forward_flops(n_features: int, hidden=(8, 8), n_outputs: int = 2) -> int:
    """Multiply-adds of one forward pass, counted as 2 FLOPs each."""
    sizes = (n_features, *hidden, n_outputs)
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def gn_iteration_flops(n_rows: int, p: int, fwd: int) -> int:
    """One LM-GN iteration at ``n_rows`` samples, ``p`` parameters:
    Gram pair (2nP² + 2nP) + per-sample grads (~3 fwd) + residual fwd +
    line-search loss fwd + the P×P solve."""
    gram = 2 * n_rows * p * p + 2 * n_rows * p
    net = n_rows * (3 * fwd + 2 * fwd)          # J rows + resid + cand loss
    solve = (2 * p ** 3) // 3
    return gram + net + solve


def gn_walk_flops(n_paths: int, n_dates: int, iters_first: int, iters_warm: int,
                  n_features: int = 1, n_outputs: int = 2) -> int:
    """Total useful FLOPs of the GN backward walk (the north-star benchmark):
    one ``iters_first`` fit + (n_dates-1) ``iters_warm`` fits, every fit
    full-batch over all paths."""
    p = mlp_param_count(n_features, n_outputs=n_outputs)
    fwd = mlp_forward_flops(n_features, n_outputs=n_outputs)
    iters = iters_first + (n_dates - 1) * iters_warm
    return iters * gn_iteration_flops(n_paths, p, fwd)


def adam_walk_flops(n_paths: int, n_dates: int, epochs_first: int, epochs_warm: int,
                    n_features: int = 1, n_outputs: int = 2) -> int:
    """Adam walk: fwd+bwd (~3 fwd) per sample per epoch, full dataset."""
    fwd = mlp_forward_flops(n_features, n_outputs=n_outputs)
    epochs = epochs_first + (n_dates - 1) * epochs_warm
    return epochs * n_paths * 3 * fwd


def sim_flops(n_paths: int, n_steps: int, per_step: int = SIM_FLOPS_PER_PATH_STEP) -> int:
    return n_paths * n_steps * per_step


def mfu(flops: float, wall_s: float, peak: float = PEAK_BF16_H100) -> float:
    """Model FLOP utilization: achieved useful FLOP/s over the peak."""
    return flops / wall_s / peak


def phase_report(flops: float, wall_s: float) -> dict:
    """The fields a profile stage emits per phase: achieved FLOP/s plus MFU
    against both the bf16 tensor peak and the f32 peak (the port's matmul
    ceiling, TF32 off)."""
    fps = flops / wall_s
    return {
        "flops": int(flops),
        "flops_per_s": round(fps, 1),
        "mfu_bf16_peak": round(fps / PEAK_BF16_H100, 5),
        "mfu_f32_ceiling": round(fps / PEAK_F32_H100, 5),
    }
