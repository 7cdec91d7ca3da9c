"""Least time of kernel K1 (``mf_kernel<GbmLog>``, the fused log-GBM).
Frozen copy of ``chip_smoke.py:504``, its work split out as :func:`k1_work`."""

from portbench.costs.as241_ops import AS241_OPS
from portbench.costs.bound import bound
from portbench.costs.sobol_int_ops import sobol_int_ops


def k1_work(n_paths: int, n_steps: int, store_every: int) -> tuple[float, float, float]:
    """``(bytes, int ops, f32 ops)``: the direction table in and the knots out;
    the Sobol int32 work; AS241 and the update (6) per path-step, exp and a
    multiply per stored knot."""
    n_knots = n_steps // store_every + 1
    bytes_ = n_steps * 32 * 4 + n_knots * n_paths * 4
    f32_ops = n_paths * (n_steps * (6 + AS241_OPS) + 2 * (n_knots - 1))
    return bytes_, sobol_int_ops(n_paths, n_steps), f32_ops


def k1_bound_ms(n_paths: int, n_steps: int, store_every: int) -> tuple[float, str]:
    return bound(*k1_work(n_paths, n_steps, store_every))
