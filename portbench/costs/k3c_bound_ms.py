"""Least time of kernel K3c (``Pension<kSV, kInversion>``, the fused pension
system). Frozen copy of ``chip_smoke.py:532-552``, its work split out as
:func:`k3c_work`."""

from portbench.costs.as241_ops import AS241_OPS
from portbench.costs.bound import bound
from portbench.costs.sobol_int_ops import sobol_int_ops

# f32 operations of the step besides its AS241 draws (exp, sqrt and a division
# count one each, so the count is a lower bound): the constant-vol fund 3, the
# SV fund 18; mortality and survival 7; inversion thinning 11 and 7 per walk
# trip; normal thinning 11
K3C_FUND_OPS = {False: 3, True: 18}
K3C_MORT_OPS, K3C_INV_OPS, K3C_TRIP_OPS, K3C_NORMAL_OPS = 7, 11, 7, 11


def k3c_work(n_paths: int, n_steps: int, store_every: int, sv: bool, inversion: bool,
             walk_trips: float) -> tuple[float, float, float]:
    """``(bytes, int ops, f32 ops)``: the direction table in and the 3 (4 with
    SV) state slots' knots out; one Sobol word per used factor per path-step;
    the AS241 of each normal factor and the step's f32 work, with the CDF
    walk's trips (``walk_trips``, one per death)."""
    n_knots = n_steps // store_every + 1
    slots = 4 if sv else 3
    bytes_ = n_steps * 4 * 32 * 4 + slots * n_knots * n_paths * 4
    words = (4 if sv else 3) * n_steps
    normals = (3 if sv else 2) + (0 if inversion else 1)
    step = normals * AS241_OPS + K3C_FUND_OPS[sv] + K3C_MORT_OPS + (
        K3C_INV_OPS if inversion else K3C_NORMAL_OPS)
    f32_ops = n_paths * n_steps * step + walk_trips * K3C_TRIP_OPS
    return bytes_, sobol_int_ops(n_paths, words), f32_ops


def k3c_bound_ms(n_paths: int, n_steps: int, store_every: int, sv: bool, inversion: bool,
                 walk_trips: float) -> tuple[float, str]:
    return bound(*k3c_work(n_paths, n_steps, store_every, sv, inversion, walk_trips))
