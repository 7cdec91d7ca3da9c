"""The useful FLOPs of the Gauss-Newton backward walk. ``gn_iteration_flops``
and the MSE leg are frozen copies of ``orp_tpu_torch/utils/flops.py:52`` and
``:62``; the IRLS quantile leg (``train/gn.fit_gn_pinball``, run by
``train/backward.py:298`` with the same iteration counts), which that count
leaves out, is added here."""

from portbench.costs.mlp_flops import mlp_forward_flops, mlp_param_count


def gn_iteration_flops(n_rows: int, p: int, fwd: int) -> int:
    """One LM iteration: the Gram pair ``J^T J`` and ``J^T r`` (2nP^2 + 2nP),
    the per-sample gradients (~3 forwards), the residual's and the candidate
    loss's forwards, and the P x P solve."""
    gram = 2 * n_rows * p * p + 2 * n_rows * p
    net = n_rows * (3 * fwd + 2 * fwd)
    solve = (2 * p ** 3) // 3
    return gram + net + solve


def irls_iteration_flops(n_rows: int, p: int, fwd: int) -> int:
    """One IRLS iteration of the quantile leg: a Gauss-Newton iteration on the
    weighted Gram ``(J w)^T J``, plus the weights (a select, an abs, a max and
    a division a row) and the weighting of J (nP)."""
    return gn_iteration_flops(n_rows, p, fwd) + n_rows * p + 4 * n_rows


def gn_walk_flops(n_paths: int, n_dates: int, iters_first: int, iters_warm: int,
                  n_features: int, quantile_leg: bool) -> int:
    """One ``iters_first`` fit and ``n_dates - 1`` ``iters_warm`` fits over all
    paths, for the MSE leg and, with ``quantile_leg``, the IRLS leg too."""
    p = mlp_param_count(n_features)
    fwd = mlp_forward_flops(n_features)
    iters = iters_first + (n_dates - 1) * iters_warm
    total = iters * gn_iteration_flops(n_paths, p, fwd)
    if quantile_leg:
        total += iters * irls_iteration_flops(n_paths, p, fwd)
    return total
