"""The f32 work of replaying a policy: per row and date one forward to the
holdings, the value and the next date's gains (a dot with the k prices
each, 2k), the cost-of-capital combine (3) and the residual (1)."""

from portbench.costs.mlp_flops import mlp_forward_flops


def replay_flops(n_rows: int, n_dates: int, n_features: int, k: int = 2) -> int:
    return n_rows * n_dates * (mlp_forward_flops(n_features) + 4 * k + 4)
