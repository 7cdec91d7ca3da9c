"""The hedge MLP's size and forward work. Frozen copies of
``orp_tpu_torch/utils/flops.py:39`` and ``:46``."""


def mlp_param_count(n_features: int, hidden=(8, 8), n_outputs: int = 2) -> int:
    """Parameters of the dense chain with biases: 106 for one feature, 122 for three."""
    sizes = (n_features, *hidden, n_outputs)
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def mlp_forward_flops(n_features: int, hidden=(8, 8), n_outputs: int = 2) -> int:
    """Multiply-adds of one forward pass, counted as 2 FLOPs each."""
    sizes = (n_features, *hidden, n_outputs)
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
