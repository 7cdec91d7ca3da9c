"""Policy-shape guard (counterpart of the shape helpers in ``orp_tpu/utils/fingerprint.py``).

The per-date params a trained result or bundle carries must be exactly the
shapes its model over ``n_dates`` dates implies; a mismatch raises a
ValueError naming both signatures before any path is simulated.
"""

from __future__ import annotations


def describe_params_by_date(params_by_date: dict) -> str:
    """``"b0:(52, 8), w0:(52, 1, 8), ..."``: leaf names sorted, date axis first."""
    return ", ".join(sorted(f"{name}:{tuple(leaf.shape)}"
                            for name, leaf in params_by_date.items()))


def describe_model_params(model, n_dates: int) -> str:
    """The signature ``describe_params_by_date`` gives for ``model`` over ``n_dates``."""
    sizes = (model.n_features, *model.hidden, model.n_outputs)
    parts = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        parts.append(f"w{i}:{(n_dates, fan_in, fan_out)}")
        parts.append(f"b{i}:{(n_dates, fan_out)}")
    return ", ".join(sorted(parts))


def verify_policy_compat(name: str, model, n_dates: int, params_by_date: dict) -> None:
    """Raise unless ``params_by_date`` has exactly ``model``'s per-date shapes."""
    got = describe_params_by_date(params_by_date)
    want = describe_model_params(model, n_dates)
    if got != want:
        raise ValueError(
            f"{name}: trained policy params do not match this run config:\n"
            f"  trained: [{got}]\n  config:  [{want}]\n"
            "the model head/features or the rebalance-date count differ — "
            "evaluate with the config the policy was trained under")
