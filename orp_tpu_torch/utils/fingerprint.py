"""Run fingerprints and the policy-shape guard (counterpart of ``orp_tpu/utils/fingerprint.py``).

A checkpoint directory is meaningful only under the run configuration that
wrote it: its ``run_fingerprint.txt`` records that configuration as a
string, and reopening the directory under another one refuses with a
ValueError instead of resuming stale or shape-garbled state.

The per-date params a trained result or bundle carries must be exactly the
shapes its model over ``n_dates`` dates implies; a mismatch raises a
ValueError naming both signatures before any path is simulated.

:func:`policy_fingerprint` is a trained policy's compatibility string, the
one a bundle directory records; it is the JAX package's string for the same
policy, so either package's bundle guard reads the other's.
"""

from __future__ import annotations

import pathlib

import torch

from orp_tpu_torch.utils.atomic import atomic_write_text

FINGERPRINT_FILE = "run_fingerprint.txt"


def read_fingerprint(directory: str | pathlib.Path) -> str | None:
    """The fingerprint recorded in ``directory``, or None if none exists."""
    f = pathlib.Path(directory) / FINGERPRINT_FILE
    return f.read_text() if f.exists() else None


def write_fingerprint(directory: str | pathlib.Path, fingerprint: str) -> None:
    """Record ``fingerprint`` in ``directory`` (atomically: a torn guard file
    would make a valid directory unopenable)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    atomic_write_text(d / FINGERPRINT_FILE, fingerprint)


def verify_fingerprint(directory: str | pathlib.Path, fingerprint: str, *,
                       what: str = "directory") -> None:
    """Raise unless ``directory`` records exactly ``fingerprint``; a missing
    side file raises too (a directory without provenance cannot be proven
    compatible)."""
    saved = read_fingerprint(directory)
    if saved is None:
        raise ValueError(
            f"{what} {pathlib.Path(directory)} has no {FINGERPRINT_FILE} — "
            "not a directory written by this framework (or partially copied)")
    if saved != fingerprint:
        raise ValueError(
            f"{what} {pathlib.Path(directory)} belongs to a different run config:\n"
            f"  saved:   {saved}\n  current: {fingerprint}\n"
            "use a fresh directory (or delete the old one)")


def check_fingerprint(directory: str | pathlib.Path, fingerprint: str) -> None:
    """Write the run fingerprint on first use; refuse a mismatched directory."""
    if read_fingerprint(directory) is None:
        write_fingerprint(directory, fingerprint)
    else:
        verify_fingerprint(directory, fingerprint, what="checkpoint dir")


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


#: a model dtype as the JAX package's model repr spells it
_REFERENCE_DTYPE = {torch.float32: "<class 'jax.numpy.float32'>",
                    torch.float64: "<class 'jax.numpy.float64'>",  # orp: noqa[ORP001] -- the reference repr table must name every dtype a model may carry
                    torch.bfloat16: "<class 'jax.numpy.bfloat16'>"}


def _model_repr(model) -> str:
    """``repr(model)`` with the dtype spelled as the JAX package's model repr
    spells it (the only field the two reprs write differently)."""
    return repr(model).replace(f"dtype={model.dtype}", f"dtype={_REFERENCE_DTYPE[model.dtype]}")


def policy_fingerprint(model, n_dates: int, *, dual_mode: str, holdings_combine: str,
                       cost_of_capital: float) -> str:
    """The full compatibility string of a trained hedge policy: model config,
    date count, per-date param shapes and the value/holdings combine
    semantics; nothing path-simulation-specific (one policy serves any path
    set)."""
    return (f"orp-policy-v1 model={_model_repr(model)} n_dates={n_dates} "
            f"dual_mode={dual_mode} holdings_combine={holdings_combine} "
            f"cost_of_capital={cost_of_capital} "
            f"params=[{describe_model_params(model, n_dates)}]")


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
