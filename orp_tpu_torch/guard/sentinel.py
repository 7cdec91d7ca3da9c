"""NaN/Inf sentinels and the trainer degradation ladder of the backward walk (counterpart of ``orp_tpu/guard/sentinel.py``).

A non-finite loss or param at date ``t`` is not local: date ``t``'s values
are date ``t-1``'s fit targets, so one divergence poisons every earlier date
and the price. With ``BackwardConfig.nan_guard`` the walk checks each date's
state (loss, params, value / holdings / residual columns) for finiteness; a
hit warns (:func:`record_nan_event`) and refits the date from its pre-fit
params one rung down :data:`TRAINER_LADDER` per attempt, on a target whose
non-finite rows are replaced by the finite mean (:func:`sanitize_target`),
at most ``nan_retries`` rungs; an exhausted ladder raises.

The walk's clean path reads the date's finiteness flag
(:func:`finite_flag`, a device tensor) in the date's one host read, so the
guard adds no host sync. Under a telemetry session (``obs/``) each hit counts
``guard/nan_event{date,trainer,where}`` and each rung ``guard/degrade{date,to}``
(:func:`record_nan_event`, :func:`record_degrade`), as in the JAX package;
``obs/report.load_convergence`` reads the rungs back.
"""

from __future__ import annotations

import warnings

import torch

from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.parallel.mesh import path_sum

#: degradation order: reference-semantics Adam, then full-batch LM-GN, then
#: the closed-form readout solve (nothing iterative left to diverge)
TRAINER_LADDER = ("adam", "gauss_newton", "final_solve")


def _leaves(trees):
    for x in trees:
        if isinstance(x, dict):
            yield from _leaves(x.values())
        elif isinstance(x, (tuple, list)):
            yield from _leaves(x)
        else:
            yield x


def finite_flag(*trees) -> torch.Tensor:
    """A 0-d bool tensor: every float leaf of ``trees`` (tensors, dicts and
    tuples of them) is finite. Computed where the leaves live; no host read."""
    flags = [torch.isfinite(x).all() for x in _leaves(trees)
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def all_finite(*trees) -> bool:
    """True when every float leaf of ``trees`` is finite (one host read)."""
    return bool(finite_flag(*trees))


def sanitize_target(target: torch.Tensor, mesh=None):
    """Replace non-finite target rows by the finite mean (0 when nothing is
    finite). Returns ``(sanitized, n_bad)``; ``n_bad == 0`` hands back the
    input untouched. Under a paths ``mesh`` the mean is over the finite rows
    of every rank, and ``n_bad`` counts this rank's rows."""
    finite = torch.isfinite(target)
    kept = torch.where(finite, target, torch.zeros_like(target))
    # the sums first, so that every rank enters their all_reduce
    total, n_ok = path_sum(torch.stack([kept.sum(), finite.sum().to(target.dtype)]), mesh)
    n_bad = int((~finite).sum())
    if n_bad == 0:
        return target, 0
    mean = total / n_ok.clamp(min=1)
    fill = torch.where(n_ok > 0, mean, torch.zeros_like(mean))
    return torch.where(finite, target, fill.to(target.dtype)), n_bad


def degradation_ladder(configured: str, budget: int) -> list[str]:
    """The trainers to retry with after ``configured`` produced a non-finite
    date, most capable first, at most ``budget`` rungs; ``final_solve`` has no
    rung below it (the ladder is empty and the walk raises on the first event)."""
    if configured not in TRAINER_LADDER:
        raise ValueError(f"unknown trainer {configured!r}; ladder is {TRAINER_LADDER}")
    start = TRAINER_LADDER.index(configured) + 1
    return list(TRAINER_LADDER[start:start + max(budget, 0)])


def record_nan_event(date_t: int, trainer: str, where: str) -> None:
    """One non-finite detection: the ``guard/nan_event`` counter (a no-op
    without a telemetry session) and a warning (which untelemetered runs see
    too)."""
    obs_count("guard/nan_event", date=str(date_t), trainer=trainer, where=where)
    warnings.warn(
        f"guard: non-finite {where} at backward date {date_t} under trainer {trainer!r} — "
        f"degrading per ladder {TRAINER_LADDER}", stacklevel=3)


def record_degrade(date_t: int, to_trainer: str) -> None:
    """One rung taken at ``date_t``: the ``guard/degrade`` counter (a no-op
    without a telemetry session)."""
    obs_count("guard/degrade", date=str(date_t), to=to_trainer)
