"""Deterministic, seed-driven fault injection for the backward walk (the walk's part of ``orp_tpu/guard/inject.py``).

The guard's proofs drive the real walk through these hooks:

- ``corrupt_target``: NaN-poison a fraction of a date's fit target (proves the
  NaN sentinel and the trainer ladder). The rows come from
  ``np.random.default_rng(plan.seed).choice(n, k, replace=False)``, as the JAX
  package draws them, so both packages poison the same rows for one plan;
- ``kill_after_step``: raise :class:`WalkKilled` right after date ``k``'s
  checkpoint is saved (proves kill-and-resume equality);
- ``corrupt_bytes``: flip seeded bytes of a blob (proves checkpoint tamper
  detection).

Hooks fire only while a plan is installed (``with faults(plan):``); the clean
path pays one module-global load per hook site. The serve-site faults of the
JAX package (``fail``, ``delay``, ``device_loss`` and the rest) wait for the
port's serve planes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch


class WalkKilled(RuntimeError):
    """Synthetic process death after a per-date checkpoint committed: the
    directory holds exactly what a real kill at that point leaves."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject into the walk."""

    seed: int = 0
    nan_dates: frozenset[int] = frozenset()  # walk step indices (0 = the latest date)
    nan_frac: float = 0.01                   # fraction of the target's rows poisoned
    kill_after_step: int | None = None       # raise WalkKilled after this step's save


class FaultInjector:
    """One installed :class:`FaultPlan` and its deterministic state; ``log``
    records every injected fault as ``(site, detail)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: list[tuple[str, str]] = []
        self._rng = np.random.default_rng(plan.seed)
        self._lock = threading.Lock()

    def corrupt_target(self, step_i: int, target: torch.Tensor) -> torch.Tensor:
        """``target`` with NaN in the plan's rows when ``step_i`` is a NaN date
        (a new tensor: the caller's ledger column stays clean); else ``target``."""
        if step_i not in self.plan.nan_dates:
            return target
        n = int(target.shape[0])
        k = max(1, int(round(self.plan.nan_frac * n)))
        with self._lock:
            rows = np.sort(self._rng.choice(n, size=k, replace=False))
            self.log.append(("train/fit_target", f"step={step_i} rows={k}"))
        mask = np.zeros(n, bool)
        mask[rows] = True
        return torch.where(torch.from_numpy(mask).to(target.device),
                           torch.full((), float("nan"), dtype=target.dtype,
                                      device=target.device), target)

    def maybe_kill(self, step_i: int) -> None:
        """Raise :class:`WalkKilled` if the plan schedules death after this step
        (called after the step's checkpoint committed)."""
        if self.plan.kill_after_step == step_i:
            with self._lock:
                self.log.append(("train/kill", f"step={step_i}"))
            raise WalkKilled(f"injected process death after backward step {step_i} "
                             "(checkpoint for this date is already on disk)")

    def corrupt_bytes(self, blob: bytes, n_flips: int = 8) -> bytes:
        """Flip ``n_flips`` seeded byte positions of ``blob``."""
        if not blob:
            return blob
        buf = bytearray(blob)
        with self._lock:
            pos = self._rng.choice(len(buf), size=min(n_flips, len(buf)), replace=False)
            self.log.append(("artifact/corrupt", f"bytes={len(pos)}"))
        for p in pos:
            buf[p] ^= 0xFF
        return bytes(buf)


_ACTIVE: FaultInjector | None = None


def active() -> FaultInjector | None:
    """The installed injector, or None (the clean path)."""
    return _ACTIVE


@contextlib.contextmanager
def faults(plan: FaultPlan):
    """Install ``plan`` for the scope and yield its injector; plans do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already installed; chaos plans do not nest")
    inj = FaultInjector(plan)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = None
