"""Deterministic, seed-driven fault injection for the backward walk and the serve
path (counterpart of ``orp_tpu/guard/inject.py``).

The guard's proofs drive the real walk and the real serve path through these
hooks:

- ``corrupt_target``: NaN-poison a fraction of a date's fit target (proves the
  NaN sentinel and the trainer ladder). The rows come from
  ``np.random.default_rng(plan.seed).choice(n, k, replace=False)``, as the JAX
  package draws them, so both packages poison the same rows for one plan;
- ``kill_after_step``: raise :class:`WalkKilled` right after date ``k``'s
  checkpoint is saved (proves kill-and-resume equality);
- ``corrupt_bytes``: flip seeded bytes of a blob (proves checkpoint tamper
  detection);
- ``fail(site)``: raise :class:`InjectedFault` (a transient dispatch error)
  for the first ``n`` calls at a site (proves retry-with-backoff);
- ``delay(site)``: sleep a fixed, small duration for the first ``n`` calls
  (proves deadlines and shedding; a delay at ``serve/execute`` past
  ``GuardPolicy.hard_wall_ms`` is the watchdog's hung launch);
- ``device_loss(site)``: raise :class:`InjectedDeviceLoss` (structural,
  carries the surviving device count) for the first ``n`` calls;
- ``corrupt_reload``: perturb one param leaf of an already-loaded policy
  (corruption the on-disk checks cannot see; proves the hot-reload canary
  gate, ``serve/host.py``).

Serve sites: ``serve/dispatch`` in ``HedgeEngine.evaluate_async`` and
``evaluate_mixed_async``, ``serve/execute`` in ``PendingEval.result``,
``serve/bundle_reload`` in ``ServeHost.reload_tenant``.

Wire faults, with the gateway (``serve/gateway.py``, ``serve/client.py``):

- ``torn_send(site)``: write half a frame, then kill the socket (the gateway
  discards the partial; the resilient client's replay re-delivers it);
- ``stall_send(site)``: write half a frame and hold the socket open and
  silent for a fixed time (the gateway's ``frame_deadline_s`` evicts it);
- ``gateway_kill(n)``: abort the whole gateway right after its ``n``-th
  admitted frame (``kill_gateway_at_frame``, one-shot: the restarted
  gateway's own counter passes ``n`` too);
- ``fail`` at ``gateway/reply``: the gateway closes the connection instead of
  sending the reply it just cached, so the replay is answered from the cache.

Wire sites: ``client/send`` in ``ResilientGatewayClient``, ``gateway/reply``
and the admitted-frame counter in ``ServeGateway``.

Hooks fire only while a plan is installed (``with faults(plan):``); the clean
path pays one module-global load per hook site. Per-site call counters advance
under one lock, so the fault sequence is a deterministic function of the call
order. The walk's faults draw from the plan's generator exactly as before:
the site counters draw nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from orp_tpu_torch.guard.serve import DeviceLostError, TransientDispatchError


class InjectedFault(TransientDispatchError):
    """A synthetic transient failure (retryable by construction)."""


class InjectedDeviceLoss(DeviceLostError):
    """A synthetic device loss (structural: recovery means resharding, not
    retrying)."""


class WalkKilled(RuntimeError):
    """Synthetic process death after a per-date checkpoint committed: the
    directory holds exactly what a real kill at that point leaves."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject, where, how often."""

    seed: int = 0
    nan_dates: frozenset[int] = frozenset()  # walk step indices (0 = the latest date)
    nan_frac: float = 0.01                   # fraction of the target's rows poisoned
    kill_after_step: int | None = None       # raise WalkKilled after this step's save
    # site faults: site -> how many of its first calls fail / are delayed
    fail: dict[str, int] = dataclasses.field(default_factory=dict)
    delay: dict[str, tuple[int, float]] = dataclasses.field(
        default_factory=dict)  # site -> (n_calls, seconds)
    # site -> first n calls raise InjectedDeviceLoss reporting `survivors`
    device_loss: dict[str, int] = dataclasses.field(default_factory=dict)
    survivors: int | None = None
    # the first n corrupt_policy() calls perturb the loaded params
    corrupt_reload: int = 0
    # wire faults: site -> first n sends write half the frame then kill the
    # socket (torn) / hold it open silently for `secs` (stalled reader)
    torn_send: dict[str, int] = dataclasses.field(default_factory=dict)
    stall_send: dict[str, tuple[int, float]] = dataclasses.field(
        default_factory=dict)  # site -> (n_calls, seconds held open)
    # abort the whole gateway right after its n-th admitted frame (None = never)
    kill_gateway_at_frame: int | None = None


class FaultInjector:
    """One installed :class:`FaultPlan` and its deterministic state; ``log``
    records every injected fault as ``(site, detail)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: list[tuple[str, str]] = []
        self._rng = np.random.default_rng(plan.seed)
        self._lock = threading.Lock()
        self._site_calls: dict[str, int] = {}

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

    def _take(self, site: str, budget: int) -> int | None:
        """Consume one call at ``site``: its 0-based index when inside
        ``budget``, else None."""
        with self._lock:
            i = self._site_calls.get(site, 0)
            self._site_calls[site] = i + 1
            return i if i < budget else None

    def fire(self, site: str, **attrs) -> None:
        """One production call passed ``site``: sleep and/or raise per the
        plan. Delay comes before failure (a slow, then failing dependency);
        device loss outranks a transient failure."""
        n_delay, secs = self.plan.delay.get(site, (0, 0.0))
        if n_delay and self._take(f"delay:{site}", n_delay) is not None:
            with self._lock:
                self.log.append((site, f"delay {secs * 1e3:.0f}ms {attrs}"))
            time.sleep(secs)
        n_lost = self.plan.device_loss.get(site, 0)
        if n_lost and self._take(f"device_loss:{site}", n_lost) is not None:
            with self._lock:
                self.log.append((site, f"device_loss survivors={self.plan.survivors} {attrs}"))
            raise InjectedDeviceLoss(f"injected device loss at {site} {attrs}",
                                     survivors=self.plan.survivors)
        n_fail = self.plan.fail.get(site, 0)
        if n_fail and self._take(f"fail:{site}", n_fail) is not None:
            with self._lock:
                self.log.append((site, f"fail {attrs}"))
            raise InjectedFault(f"injected fault at {site} {attrs}")

    def torn_send(self, site: str) -> bool:
        """True when this send should tear: write half the frame, then kill
        the socket (the caller's contract, ``serve/client.py``)."""
        budget = self.plan.torn_send.get(site, 0)
        if not budget or self._take(f"torn:{site}", budget) is None:
            return False
        with self._lock:
            self.log.append((site, "torn"))
        return True

    def stall_send(self, site: str) -> float | None:
        """Seconds to hold a half-written frame open and silent, or None when
        this send is clean."""
        n, secs = self.plan.stall_send.get(site, (0, 0.0))
        if not n or self._take(f"stall:{site}", n) is None:
            return None
        with self._lock:
            self.log.append((site, f"stall {secs * 1e3:.0f}ms"))
        return secs

    def gateway_kill(self, frame_no: int) -> bool:
        """True exactly once, when ``frame_no`` (the gateway's admitted-frame
        counter) is the planned kill point: the caller aborts the gateway."""
        k = self.plan.kill_gateway_at_frame
        if k is None or frame_no != k:
            return False
        if self._take("gateway_kill", 1) is None:
            return False
        with self._lock:
            self.log.append(("gateway/kill", f"frame={frame_no}"))
        return True

    def corrupt_policy(self, policy):
        """For the first ``plan.corrupt_reload`` calls, a copy of ``policy``
        with one params leaf perturbed (its first element ``x * 1.25 +
        0.25``: finite and bit-visible); later calls return ``policy``
        untouched. The caller's policy is never mutated, so a rollback still
        has clean bits to serve."""
        if not self.plan.corrupt_reload:
            return policy
        if self._take("corrupt_reload", self.plan.corrupt_reload) is None:
            return policy
        bw = policy.backward
        names = sorted(bw.params1_by_date)  # the order of a flattened params dict
        with self._lock:
            li = int(self._rng.integers(len(names)))
            self.log.append(("serve/bundle_reload", f"leaf={li}"))
        leaf = bw.params1_by_date[names[li]]
        bad = leaf.clone() if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.array(leaf, copy=True))
        flat = bad.view(-1)
        flat[0] = flat[0] * 1.25 + 0.25
        bad_bw = dataclasses.replace(bw, params1_by_date={**bw.params1_by_date,
                                                         names[li]: bad})
        return dataclasses.replace(policy, backward=bad_bw)

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
