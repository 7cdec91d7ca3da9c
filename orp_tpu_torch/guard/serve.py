"""Serving-side resilience policy: deadlines, shedding, retries, breakers
(counterpart of ``orp_tpu/guard/serve.py``).

The serve tier's failure modes and their governed responses:

==============================  =============================================
failure mode                    response (and its obs signal)
==============================  =============================================
slow request head-of-line-      per-request deadlines: a request whose queue
blocks the single worker        age passes its deadline is SHED with a
                                structured :class:`Rejection`, not served
                                late (``guard/shed{reason="deadline"}``)
queue grows without bound       admission watermark: past ``queue_watermark``
under overload                  pending rows, the earliest-deadline request
                                is shed at submit time
                                (``guard/shed{reason="watermark"}``)
transient dispatch failure      bounded retry with exponential backoff
(device hiccup, injected)       around the engine call
                                (``guard/retry{site="serve/dispatch"}``)
a bucket hangs past its wall    the stuck-dispatch watchdog force-fails the
                                batch (``serve/health.py``) and counts the
                                hang on the engine's :class:`CircuitBreaker`
                                (``guard/circuit_open``)
==============================  =============================================

Everything here is opt-in: a batcher constructed without a
:class:`GuardPolicy` runs the unguarded code path.
"""

from __future__ import annotations

import dataclasses
import threading

from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight


class TransientDispatchError(RuntimeError):
    """A dispatch failure worth retrying: the request itself is fine, the
    attempt failed (device hiccup, injected fault). Anything NOT of this
    type propagates to the caller's future unchanged — retrying a
    deterministic error just repeats it with latency."""


class DeviceLostError(RuntimeError):
    """A device fell out of the topology mid-dispatch. NOT transient —
    retrying on the same engine just re-dispatches onto a mesh that no
    longer exists. The recovery is structural: drain, rebuild the engine on
    the largest surviving submesh, replay.

    ``survivors`` is the device count the runtime reported alive (None when
    the failure carried no count).
    """

    def __init__(self, msg: str = "device lost", survivors: int | None = None):
        super().__init__(msg)
        self.survivors = survivors


class WatchdogTrip(TransientDispatchError):
    """A stuck-dispatch watchdog force-failed a batch that exceeded its hard
    wall (``GuardPolicy.hard_wall_ms``; ``serve/health.py``). Transient by
    design: the trip feeds the engine's circuit breaker, and the batcher's
    bounded block-time retry re-dispatches the same rows."""


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A structured shed decision delivered THROUGH a request's future (its
    ``result()`` — not an exception: shedding is the policy working as
    configured, and an exception-shaped response would page someone for a
    decision the operator already made).

    Callers under a deadline policy check ``is_rejection(result)`` before
    unpacking ``(phi, psi, value)``.
    """

    reason: str           # "deadline" | "watermark" | "quota" (multi-tenant
    # host: the tenant is over its in-flight budget, serve/host.py)
    queued_s: float       # how long the request waited before the decision
    deadline_s: float | None  # its deadline budget (None: shed by watermark
    # or quota while carrying no deadline of its own)


def is_rejection(result) -> bool:
    """True when a batcher future resolved to a shed decision instead of a
    ``(phi, psi, value)`` evaluation."""
    return isinstance(result, Rejection)


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Resilience policy for a :class:`~orp_tpu_torch.serve.batcher.MicroBatcher`.

    ``deadline_ms``     — default per-request deadline (queue age budget);
                          ``submit(..., deadline_s=...)`` overrides per
                          request; None = requests never expire.
    ``queue_watermark`` — max pending ROWS before admission control sheds
                          the earliest-deadline request (a single-row
                          request is one row; a columnar block counts its
                          rows, and an over-watermark block sheds its own
                          tail as a slice); None = unbounded.
    ``max_retries``     — retries around one engine dispatch for
                          :class:`TransientDispatchError` (0 = off).
    ``backoff_ms``      — first retry backoff; doubles per attempt, capped
                          at ``backoff_cap_ms``. Kept small: the batcher
                          worker sleeps through it, so backoff IS added
                          latency for everything queued behind.
    ``hard_wall_ms``    — stuck-dispatch watchdog (``serve/health.py``): a
                          dispatched batch whose device block exceeds this
                          wall is FORCE-FAILED with :class:`WatchdogTrip`
                          (the waiter is abandoned — a truly hung
                          launch never returns), the trip feeds the
                          engine's circuit breaker, and the batch gets
                          one block-time retry when ``max_retries`` allows.
                          None = no watchdog (the pre-degradation path).
    """

    deadline_ms: float | None = None
    queue_watermark: int | None = None
    max_retries: int = 0
    backoff_ms: float = 1.0
    backoff_cap_ms: float = 20.0
    hard_wall_ms: float | None = None

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms={self.deadline_ms} must be > 0")
        if self.hard_wall_ms is not None and self.hard_wall_ms <= 0:
            raise ValueError(f"hard_wall_ms={self.hard_wall_ms} must be > 0")
        if self.queue_watermark is not None and self.queue_watermark < 1:
            raise ValueError(
                f"queue_watermark={self.queue_watermark} must be >= 1")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), seconds."""
        return min(self.backoff_ms * (2 ** (attempt - 1)),
                   self.backoff_cap_ms) / 1e3


class CircuitBreaker:
    """Consecutive-failure breaker over keyed resources (buckets).

    ``record_failure(key)`` returns True when the key just TRIPPED (crossed
    ``threshold`` consecutive failures) — the caller demotes the resource
    and the breaker emits ``guard/circuit_open``. A success resets the
    key's streak: transient flakes never accumulate into a demotion.
    Thread-safe; trip fires once per key.
    """

    def __init__(self, threshold: int = 3, *, what: str = "aot_bucket"):
        if threshold < 1:
            raise ValueError(f"threshold={threshold} must be >= 1")
        self.threshold = int(threshold)
        self.what = what
        self._lock = threading.Lock()
        self._streak: dict = {}
        self._open: set = set()

    def record_success(self, key) -> None:
        with self._lock:
            self._streak.pop(key, None)

    def record_failure(self, key) -> bool:
        with self._lock:
            if key in self._open:
                return False
            n = self._streak.get(key, 0) + 1
            self._streak[key] = n
            if n < self.threshold:
                return False
            self._open.add(key)
        obs_count("guard/circuit_open", **{self.what: str(key)})
        flight.record("circuit_open", key=str(key), what=self.what,
                      threshold=self.threshold)
        return True

    def is_open(self, key) -> bool:
        with self._lock:
            return key in self._open

    @property
    def open_keys(self) -> list:
        with self._lock:
            # key=str: exec-failure keys are bucket ints, hang streaks are
            # "hang:<bucket>" strings — a mixed set must still sort
            return sorted(self._open, key=str)
