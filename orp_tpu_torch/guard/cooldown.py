"""Cool-down / escalating-backoff gate for expensive reactive actions (a copy of
``orp_tpu/guard/cooldown.py``).

The serving guards (``guard/serve.py``) bound RETRY storms: milliseconds
between re-dispatches of one request. This is the same discipline one layer
up, for actions that cost minutes — a model retrain, a fleet rebalance — where
the failure mode is a FLAPPING signal (a drift monitor tripping on every
block, a calibration window oscillating across its band) triggering the
action in a loop. One :class:`Cooldown` per action:

- after a fire, the gate closes for ``cooldown_s``;
- a rejected outcome ESCALATES the window (x ``backoff`` per consecutive
  reject, capped at ``max_backoff_s``) — a candidate the canary keeps
  rejecting is evidence the signal is wrong, so each retry gets strictly
  more expensive;
- a promoted outcome resets the escalation to the base window.

Time is an injected ``clock`` callable (default ``time.monotonic``) so the
chaos suite drives the schedule deterministically — no sleeps. Thread-safe:
the trigger sources and the pilot controller may consult one gate from
different threads.
"""

from __future__ import annotations

import threading
import time


class Cooldown:
    """Deterministic cool-down with reject-escalated backoff (module doc)."""

    def __init__(self, *, cooldown_s: float = 300.0, backoff: float = 2.0,
                 max_backoff_s: float = 3600.0, clock=time.monotonic):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s={cooldown_s} must be >= 0")
        if backoff < 1.0:
            raise ValueError(f"backoff={backoff} must be >= 1 (an escalation "
                             "factor below 1 would reward rejection)")
        self.cooldown_s = float(cooldown_s)
        self.backoff = float(backoff)
        self.max_backoff_s = float(max_backoff_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._window = self.cooldown_s
        self._closed_until: float | None = None
        self._rejects = 0

    def ready(self) -> bool:
        """True when the gate is open (no fire yet, or the window elapsed)."""
        return self.remaining() == 0.0

    def remaining(self) -> float:
        """Seconds until the gate opens (0.0 = open now)."""
        with self._lock:
            if self._closed_until is None:
                return 0.0
            return max(0.0, self._closed_until - self._clock())

    def note_fire(self) -> None:
        """The action started: close the gate for the current window."""
        with self._lock:
            self._closed_until = self._clock() + self._window

    def note_reject(self) -> None:
        """The action's outcome was rejected: escalate the window and re-arm
        from now — the next attempt waits strictly longer."""
        with self._lock:
            self._rejects += 1
            self._window = min(self._window * self.backoff,
                               self.max_backoff_s)
            self._closed_until = self._clock() + self._window

    def note_promote(self) -> None:
        """The action succeeded: reset the escalation to the base window
        (the base cool-down armed by ``note_fire`` keeps running)."""
        with self._lock:
            self._rejects = 0
            self._window = self.cooldown_s

    def snapshot(self) -> dict:
        """Current gate state, for journals and ``orp pilot status``."""
        with self._lock:
            now = self._clock()
            return {
                "window_s": self._window,
                "consecutive_rejects": self._rejects,
                "remaining_s": (0.0 if self._closed_until is None
                                else max(0.0, self._closed_until - now)),
            }
