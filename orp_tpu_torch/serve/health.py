"""Serving health, first part: the stuck-dispatch watchdog (counterpart of
``orp_tpu/serve/health.py``'s :class:`DispatchWatchdog`).

Every handled serve fault raises (transient dispatch errors, injected
faults). A wedged launch raises nothing: the result copy simply never
returns, the resolve stage stops resolving, and every queued request ages out
behind it. :class:`DispatchWatchdog` bounds the wait: a batch that exceeds
``GuardPolicy.hard_wall_ms`` is FORCE-FAILED with
:class:`~orp_tpu_torch.guard.WatchdogTrip` (``guard/watchdog_trip``), the
trip feeds the engine's circuit breaker (``HedgeEngine.watchdog_trip``), and
the batcher's bounded block-time retry re-dispatches the rows. The waiter
thread that was blocked is ABANDONED: a CUDA launch cannot be cancelled, so
"force-fail" honestly means "stop waiting, leak the waiter", which is also why
the watchdog is opt-in.

The rest of the JAX package's module (``doctor_report`` and the fleet
checks) comes with the network and fleet plane.
"""

from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as _FutureTimeoutError

from orp_tpu_torch.guard.serve import WatchdogTrip
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight


class _BlockWorker:
    """One daemon thread running blocking reads on the watchdog's behalf.

    The resolve stage hands it ``fn`` (a device block) and waits on the
    returned future with the hard-wall timeout; an abandoned worker (its
    current ``fn`` hung) finishes or leaks with the hang — either way it
    never touches a live watchdog again."""

    __slots__ = ("_q", "thread", "dead")

    def __init__(self):
        import queue

        self._q = queue.SimpleQueue()
        self.dead = False
        self.thread = threading.Thread(
            target=self._run, name="orp-serve-watchdog", daemon=True)
        self.thread.start()

    def submit(self, fn):
        from orp_tpu_torch.serve.batcher import SlimFuture

        fut = SlimFuture()
        self._q.put((fn, fut))
        return fut

    def abandon(self):
        self.dead = True
        self._q.put(None)  # wakes an idle worker; a hung one exits on return

    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self.dead:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — delivered through the future
                fut.set_exception(e)
            if self.dead:
                return


class DispatchWatchdog:
    """Bound the resolve-stage block on an in-flight batch by a hard wall.

    ``block(fn, tag)`` runs ``fn()`` (the pending batch's blocking result
    read) on a helper thread and waits at most ``hard_wall_ms``. Inside the
    wall it is transparent — the result or exception propagates unchanged,
    and ``on_ok(tag)`` resets any hang streak. Past the wall it force-fails:
    emits ``guard/watchdog_trip``, feeds ``on_trip(tag)`` (the engine's
    circuit-breaker hook, ``HedgeEngine.watchdog_trip``), abandons the stuck
    helper and
    raises :class:`WatchdogTrip` (a ``TransientDispatchError``: the
    batcher's block-time retry policy applies).

    One watchdog serves one batcher — the resolve stage is sequential, so
    a single helper thread is enough until a trip orphans it.
    """

    def __init__(self, hard_wall_ms: float, *, on_trip=None, on_ok=None):
        if hard_wall_ms <= 0:
            raise ValueError(f"hard_wall_ms={hard_wall_ms} must be > 0")
        self.hard_wall_s = float(hard_wall_ms) / 1e3
        self.on_trip = on_trip
        self.on_ok = on_ok
        self.trips = 0
        self._lock = threading.Lock()
        self._worker: _BlockWorker | None = None

    def block(self, fn, tag=None):
        with self._lock:
            w = self._worker
            if w is None or w.dead:
                w = _BlockWorker()
                self._worker = w
        fut = w.submit(fn)
        try:
            out = fut.result(timeout=self.hard_wall_s)
        except _FutureTimeoutError:
            with self._lock:
                self.trips += 1
                if self._worker is w:
                    self._worker = None
            w.abandon()
            obs_count("guard/watchdog_trip", key=str(tag))
            flight.record("watchdog_trip", tag=str(tag),
                          hard_wall_ms=self.hard_wall_s * 1e3,
                          trips=self.trips)
            if self.on_trip is not None:
                self.on_trip(tag)
            raise WatchdogTrip(
                f"in-flight batch (tag={tag}) exceeded the "
                f"{self.hard_wall_s * 1e3:.0f}ms dispatch hard wall; "
                "force-failed (the stuck waiter is abandoned)"
            ) from None
        if self.on_ok is not None:
            self.on_ok(tag)
        return out

    def close(self):
        with self._lock:
            w, self._worker = self._worker, None
        if w is not None:
            w.abandon()
