"""Device-time attribution: split host-blocked walls into queue vs device (counterpart of the attribution core of ``orp_tpu/obs/devprof.py``).

A span's wall conflates three bills: the Python and launch work before the
wait, the time a launch sat QUEUED behind earlier work on the card's
(serial) stream, and the card EXECUTING it. This module is the flag-gated
profiling mode that separates them:

- :func:`enable` / :func:`profiling` switch attribution on process-wide;
  disabled is the default and costs one module-global load and an ``is
  None`` test a site (the ``obs.spans`` discipline);
- :class:`DevProf` is a serial-device completion chain. Each launch stamps
  its submit instant; at completion the device window is ``[max(t_dispatch,
  previous_completion), t_done]``: on a serial device a launch cannot start
  before its predecessor completes, so ``device_s = t_done - start`` and
  ``queue_s = start - t_dispatch`` partition the dispatch-to-done wall
  exactly (``queue_s + device_s == t_done - t_dispatch``). Per-bucket device
  and queue seconds land in ``serve/device_seconds{bucket}`` and
  ``serve/queue_wait_seconds{bucket}`` on the active session's registry and
  in the DevProf's own bounded windows (:meth:`DevProf.bucket_stats`,
  readable with no session);
- a rolling device-utilization gauge (``serve/device_utilization``): busy
  device seconds over the trailing horizon;
- the obs :class:`~orp_tpu_torch.obs.spans.Span` consults :func:`active`
  at its wait: with attribution on, every span event also carries
  ``host_s`` (span open to the wait: Python and launches) and ``device_s``
  (the waited tail), summing to ``dur_s`` exactly. The fused walk is one
  span, so it splits as a whole.

On the card ``serve/engine.PendingEval.result`` waits for the device before
it copies the rows back, so the completion instant is the device's, not the
copy's. The JAX package's ``orp profile`` workloads (``profile_north_star``,
``profile_serve``, ``profile_run``) are not ported (they need ``aot/`` and
``obs/perf.py``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

#: samples retained per bucket window — enough for a bench phase's medians,
#: bounded so an always-on server never grows
_WINDOW = 4096


class DevProf:
    """Serial-device completion-chaining attribution (see module docstring).

    Thread-safe: the batcher's resolve stage and direct ``evaluate`` callers
    may complete dispatches concurrently; the chain advances under one lock.
    """

    def __init__(self, *, horizon_s: float = 30.0):
        self.horizon_s = float(horizon_s)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_complete = self._t0
        # rolling (completion_instant, device_s) window for the util gauge,
        # with the busy sum maintained INCREMENTALLY: the per-completion
        # bill must stay O(1), not O(window)
        self._busy: collections.deque = collections.deque(maxlen=_WINDOW)
        self._busy_sum = 0.0
        # completion instant of the last sample the CAP (not the horizon)
        # evicted: the retained window then only represents time after it,
        # and utilization must shrink its denominator to match — dividing
        # a 4096-sample window by the full horizon under sustained load
        # would underreport a busy device by the drop ratio
        self._cap_evicted_t: float | None = None
        # per-bucket bounded device/queue second windows, session-independent
        self._device: dict[str, collections.deque] = {}
        self._queue: dict[str, collections.deque] = {}
        self.completions = 0
        # cached session-registry instrument handles, keyed by bucket and
        # invalidated when the obs session changes: registry interning
        # (sorted label tuples under the registry lock) per completion
        # would dominate the per-dispatch bill
        self._instr_state = None
        self._instr: dict[str, tuple] = {}

    def complete(self, t_dispatch: float, t_block_start: float,
                 *, bucket=None) -> tuple[float, float]:
        """One dispatch finished NOW: attribute its wall. Returns
        ``(queue_s, device_s)`` with ``queue_s + device_s == now -
        t_dispatch`` exactly (the serial-device partition). ``t_block_start``
        is recorded for honesty (the host-blocked portion is ``now -
        t_block_start``) but the attribution keys on the dispatch instant —
        the device was working whether or not the host was watching."""
        t_done = time.perf_counter()
        key = str(bucket)
        with self._lock:
            start = min(max(t_dispatch, self._last_complete), t_done)
            device_s = t_done - start
            queue_s = start - t_dispatch
            self._last_complete = t_done
            self.completions += 1
            if len(self._busy) == self._busy.maxlen:
                # about to roll off the CAP: remember its instant so the
                # utilization denominator covers only the retained span
                self._cap_evicted_t = self._busy[0][0]
                self._busy_sum -= self._busy[0][1]
            self._busy.append((t_done, device_s))
            self._busy_sum += device_s
            cutoff = t_done - self.horizon_s
            while self._busy and self._busy[0][0] < cutoff:
                self._busy_sum -= self._busy.popleft()[1]
            dq = self._device.get(key)
            if dq is None:
                dq = self._device[key] = collections.deque(maxlen=_WINDOW)
                self._queue[key] = collections.deque(maxlen=_WINDOW)
            dq.append(device_s)
            self._queue[key].append(queue_s)
        # session mirror: registry-only histograms (no sink event per
        # dispatch) + the live utilization gauge, through handles cached per
        # (session, bucket)
        from orp_tpu_torch.obs.spans import state

        st = state()
        if st is not None:
            if st is not self._instr_state:
                self._instr_state = st
                self._instr = {}
            handles = self._instr.get(key)
            if handles is None:
                labels = {"bucket": key}
                handles = self._instr[key] = (
                    st.registry.histogram("serve/device_seconds", labels),
                    st.registry.histogram("serve/queue_wait_seconds",
                                          labels),
                    st.registry.gauge("serve/device_utilization"),
                )
            handles[0].observe(device_s)
            handles[1].observe(queue_s)
            # decimated: the gauge is a dashboard series, not a ledger —
            # every 16th completion (and the first) keeps it fresh without
            # putting the utilization fold on every dispatch
            if self.completions % 16 == 1:
                handles[2].set(round(self.utilization(), 6))
        return queue_s, device_s

    def utilization(self) -> float:
        """Busy device seconds over the trailing horizon (0..~1; >1 is
        impossible by construction — the chain serializes windows)."""
        now = time.perf_counter()
        with self._lock:
            cutoff = now - self.horizon_s
            while self._busy and self._busy[0][0] < cutoff:
                self._busy_sum -= self._busy.popleft()[1]
            busy = max(self._busy_sum, 0.0)
            elapsed = min(self.horizon_s, now - self._t0)
            if (self._cap_evicted_t is not None
                    and self._cap_evicted_t >= cutoff):
                # the sample cap truncated the window inside the horizon:
                # the retained completions only describe [evicted, now]
                elapsed = min(elapsed, now - self._cap_evicted_t)
        return busy / elapsed if elapsed > 0 else 0.0

    def bucket_stats(self) -> dict:
        """Per-bucket attribution summary from the bounded windows:
        ``{bucket: {count, device_s_median, device_s_total, queue_s_median}}``
        — readable with NO telemetry session."""
        import numpy as np

        out = {}
        with self._lock:
            items = [(k, list(v), list(self._queue[k]))
                     for k, v in self._device.items()]
        for key, dev, que in items:
            if not dev:
                continue
            q25, q75 = np.percentile(dev, [25.0, 75.0])
            out[key] = {
                "count": len(dev),
                "device_s_median": float(np.median(dev)),
                # the window's spread beside its median
                "device_s_iqr": float(q75 - q25),
                "device_s_total": float(np.sum(dev)),
                "queue_s_median": float(np.median(que)),
            }
        return out


_STATE: DevProf | None = None


def enable(*, horizon_s: float = 30.0) -> DevProf:
    """Switch device-time attribution on process-wide."""
    global _STATE
    _STATE = DevProf(horizon_s=horizon_s)
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def active() -> DevProf | None:
    """The live attribution state, or None — the disabled path is one
    module-global load + ``is None`` test (the spans discipline)."""
    return _STATE


@contextlib.contextmanager
def profiling(*, horizon_s: float = 30.0):
    """``enable``/``disable`` as a scope; yields the :class:`DevProf`.
    Restores any previously-installed state on exit (benches nest)."""
    global _STATE
    prev = _STATE
    prof = DevProf(horizon_s=horizon_s)
    _STATE = prof
    try:
        yield prof
    finally:
        _STATE = prev
