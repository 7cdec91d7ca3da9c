"""Serving metrics: latency percentiles + throughput counters (counterpart of
``orp_tpu/serve/metrics.py``).

A thin facade over ``orp_tpu_torch.obs`` registry instruments: a bounded
``Histogram`` for the latency window and ``Counter``s for lifetime request,
row and dispatch counts, so serving observables live in the same exportable
registry as every other metric (Prometheus text / JSONL via ``obs/sink.py``).
``record(latency_s, n_rows)`` takes DEVICE-COMPLETE latencies (the engine's
result copy waits for the card before the caller's clock stops),
``record_dispatch`` counts each coalesced device dispatch (occupancy and
dispatches-per-request gauges), and ``summary()`` returns one flat dict.

By default each instance owns a private registry; to publish into a
telemetry bundle, pass the active session's registry
(``registry=obs.state().registry``) and distinguishing ``labels``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from orp_tpu_torch.obs.registry import Registry

LATENCY_HISTOGRAM = "serve_request_latency_seconds"
REQUESTS_COUNTER = "serve_requests_total"
ROWS_COUNTER = "serve_rows_total"
DISPATCHES_COUNTER = "serve_dispatches_total"
OCCUPANCY_GAUGE = "serve_batch_occupancy"
DISPATCHES_PER_REQUEST_GAUGE = "serve_dispatches_per_request"


class ServingMetrics:
    """Thread-safe latency/throughput recorder shared by engine callers and
    the micro-batcher worker. ``window`` bounds the retained latency samples
    (percentiles reflect the most recent that many requests)."""

    def __init__(self, *, window: int = 65536,
                 registry: Registry | None = None,
                 labels: dict[str, str] | None = None):
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
        self._window = int(window)
        self.registry = registry if registry is not None else Registry()
        self._hist = self.registry.histogram(
            LATENCY_HISTOGRAM, labels, window=self._window)
        self._requests = self.registry.counter(REQUESTS_COUNTER, labels)
        self._rows = self.registry.counter(ROWS_COUNTER, labels)
        # dispatch-amortisation observables (the "26 dispatches for 256
        # requests" pathology as first-class numbers): how many device
        # dispatches the recorded traffic cost, the fraction of each
        # dispatched bucket that carried real rows, and the running
        # dispatches-per-request ratio (1.0 = no coalescing at all;
        # the continuous batcher should hold it well under 0.1 on bursts)
        self._dispatches = self.registry.counter(DISPATCHES_COUNTER, labels)
        self._occupancy = self.registry.gauge(OCCUPANCY_GAUGE, labels)
        self._dpr = self.registry.gauge(DISPATCHES_PER_REQUEST_GAUGE, labels)
        self._dispatch_rows = 0
        self._dispatch_capacity = 0
        # façade lock: record()/summary() take it around ALL their instrument
        # touches, preserving the original one-lock atomicity (a concurrent
        # summary never sees requests=N+1 with N window samples). The
        # instruments' own locks nest inside — ordering is always façade ->
        # instrument, so no deadlock.
        self._lock = threading.Lock()
        # fresh instruments start at zero, so construction does NOT reset:
        # a second façade over the same shared-registry series ACCUMULATES
        # into it (the counter-natural semantics) instead of silently wiping
        # what the first one recorded. reset() stays for explicit wipes.
        self._t_first: float | None = None
        self._t_last: float | None = None

    def reset(self) -> None:
        with self._lock:
            self._hist.reset()
            self._requests.reset()
            self._rows.reset()
            self._dispatches.reset()
            self._occupancy.set(0.0)
            self._dpr.set(0.0)
            self._dispatch_rows = 0
            self._dispatch_capacity = 0
            self._t_first = None
            self._t_last = None

    def record(self, latency_s: float, n_rows: int = 1) -> None:
        now = time.perf_counter()
        with self._lock:
            self._record_locked(now, latency_s, n_rows)

    def record_many(self, samples) -> None:
        """Bulk-record ``(latency_s, n_rows)`` pairs under ONE lock pass per
        instrument — the continuous batcher resolves a whole coalesced
        batch at once, and per-request lock churn would put the recorder in
        the hot path it is measuring."""
        if not samples:
            return
        now = time.perf_counter()
        with self._lock:
            self._hist.observe_many(lat for lat, _ in samples)
            self._requests.inc(len(samples))
            self._rows.inc(sum(n for _, n in samples))
            if self._t_first is None:
                self._t_first = now - samples[0][0]
            self._t_last = now
            d = self._dispatches.value
            if d:
                self._dpr.set(d / self._requests.value)

    def _record_locked(self, now: float, latency_s: float, n_rows: int) -> None:
        self._hist.observe(float(latency_s))
        self._requests.inc()
        self._rows.inc(int(n_rows))
        if self._t_first is None:
            self._t_first = now - latency_s  # window opens at first submit
        self._t_last = now
        d = self._dispatches.value
        if d:
            self._dpr.set(d / self._requests.value)

    def record_dispatch(self, n_requests: int, n_rows: int,
                        capacity: int | None = None) -> None:
        """One device dispatch carrying ``n_requests`` coalesced requests of
        ``n_rows`` total rows into a bucket of ``capacity`` rows (the padded
        executable shape). Updates the dispatch counter and the occupancy /
        dispatches-per-request gauges."""
        with self._lock:
            self._dispatches.inc()
            if capacity:
                self._dispatch_rows += int(n_rows)
                self._dispatch_capacity += int(capacity)
                self._occupancy.set(
                    self._dispatch_rows / self._dispatch_capacity)
            reqs = self._requests.value
            if reqs:
                self._dpr.set(self._dispatches.value / reqs)

    @property
    def requests(self) -> int:
        with self._lock:
            return self._requests.value

    def summary(self) -> dict:
        """One flat dict: lifetime request/row counts and throughput, latency
        percentiles (ms) over the retained window. Zero-request summaries are
        all zeros (a bench that produced nothing should emit an honest
        record, not crash)."""
        with self._lock:
            lat = self._hist.snapshot()
            n_requests = self._requests.value
            rows = self._rows.value
            dispatches = self._dispatches.value
            occupancy = (self._dispatch_rows / self._dispatch_capacity
                         if self._dispatch_capacity else 0.0)
            elapsed = (
                (self._t_last - self._t_first)
                if self._t_first is not None else 0.0
            )
        if lat.size == 0:
            return {
                "requests": 0, "rows": 0, "elapsed_s": 0.0,
                "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                "mean_ms": 0.0, "max_ms": 0.0,
                "requests_per_s": 0.0, "rows_per_s": 0.0,
                "dispatches": int(dispatches),
                "dispatches_per_request": 0.0,
                "batch_occupancy": round(occupancy, 4),
            }
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        # a single instantaneous request has elapsed ~ its own latency;
        # guard the division anyway (perf_counter can tie at its resolution)
        denom = max(elapsed, 1e-9)
        return {
            "requests": int(n_requests),
            "rows": int(rows),
            "elapsed_s": round(elapsed, 6),
            "p50_ms": round(p50 * 1e3, 4),
            "p95_ms": round(p95 * 1e3, 4),
            "p99_ms": round(p99 * 1e3, 4),
            "mean_ms": round(float(lat.mean()) * 1e3, 4),
            "max_ms": round(float(lat.max()) * 1e3, 4),
            "requests_per_s": round(n_requests / denom, 2),
            "rows_per_s": round(rows / denom, 2),
            # dispatch amortisation: how many device dispatches the traffic
            # cost, the filled fraction of each dispatched bucket, and
            # dispatches/request (1.0 = no coalescing)
            "dispatches": int(dispatches),
            "dispatches_per_request": round(dispatches / n_requests, 4),
            "batch_occupancy": round(occupancy, 4),
        }
