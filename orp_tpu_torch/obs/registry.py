"""Process-wide metrics registry: counters, gauges, bounded histograms (counterpart of ``orp_tpu/obs/registry.py``).

The one place the port's observables accumulate; ``obs/sink.py`` exports
them (JSONL events and Prometheus text).

- **Interning**: ``registry.counter(name, labels)`` returns the SAME object
  for the same ``(name, labels)``, so callers anywhere in the process share a
  series without passing handles around. Instruments are created under the
  registry lock; updates take only the instrument's own lock.
- **Bounded histograms**: a deque of the most recent ``window`` samples, so
  an always-on server records forever without growing; percentiles reflect
  the window, count and sum the lifetime.
- **Host-side only**: instruments hold Python floats and ints. Never record
  from inside a CUDA-graph capture: record after the result is on the host
  or waited for (``obs/spans.py`` waits for you).
"""

from __future__ import annotations

import collections
import threading

import numpy as np

Labels = tuple[tuple[str, str], ...]


def _labels_key(labels: dict[str, str] | None) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (requests, rows, compiles, events)."""

    def __init__(self, name: str, labels: Labels = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        """Zero the count. Not a Prometheus-counter operation: it exists for
        façades and tests that own their instruments outright."""
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value (queue depth, cache size, config scalars)."""

    def __init__(self, name: str, labels: Labels = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded sample window + lifetime count/sum.

    Percentiles are ``np.percentile`` (linear interpolation) over the raw
    samples of the retained window, as the JAX package computes them.
    """

    def __init__(self, name: str, labels: Labels = (), *, window: int = 65536):
        if window < 1:
            raise ValueError(f"histogram {name}: window={window} must be >= 1")
        self.name = name
        self.labels = labels
        self.window = int(window)
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._samples: collections.deque[float] = collections.deque(
            maxlen=self.window)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v

    def observe_many(self, values) -> None:
        """Record a batch of samples under ONE lock acquisition — the serve
        tier resolves whole coalesced batches at once, and per-sample lock
        churn would put the recorder inside the latency it measures."""
        vals = [float(v) for v in values]
        with self._lock:
            self._samples.extend(vals)
            self._count += len(vals)
            self._sum += sum(vals)

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> np.ndarray:
        """The retained window as a float64 array (oldest first)."""
        with self._lock:
            return np.asarray(self._samples, np.float64)

    def percentiles(self, qs) -> list[float]:
        """Window percentiles (``qs`` in 0..100); zeros when empty — an
        empty series must summarise honestly, not crash."""
        lat = self.snapshot()
        if lat.size == 0:
            return [0.0 for _ in qs]
        return [float(p) for p in np.percentile(lat, list(qs))]

    def fraction_over(self, threshold: float) -> float:
        """Fraction of the retained window strictly above ``threshold`` —
        the SLO-violation rate an error-budget burn evaluation divides by
        its budget (``serve/host.py``). 0.0 when empty: no traffic burns
        no budget."""
        vals = self.snapshot()
        if vals.size == 0:
            return 0.0
        return float((vals > float(threshold)).mean())


class Registry:
    """Thread-safe instrument store. ``orp_tpu_torch.obs.REGISTRY`` is the
    process-wide default; private instances back sessions and tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[tuple[str, str, Labels], object] = {}

    def _intern(self, kind: str, name: str, labels, factory):
        key = (kind, name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory(name, key[2])
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, labels: dict[str, str] | None = None) -> Counter:
        return self._intern("counter", name, labels, Counter)

    def gauge(self, name: str, labels: dict[str, str] | None = None) -> Gauge:
        return self._intern("gauge", name, labels, Gauge)

    def histogram(self, name: str, labels: dict[str, str] | None = None,
                  *, window: int = 65536) -> Histogram:
        h = self._intern(
            "histogram", name, labels,
            lambda n, lk: Histogram(n, lk, window=window))
        if h.window != window:
            raise ValueError(
                f"histogram {name}{dict(h.labels)} already interned with "
                f"window={h.window}, requested {window}"
            )
        return h

    def instruments(self) -> list[object]:
        """All instruments, stable (insertion) order."""
        with self._lock:
            return list(self._instruments.values())

    def collect(self) -> dict[str, dict]:
        """JSON-able snapshot: ``{"name{k=v}": {...}}`` per series."""
        out = {}
        for inst in self.instruments():
            label_s = ",".join(f"{k}={v}" for k, v in inst.labels)
            key = f"{inst.name}{{{label_s}}}" if label_s else inst.name
            if isinstance(inst, Counter):
                out[key] = {"type": "counter", "value": inst.value}
            elif isinstance(inst, Gauge):
                out[key] = {"type": "gauge", "value": inst.value}
            else:
                p50, p95, p99 = inst.percentiles((50, 95, 99))
                out[key] = {
                    "type": "histogram", "count": inst.count,
                    "sum": inst.sum, "p50": p50, "p95": p95, "p99": p99,
                }
        return out
