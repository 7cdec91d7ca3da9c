"""Exportable event sinks: the schema-versioned JSONL log and Prometheus text (counterpart of ``orp_tpu/obs/sink.py``).

Two export surfaces over one registry and span stream, with the JAX
package's schemas, so either package reads the other's files:

- ``JsonlSink``: an append-only ``events.jsonl``, one JSON object a line,
  every line stamped with ``schema`` / ``seq`` / ``ts_unix``. The schema
  version (``orp-obs-v1``) is a contract: a field change bumps ``SCHEMA``;
- ``prometheus_text``: the registry as Prometheus text exposition (counters
  and gauges verbatim; bounded histograms as summary-typed series with
  window quantiles and lifetime ``_sum`` / ``_count``), byte-identical to the
  JAX package's for the same registry operations: ``metrics.prom`` a run.

Writes are line-buffered and lock-guarded: the engine's callers and the host
training loop may emit concurrently.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

from orp_tpu_torch.obs.registry import Counter, Gauge, Registry

SCHEMA = "orp-obs-v1"

#: the bundle's canonical file names (one source of truth — the telemetry
#: session, the doctor probe and the trace viewer all resolve these)
EVENTS_FILE = "events.jsonl"
METRICS_FILE = "metrics.prom"

# every event line must carry these; type-specific payloads ride alongside
_REQUIRED = {"schema": str, "seq": int, "ts_unix": float, "type": str}
_KNOWN_TYPES = ("span", "counter", "gauge", "manifest", "record")


def validate_event(event: dict) -> list[str]:
    """Schema check for one parsed JSONL line; returns problems (empty =
    valid). The tests hold every line a run emits to it."""
    problems = []
    for key, typ in _REQUIRED.items():
        if key not in event:
            problems.append(f"missing key {key!r}")
        elif not isinstance(event[key], typ):
            problems.append(
                f"{key}={event[key]!r} is {type(event[key]).__name__}, "
                f"expected {typ.__name__}")
    if event.get("schema") not in (None, SCHEMA):
        problems.append(f"schema {event['schema']!r} != {SCHEMA!r}")
    if "type" in event and event["type"] not in _KNOWN_TYPES:
        problems.append(f"unknown event type {event['type']!r}")
    if event.get("type") == "span" and "dur_s" not in event:
        problems.append("span event without dur_s")
    return problems


class JsonlSink:
    """JSONL event log: ``emit`` stamps schema/seq/timestamp and appends one
    line; safe from any thread.

    Opening TRUNCATES the file — one file per session. A re-used
    ``--telemetry DIR`` therefore yields a bundle describing only the
    latest run, keeping ``events.jsonl`` consistent with the
    ``manifest.json``/``metrics.prom`` it sits next to (those overwrite
    too) and keeping ``seq`` unique within the file."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = 0
        self._f = open(self.path, "w", buffering=1)

    def emit(self, event: dict) -> None:
        with self._lock:
            if self._f.closed:
                return  # a straggler thread after close loses its line, not the file
            line = dict(event)
            line["schema"] = SCHEMA
            line["seq"] = self._seq
            line["ts_unix"] = time.time()
            self._seq += 1
            self._f.write(json.dumps(line) + "\n")

    def emit_many(self, events) -> None:
        """Emit a burst of events under ONE lock acquisition, one clock
        read and one write — the trace plane emits a frame's segment spans
        as a group, and per-event lock/stamp/write churn would put the
        recorder inside the per-frame budget it documents."""
        with self._lock:
            if self._f.closed:
                return
            now = time.time()
            out = []
            for event in events:
                line = dict(event)
                line["schema"] = SCHEMA
                line["seq"] = self._seq
                line["ts_unix"] = now
                self._seq += 1
                out.append(json.dumps(line))
            if out:
                self._f.write("\n".join(out) + "\n")

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._seq

    def flush(self) -> None:
        """Force buffered lines to disk (the SIGTERM flush path; writes are
        line-buffered already, so this is belt-and-braces for a kill that
        lands mid-line)."""
        with self._lock:
            if not self._f.closed:
                self._f.flush()  # orp: noqa[ORP021] -- the lock guards the file handle itself; flush must exclude concurrent writers and close

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ListSink:
    """In-memory sink for tests and ad-hoc introspection — same ``emit``
    contract, events kept as dicts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        with self._lock:
            line = dict(event)
            line["schema"] = SCHEMA
            line["seq"] = len(self.events)
            line["ts_unix"] = time.time()
            self.events.append(line)

    def emit_many(self, events) -> None:
        """The burst contract, in memory: one lock, one clock read."""
        with self._lock:
            now = time.time()
            for event in events:
                line = dict(event)
                line["schema"] = SCHEMA
                line["seq"] = len(self.events)
                line["ts_unix"] = now
                self.events.append(line)

    def close(self) -> None:
        pass


def read_events(path: str | pathlib.Path) -> list[dict]:
    """Parse an ``events.jsonl`` back into dicts (strict: a malformed line
    raises — a half-written artifact should fail loudly)."""
    return [json.loads(line)
            for line in pathlib.Path(path).read_text().splitlines() if line]


_NAME_SAN = str.maketrans({c: "_" for c in "-./ "})


def _prom_name(name: str) -> str:
    return name.translate(_NAME_SAN)


def _prom_value(v: str) -> str:
    """Label-VALUE escaping the text format requires (backslash first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels, extra: str = "") -> str:
    parts = [f'{k.translate(_NAME_SAN)}="{_prom_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: Registry) -> str:
    """Prometheus text exposition (version 0.0.4) of every registry series.

    Bounded histograms export as ``summary`` metrics: window p50/p95/p99 as
    ``quantile`` labels plus lifetime ``_sum``/``_count`` — the standard
    shape for client-computed percentiles (a bucketed histogram would imply
    server-side aggregation these window samples cannot honestly support).
    """
    # group by (kind, name): the registry legally holds different kinds
    # under one name, and mixing them in a group would mislabel (or crash)
    # the exposition for every other series in the bundle
    by_group: dict[tuple[str, str], list] = {}
    for inst in registry.instruments():
        kind = ("counter" if isinstance(inst, Counter)
                else "gauge" if isinstance(inst, Gauge) else "summary")
        by_group.setdefault((kind, inst.name), []).append(inst)
    lines = []
    for (kind, name), insts in by_group.items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {kind}")
        for inst in insts:
            if kind in ("counter", "gauge"):
                lines.append(f"{pname}{_prom_labels(inst.labels)} {inst.value}")
                continue
            p50, p95, p99 = inst.percentiles((50, 95, 99))
            for q, v in (("0.5", p50), ("0.95", p95), ("0.99", p99)):
                # no backslash inside the f-string expression (a SyntaxError
                # before Python 3.12)
                qlabel = 'quantile="%s"' % q
                lines.append(f"{pname}{_prom_labels(inst.labels, qlabel)} {v}")
            lines.append(f"{pname}_sum{_prom_labels(inst.labels)} {inst.sum}")
            lines.append(f"{pname}_count{_prom_labels(inst.labels)} {inst.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str | pathlib.Path, registry: Registry) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(prometheus_text(registry))
