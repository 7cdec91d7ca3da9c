"""Flight recorder: a bounded in-memory ring of recent structured events (counterpart of ``orp_tpu/obs/flight.py``).

The telemetry session answers "what happened over the whole run"; this
module answers "what happened in the last moments before it died". Every
process keeps one :class:`FlightRecorder` (:data:`RECORDER`): a bounded
deque that guard and serve sites append structured events to. Recording is
always on and costs one lock and one deque append an event (no I/O, no
growth), so the black box exists even in a process with no session.

The ring becomes bytes only on a **dump**: a schema-versioned JSONL file
(``orp-flight-v1``) written

- on any TRIP-class event once the recorder is **armed** with a directory
  (``obs.telemetry`` arms it to the bundle directory);
- on SIGTERM via the telemetry signal flush (``obs.flush_active``);
- at the end of a telemetry session.

Dumps TRUNCATE: the file is always the latest ring.
"""

from __future__ import annotations

import collections
import json
import pathlib
import threading
import time

FLIGHT_SCHEMA = "orp-flight-v1"
FLIGHT_FILE = "flight.jsonl"

#: event kinds that auto-dump an armed recorder: the "something tripped,
#: preserve the evidence NOW" class (a later SIGTERM may never come). The
#: JAX package's set, whose serve and model-health planes record them
TRIP_KINDS = frozenset({"watchdog_trip", "circuit_open", "device_lost",
                        "canary_reject", "drift_trip"})

# every dumped line must carry these; kind-specific fields ride alongside
_REQUIRED = {"schema": str, "seq": int, "ts_unix": float, "kind": str}


def validate_flight_event(event: dict) -> list[str]:
    """Schema check for one parsed flight line; returns problems (empty =
    valid): the same contract shape as ``obs.validate_event``."""
    problems = []
    for key, typ in _REQUIRED.items():
        if key not in event:
            problems.append(f"missing key {key!r}")
        elif not isinstance(event[key], typ):
            problems.append(
                f"{key}={event[key]!r} is {type(event[key]).__name__}, "
                f"expected {typ.__name__}")
    if event.get("schema") not in (None, FLIGHT_SCHEMA):
        problems.append(f"schema {event['schema']!r} != {FLIGHT_SCHEMA!r}")
    return problems


class FlightRecorder:
    """One process's black box: bounded, thread-safe, always recording.

    ``capacity`` bounds the retained events (oldest evicted first);
    ``seq`` is the lifetime event count, so a dump shows both how much was
    retained and how much rolled off the front.
    """

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # dumps serialize on their OWN lock: a trip's auto-dump, a HEALTH
        # probe's dump and the SIGTERM flush may land concurrently, and
        # two unserialized truncate-writes to one path tear the black box
        # exactly when trips cluster
        self._dump_lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self._dump_dir: pathlib.Path | None = None
        self.dumps = 0

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event (lock + deque append — safe from any
        thread, including guard trip callbacks mid-failure). A TRIP-class
        kind additionally dumps the ring when the recorder is armed."""
        with self._lock:
            event = {"kind": str(kind), "ts_unix": time.time(),
                     "seq": self._seq, **fields}
            self._seq += 1
            self._ring.append(event)
            armed = self._dump_dir
        if armed is not None and kind in TRIP_KINDS:
            self.dump()

    @property
    def recorded(self) -> int:
        """Lifetime events recorded (retained or rolled off)."""
        with self._lock:
            return self._seq

    def snapshot(self) -> list[dict]:
        """The retained ring, oldest first (copies — callers may mutate)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def reset(self) -> None:
        """Wipe the ring and the lifetime count (tests own their rings)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0

    # -- arming / dumping ----------------------------------------------------

    def arm(self, directory) -> None:
        """Point automatic dumps (trips, signal flush) at ``directory``."""
        with self._lock:
            self._dump_dir = pathlib.Path(directory)

    def disarm(self) -> None:
        with self._lock:
            self._dump_dir = None

    @property
    def armed(self) -> pathlib.Path | None:
        with self._lock:
            return self._dump_dir

    def dump(self, path=None) -> pathlib.Path | None:
        """Write the ring as schema-versioned JSONL. ``path=None`` uses the
        armed directory's ``flight.jsonl`` (returns None when disarmed —
        a dump with nowhere to go is a no-op, never an error: this runs
        inside failure paths). The write TRUNCATES: the file is the latest
        ring, not an append log."""
        with self._lock:
            if path is None:
                if self._dump_dir is None:
                    return None
                path = self._dump_dir / FLIGHT_FILE
            events = [dict(e) for e in self._ring]
            total = self._seq
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        header = {"schema": FLIGHT_SCHEMA, "kind": "flight_dump",
                  "seq": -1, "ts_unix": time.time(),
                  "retained": len(events), "recorded": total,
                  "capacity": self.capacity}
        lines = [json.dumps(header)]
        lines += [json.dumps({"schema": FLIGHT_SCHEMA, **e}) for e in events]
        # serialized AND atomic (write-aside + rename): a reader or a
        # concurrent dumper never sees a half-written black box
        with self._dump_lock:
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text("\n".join(lines) + "\n")  # orp: noqa[ORP021] -- _dump_lock EXISTS to serialize black-box file writes; hot-path record() takes _lock, never this one
            tmp.replace(path)
        with self._lock:
            self.dumps += 1
        return path


#: the process-wide black box every guard/serve site records into
RECORDER = FlightRecorder()


def record(kind: str, **fields) -> None:
    """Module-level convenience: ``flight.record("shed", reason=...)``."""
    RECORDER.record(kind, **fields)


def read_flight(path) -> list[dict]:
    """Parse a dumped ``flight.jsonl`` back into dicts (strict — a torn
    black box should fail loudly, exactly like ``obs.read_events``)."""
    return [json.loads(line)
            for line in pathlib.Path(path).read_text().splitlines() if line]
