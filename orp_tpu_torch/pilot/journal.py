"""The pilot's append-only cycle journal (``orp-pilot-v1``; counterpart of
``orp_tpu/pilot/journal.py``).

Every state-machine transition the controller takes — and every manual
retrain request filed into it — lands here as one canonical JSON line, so a
killed pilot resumes MID-CYCLE from its last journaled state instead of
restarting (and re-paying a half-finished retrain). Same persistence
discipline as the perf ledger (``obs/perf.py``):

- append-only, one record per line, ``sort_keys`` canonical JSON;
- the writer stamps ``schema`` / ``seq`` / ``ts_unix`` LAST — caller keys
  cannot override the envelope;
- a torn LAST line (a pilot killed mid-append) is tolerated on read and
  HEALED on the next append; a torn line anywhere else is corruption and
  raises — an edited history must not quietly shrink.

Record kinds:

- ``transition`` — ``{kind, cycle, state, ...payload}``: the controller
  entered ``state`` for ``cycle``. Terminal states (``promoted`` /
  ``rejected`` / ``failed``) close the cycle.
- ``trigger_request`` — ``{kind, source, tenant, reason}``: a manual
  retrain request (the JAX package's ``orp pilot retrain`` files the same);
  the controller consumes it on its next poll (the consuming
  ``calibrating`` transition records the request's ``seq`` as
  ``trigger_seq``).
- ``config`` — ``{kind, tenant, ...}``: the controller's operating
  parameters, written once at construction; ``doctor_report(pilot=)`` reads
  the latest one to probe the trigger sources.

The envelope and the canonical encoding are the JAX package's, so a journal
written by either package is read and appended to by the other.
"""

from __future__ import annotations

import json
import pathlib

PILOT_SCHEMA = "orp-pilot-v1"
JOURNAL_FILE = "pilot.jsonl"

STATES = ("idle", "calibrating", "training", "exporting", "canary",
          "promoted", "rejected", "failed")
TERMINAL_STATES = frozenset({"promoted", "rejected", "failed"})
KINDS = ("transition", "trigger_request", "config")


def validate_pilot_record(rec: dict) -> list[str]:
    """Problems that make ``rec`` unappendable (empty list = valid)."""
    problems: list[str] = []
    if not isinstance(rec, dict):
        return [f"record must be a dict, got {type(rec).__name__}"]
    if rec.get("schema") not in (None, PILOT_SCHEMA):
        problems.append(f"schema {rec['schema']!r} != {PILOT_SCHEMA!r}")
    kind = rec.get("kind")
    if kind not in KINDS:
        problems.append(f"kind {kind!r} not in {KINDS}")
    if kind == "transition":
        if not isinstance(rec.get("cycle"), int):
            problems.append("transition record needs an int 'cycle'")
        if rec.get("state") not in STATES:
            problems.append(f"state {rec.get('state')!r} not in {STATES}")
    if kind == "trigger_request" and not rec.get("source"):
        problems.append("trigger_request record needs a 'source'")
    return problems


def read_journal(path) -> tuple[list[dict], list[str]]:
    """Parse a journal into ``(records, problems)`` — perf-ledger torn-tail
    semantics: an unterminated unparseable last line is noted and skipped,
    a torn line anywhere else raises."""
    p = pathlib.Path(path)
    if not p.exists():
        return [], []
    text = p.read_text()
    ends_nl = text.endswith("\n")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    records: list[dict] = []
    problems: list[str] = []
    for i, line in enumerate(lines):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1 and not ends_nl:
                problems.append(f"torn tail line skipped ({e})")
                continue
            raise ValueError(
                f"{p}: line {i + 1} does not parse ({e}) — not the torn "
                "tail; the journal was edited or corrupted") from None
    return records, problems


def journal_append(path, record: dict) -> dict:
    """Append one validated record, stamping the ``schema``/``seq``/
    ``ts_unix`` envelope LAST and healing a torn tail first (the
    perf-ledger append discipline — see ``obs/perf.py::ledger_append``)."""
    import time

    problems = validate_pilot_record(record)
    if problems:
        raise ValueError(
            f"refusing to append an invalid pilot record: {problems}")
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    needs_nl = False
    seq = 0
    if p.exists() and p.stat().st_size > 0:
        # O(1) in journal size: only the LAST line can be torn, and the
        # last complete record carries the seq to continue from
        with open(p, "rb") as f:
            size = f.seek(0, 2)
            back = min(size, 65536)
            f.seek(size - back)
            chunk = f.read(back)
        if back < size and b"\n" not in chunk:  # pragma: no cover
            chunk = p.read_bytes()  # pathological >64KiB last line
        tail_lines = [ln for ln in chunk.split(b"\n") if ln.strip()]
        if not chunk.endswith(b"\n") and tail_lines:
            tail = tail_lines[-1]
            try:
                json.loads(tail.decode("utf-8"))
                needs_nl = True  # complete record, just unterminated
            except (ValueError, UnicodeDecodeError):
                with open(p, "ab") as f:
                    f.truncate(p.stat().st_size - len(tail))
                tail_lines = tail_lines[:-1]
        for ln in reversed(tail_lines):
            try:
                seq = int(json.loads(ln.decode("utf-8")).get("seq", -1)) + 1
                break
            except (ValueError, UnicodeDecodeError):  # pragma: no cover
                continue
    out = {**record, "schema": PILOT_SCHEMA, "seq": seq,
           "ts_unix": round(time.time(), 3)}
    with open(p, "a") as f:
        if needs_nl:
            f.write("\n")
        f.write(json.dumps(out, sort_keys=True, separators=(",", ":")) + "\n")
    return out


def cycles(records) -> dict[int, list[dict]]:
    """Group transition records by cycle id (insertion-ordered)."""
    out: dict[int, list[dict]] = {}
    for rec in records:
        if rec.get("kind") == "transition" and isinstance(
                rec.get("cycle"), int):
            out.setdefault(rec["cycle"], []).append(rec)
    return out


def last_cycle(records) -> tuple[int | None, list[dict]]:
    """The highest cycle id and its transition records (None if none)."""
    by_cycle = cycles(records)
    if not by_cycle:
        return None, []
    cid = max(by_cycle)
    return cid, by_cycle[cid]


def latest_config(records) -> dict | None:
    """The most recent ``config`` record (None before the first one)."""
    for rec in reversed(records):
        if rec.get("kind") == "config":
            return rec
    return None


def unconsumed_requests(records) -> list[dict]:
    """Manual ``trigger_request`` records no ``calibrating`` transition has
    consumed yet (consumption is recorded as the transition's
    ``trigger_seq``) — stateless, so a restarted controller neither drops
    nor double-fires a pending request."""
    consumed = {rec.get("trigger_seq") for rec in records
                if rec.get("kind") == "transition"
                and rec.get("state") == "calibrating"}
    return [rec for rec in records
            if rec.get("kind") == "trigger_request"
            and rec.get("seq") not in consumed]
