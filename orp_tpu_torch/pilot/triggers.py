"""Trigger sources for the pilot loop, unified as debounced events
(counterpart of ``orp_tpu/pilot/triggers.py``).

Three signals can ask for a retrain, and they arrive through three different
channels; this module normalizes all of them into :class:`TriggerEvent` and
pushes every one through a single :class:`guard.Cooldown` gate so a flapping
signal cannot retrain-storm:

- ``drift``       — ``quality/drift_trip`` events off the flight recorder
                    (the serve-side drift monitor; ``obs/flight.py``). The
                    hub consumes the recorder's ring incrementally — each
                    trip fires at most once.
- ``calibration`` — a rolling-window fit whose params left the serving
                    bundle's baked CI band (``pilot/calibrate.py``'s
                    significance gate — the gate runs HERE so an
                    insignificant wobble never even reaches the cooldown).
- ``manual``      — a ``trigger_request`` filed into the journal (the JAX
                    package's ``orp pilot retrain`` writes the same); the
                    hub returns requests no cycle has consumed yet.

``accept()`` is the one door to a retrain: it consults the cooldown, emits
``pilot/trigger`` (accepted) or ``pilot/debounced`` (suppressed) counters,
and arms the gate. The controller reports outcomes back
(``note_promote`` / ``note_reject``) so consecutive rejects escalate the
backoff — the guard discipline, minutes-scale.
"""

from __future__ import annotations

import dataclasses

from orp_tpu_torch.guard.cooldown import Cooldown
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.pilot import journal as _journal
from orp_tpu_torch.pilot.calibrate import shift_significant


@dataclasses.dataclass(frozen=True)
class TriggerEvent:
    """One normalized retrain request."""

    source: str           # "drift" | "calibration" | "manual"
    tenant: str
    reason: str
    seq: int | None = None      # journal seq for manual requests
    payload: dict = dataclasses.field(default_factory=dict)


class TriggerHub:
    """Per-tenant trigger aggregation + the debounce gate (module doc)."""

    def __init__(self, tenant: str, *, cooldown: Cooldown | None = None):
        self.tenant = tenant
        self.cooldown = cooldown if cooldown is not None else Cooldown()
        self._flight_seen = 0

    # -- sources -------------------------------------------------------------

    def poll_drift(self, flight_events) -> list[TriggerEvent]:
        """New ``drift_trip`` events for this tenant since the last poll.
        ``flight_events`` is a flight-recorder snapshot (or ``read_flight``
        output) — the hub remembers how far it has read."""
        events = list(flight_events)
        fresh = events[self._flight_seen:]
        self._flight_seen = len(events)
        out = []
        for e in fresh:
            if (e.get("kind") == "drift_trip"
                    and e.get("tenant") == self.tenant):
                out.append(TriggerEvent(
                    source="drift", tenant=self.tenant,
                    reason=(f"drift score {e.get('score')} breached band "
                            f"{e.get('band')} after {e.get('rows')} rows"),
                    payload={"score": e.get("score"),
                             "band": e.get("band"),
                             "rows": e.get("rows")}))
        return out

    def poll_manual(self, journal_records) -> list[TriggerEvent]:
        """Unconsumed manual retrain requests for this tenant."""
        out = []
        for rec in _journal.unconsumed_requests(journal_records):
            if rec.get("tenant") not in (None, self.tenant):
                continue
            out.append(TriggerEvent(
                source="manual", tenant=self.tenant,
                reason=rec.get("reason") or "manual retrain request",
                seq=rec.get("seq")))
        return out

    def check_calibration(self, window, baseline: dict | None):
        """The significance gate as a trigger source: a fresh
        :class:`pilot.calibrate.CalibrationWindow` against the serving
        bundle's baked band. ``None`` when the fit sits inside the band
        (noise, not signal); an event when it left it — or when the serving
        bundle predates baked calibrations (no band to hide inside)."""
        if baseline is None:
            return TriggerEvent(
                source="calibration", tenant=self.tenant,
                reason="serving bundle has no baked calibration band",
                payload={"detail": {}})
        fired, detail = shift_significant(window.fit, baseline)
        if not fired:
            return None
        moved = sorted(k for k, d in detail.items() if d["outside"])
        return TriggerEvent(
            source="calibration", tenant=self.tenant,
            reason=f"fitted {', '.join(moved)} left the baked CI band",
            payload={"detail": detail})

    # -- the debounce gate ---------------------------------------------------

    def accept(self, event: TriggerEvent) -> bool:
        """The one door to a retrain: True arms the cooldown and admits the
        event; False means the gate is still closed (debounced)."""
        if not self.cooldown.ready():
            obs_count("pilot/debounced", source=event.source,
                      tenant=self.tenant)
            return False
        self.cooldown.note_fire()
        obs_count("pilot/trigger", source=event.source, tenant=self.tenant)
        return True

    def note_promote(self) -> None:
        self.cooldown.note_promote()

    def note_reject(self) -> None:
        self.cooldown.note_reject()
