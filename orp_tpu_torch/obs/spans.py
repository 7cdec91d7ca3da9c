"""Nested, device-complete span timers with a zero-cost disabled mode (counterpart of ``orp_tpu/obs/spans.py``).

A span is the port's unit of "where did the time go": it opens a
``utils/profiling.trace`` region (a ``torch.profiler.record_function`` while a
profiler runs, so an enabled run shows up as named regions in a
``torch.profiler`` capture) AND records a wall-clock duration that is
DEVICE-COMPLETE: hand the span the result tree via ``set_result`` and the
clock stops only after the current stream of every CUDA device holding a
tensor of the tree has finished (``utils/profiling.block_until_ready``), so
durations are device time, not launch time.
A wait inside a CUDA-graph capture raises, naming the span: a region that is
being captured runs nothing, so there is nothing to wait for.

Completed spans are double-routed: an event to the active sink
(``obs/sink.py`` JSONL) and a ``span_seconds{name=...}`` histogram +
``spans_total{name=...}`` counter in the active registry. Nesting is
tracked per thread; each event carries its parent span's name. The names,
schemas and labels are the JAX package's.

**Disabled mode is the default and costs nothing.** Until ``enable()`` is
called, ``span(...)`` returns one process-wide no-op singleton (no
allocation, no lock, no profiler region, no clock read, no wait) and
``count`` / ``set_gauge`` return before touching any instrument.

Telemetry is per process: under a paths mesh each rank's session is its own,
and nothing here enters a collective, so a rank with telemetry on runs the
same group work as a rank without.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import secrets
import threading
import time

from orp_tpu_torch.obs import devprof as _devprof
from orp_tpu_torch.obs.registry import Registry
from orp_tpu_torch.utils.profiling import block_until_ready, trace

_tls = threading.local()


class ObsState:
    """The active telemetry wiring: one registry + optionally one sink."""

    def __init__(self, registry: Registry | None = None, sink=None):
        self.registry = registry if registry is not None else Registry()
        self.sink = sink
        self.manifest_extra: dict = {}
        # set by obs.telemetry when the session exports to disk: the dir
        # mid-session flushes (periodic / SIGTERM) write into
        self.export_dir = None


_STATE: ObsState | None = None


def enable(registry: Registry | None = None, sink=None) -> ObsState:
    """Switch telemetry on process-wide; returns the active state."""
    global _STATE
    _STATE = ObsState(registry, sink)
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def state() -> ObsState | None:
    return _STATE


@contextlib.contextmanager
def active(registry: Registry | None = None, sink=None):
    """``enable``/``disable`` as a scope (the ``obs.telemetry`` session
    builds on this)."""
    st = enable(registry, sink)
    try:
        yield st
    finally:
        disable()


@contextlib.contextmanager
def suspended():
    """Temporarily detach the active session (telemetry truly OFF inside),
    restoring it — not just re-enabling a blank one — on exit. The bench's
    enabled-vs-disabled overhead lanes need a genuine disabled mode even
    when the whole bench runs under ``--telemetry``."""
    global _STATE
    prev, _STATE = _STATE, None
    try:
        yield
    finally:
        _STATE = prev


class _NoopSpan:
    """The disabled-mode span: one shared instance, every method a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_result(self, result):
        return result

    def annotate(self, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


def _span_stack() -> list:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


class Span:
    """One live span. Use via ``with span("phase") as sp: ... sp.set_result(out)``."""

    __slots__ = ("name", "attrs", "_state", "_annotation", "_t0", "_result",
                 "parent")

    def __init__(self, state: ObsState, name: str, attrs: dict | None):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self._state = state
        self._result = None
        self.parent = None
        self._annotation = trace(name)

    def set_result(self, result):
        """Register the result tree the span must wait for before its clock
        stops. Returns ``result`` unchanged (so call sites can wrap a
        producing expression)."""
        self._result = result
        return result

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _span_stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        ok = exc_type is None
        # device-time attribution (obs/devprof): with the flag-gated
        # profiling mode on, stamp the instant the wait STARTS so the span's
        # wall splits into host_s (Python + launches) and device_s (the
        # waited tail), summing to dur_s exactly. One module-global load +
        # is-None test when attribution is off.
        t_pre = None
        try:
            if self._result is not None and ok:
                if _devprof._STATE is not None:
                    t_pre = time.perf_counter()
                block_until_ready(self.name, self._result)
        except BaseException:
            ok = False
            raise
        finally:
            # cleanup + recording run even when the wait raises (an
            # asynchronous device error surfacing here): a span left on the
            # thread-local stack would corrupt parent attribution for every
            # later span on this thread, and an unexited region would leave
            # a profiler's region open
            t_done = time.perf_counter()
            dur = t_done - self._t0
            self._annotation.__exit__(exc_type, exc, tb)
            stack = _span_stack()
            if stack and stack[-1] is self:
                stack.pop()
            st = self._state
            st.registry.histogram(
                "span_seconds", {"name": self.name}).observe(dur)
            st.registry.counter("spans_total", {"name": self.name}).inc()
            if t_pre is not None:
                st.registry.histogram(
                    "span_device_seconds",
                    {"name": self.name}).observe(t_done - t_pre)
            if st.sink is not None:
                event = {
                    "type": "span", "name": self.name, "dur_s": round(dur, 9),
                    "parent": self.parent, "ok": ok,
                }
                if t_pre is not None:
                    event["host_s"] = round(t_pre - self._t0, 9)
                    event["device_s"] = round(t_done - t_pre, 9)
                if self.attrs:
                    event["attrs"] = self.attrs
                st.sink.emit(event)
        return False


def span(name: str, attrs: dict | None = None):
    """A span context manager, or the shared no-op when telemetry is off.

    The disabled path is a single global load + ``is None`` test returning a
    pre-built singleton: nothing is allocated, no lock is taken, the name
    string is not even read."""
    st = _STATE
    if st is None:
        return NOOP_SPAN
    return Span(st, name, attrs)


def spanned(name: str, fn):
    """Wrap ``fn`` so each call runs inside a device-complete span. With
    telemetry off, returns ``fn`` itself: zero per-call overhead."""
    if _STATE is None:
        return fn

    def wrapped(*args, **kwargs):
        with span(name) as sp:
            return sp.set_result(fn(*args, **kwargs))

    return wrapped


def timed(name: str, fn, *args, **kwargs):
    """Run ``fn`` under a span and return ``(result, seconds)``, waiting for
    the result tree either way (the ``utils/profiling.timed`` contract), with
    the measurement recorded when telemetry is on."""
    t0 = time.perf_counter()
    with span(name) as sp:
        out = sp.set_result(fn(*args, **kwargs))
    block_until_ready(name, out)
    return out, time.perf_counter() - t0


def count(name: str, n: int = 1, *, sink_event: bool = True, **labels) -> None:
    """Increment ``name`` in the active registry; mirrored to the sink as a
    counter event unless ``sink_event=False`` (hot paths — e.g. the serve
    engine's per-request counters — stay registry-only so the event log and
    its write lock aren't hit once per request; the totals still export via
    the registry/``metrics.prom``). No-op (no instrument lookup, no lock)
    when telemetry is off."""
    st = _STATE
    if st is None:
        return
    st.registry.counter(name, labels or None).inc(n)
    if sink_event and st.sink is not None:
        st.sink.emit({"type": "counter", "name": name, "inc": n,
                      "labels": labels or {}})


def observe(name: str, value: float, **labels) -> None:
    """Record one sample into the registry histogram ``name`` (bounded
    window, exported via ``metrics.prom`` as summary quantiles). Registry-
    only — per-sample JSONL events would put sink-lock I/O inside hot
    paths like the batcher queue, the same rationale as ``count``'s
    ``sink_event=False`` mode. No-op (no instrument lookup, no lock) when
    telemetry is off."""
    st = _STATE
    if st is None:
        return
    st.registry.histogram(name, labels or None).observe(float(value))


def emit_record(name: str, payload: dict) -> None:
    """Emit a tool's result record as one schema-stamped ``record`` event on
    the active sink (the bench/profile artifact path). No-op when telemetry
    is off or the session has no sink."""
    st = _STATE
    if st is None or st.sink is None:
        return
    st.sink.emit({"type": "record", "name": name, **payload})


def set_gauge(name: str, value: float, **labels) -> None:
    """Set ``name`` in the active registry; mirrored to the sink. No-op when
    telemetry is off."""
    st = _STATE
    if st is None:
        return
    st.registry.gauge(name, labels or None).set(value)
    if st.sink is not None:
        st.sink.emit({"type": "gauge", "name": name, "value": float(value),
                      "labels": labels or {}})


# -- distributed trace context (Dapper-style ids over the wire) ---------------
#
# A trace is a u64 ``trace_id`` stamped once by the PRODUCER (the gateway
# client) and carried in-band through the ``orp-ingest-v2`` frame; every
# process segment it crosses (decode -> queue -> dispatch -> resolve ->
# encode) emits a span EVENT under that id, so one row's life reconstructs
# from the serving process's events.jsonl (``orp trace <trace_id>``). Span
# ids are process-unique: a random 32-bit base ORed with a monotonic
# counter (itertools.count.__next__ is atomic under the GIL), so two
# processes contributing to one trace cannot collide. On the JSON side the
# u64s travel as 16-hex-digit STRINGS — a u64 does not survive a float64
# JSON number (2^53 mantissa), and a silently-rounded trace id is a trace
# that can never be found again.

_SPAN_BASE = secrets.randbits(32) << 32
_SPAN_IDS = itertools.count(1)
# trace ids need uniqueness, not unpredictability: a PRNG seeded ONCE from
# the CSPRNG gives both process-level independence and ~60ns draws — the
# secrets module itself costs ~4µs per draw, which a per-frame stamp on the
# ingest lane cannot afford (the overhead gate measures exactly this)
_TRACE_RNG = random.Random(secrets.randbits(64))


def new_span_id() -> int:
    """A fresh process-unique span id (cheap: one counter increment)."""
    return _SPAN_BASE | next(_SPAN_IDS)


def new_trace() -> tuple[int, int]:
    """A fresh ``(trace_id, root_span_id)`` pair for stamping an outbound
    frame — the producer-side entry point of the distributed trace."""
    return _TRACE_RNG.getrandbits(64) or 1, new_span_id()


def trace_hex(trace_id: int) -> str:
    """The canonical JSON/CLI spelling of a trace/span id."""
    return f"{int(trace_id):016x}"


def parse_trace_id(s) -> int:
    """Accept the id as an int, hex (with or without ``0x``) or decimal —
    the ``orp trace`` argument contract. The canonical spelling is the
    16-hex-digit string ``trace_hex`` prints; an all-digit string parses as
    hex first, because that is what this module emits."""
    if isinstance(s, int):
        return s
    s = str(s).strip().lower()
    if s.startswith("0x"):
        return int(s, 16)
    try:
        # 16-hex-digit is the canonical spelling; plain digit strings that
        # are valid hex parse as hex first (that is what we print)
        return int(s, 16)
    except ValueError:
        return int(s, 10)


def emit_trace_span(name: str, trace_id: int, parent_span: int,
                    dur_s: float, *, span_id: int | None = None,
                    attrs: dict | None = None) -> int | None:
    """Emit one trace-linked span event on the active sink: a ``span``
    event carrying ``trace_id``/``span_id``/``parent_span`` as hex strings
    next to the usual ``dur_s``. Returns the span id used (None when
    telemetry is off or sinkless — the zero-cost rule: untraced serving
    pays one global load + None test)."""
    st = _STATE
    if st is None or st.sink is None:
        return None
    sid = new_span_id() if span_id is None else int(span_id)
    event = {
        "type": "span", "name": name, "dur_s": round(float(dur_s), 9),
        "parent": None, "ok": True,
        "trace_id": trace_hex(trace_id), "span_id": trace_hex(sid),
        "parent_span": trace_hex(parent_span),
    }
    if attrs:
        event["attrs"] = attrs
    # sink-only on purpose: the event IS the trace artifact (`orp trace`
    # reads it back); mirroring every segment into registry histograms
    # would double the per-frame cost for series nobody scrapes — the
    # scrape plane already carries the serving latency/queue-age series
    st.sink.emit(event)
    return sid


def emit_trace_spans(trace_id: int, parent_span: int, segments) -> None:
    """Emit a frame's segment spans as ONE sink burst: ``segments`` is an
    iterable of ``(name, dur_s)``. The per-frame tracing budget lives or
    dies here — the ids are hexed once, the sink is locked/stamped once
    (``emit_many``), nothing touches the registry. Same zero-cost rule:
    one global load + None test when telemetry is off or sinkless."""
    st = _STATE
    if st is None or st.sink is None:
        return
    tid = trace_hex(trace_id)
    par = trace_hex(parent_span)
    events = [{
        "type": "span", "name": name, "dur_s": round(float(dur), 9),
        "parent": None, "ok": True, "trace_id": tid,
        "span_id": trace_hex(new_span_id()), "parent_span": par,
    } for name, dur in segments]
    emit_many = getattr(st.sink, "emit_many", None)
    if emit_many is not None:
        emit_many(events)
    else:  # a foreign sink that only speaks emit(): same events, N locks
        for event in events:
            st.sink.emit(event)


def bind_manifest(**fields) -> None:
    """Attach run-identity fields (e.g. the pipeline's config fingerprint)
    to the active session; ``obs.telemetry`` folds them into the manifest it
    writes at exit. No-op when telemetry is off."""
    st = _STATE
    if st is None:
        return
    st.manifest_extra.update(fields)
