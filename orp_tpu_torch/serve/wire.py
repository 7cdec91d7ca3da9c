"""``orp-ingest-v2``: the columnar wire format of the ingest plane (counterpart of
``orp_tpu/serve/wire.py``; frames byte-identical to the JAX package's).

A request crosses the process boundary as ONE versioned fixed-width
little-endian frame — a packed header plus raw feature/price/deadline
columns — encoded and decoded with ``np.frombuffer``/``tobytes`` only.
Zero per-row Python objects on either side: the
decoder's cost is a header validation plus three buffer views, whatever
the row count.

v1 frame layout (all little-endian, no padding)::

    magic      4s   b"ORPI"
    version    u1   1 or 2
    kind       u1   REQUEST | REPLY | ERROR | PING | PONG
                    | HELLO | WELCOME | BUSY | REDIRECT
                    | METRICS | HEALTH (v2)
    dtype_tag  u1   1 = float32 value columns
    flags      u1   REQUEST: bit0 prices, bit1 per-row deadlines,
                             bit2 trace context present
                    REPLY:   bit0 value column present,
                             bit2 server-timing block present
    tenant     16s  NUL-padded ASCII tenant name (REQUEST; else zeros)
    date_idx   i4
    n_rows     u4
    n_features u4   (REQUEST; 0 otherwise)
    n_prices   u4   (REQUEST; 0 otherwise)
    deadline_ms f8  block-level deadline budget (NaN = none)

A **v2** header is the v1 header plus a 16-byte delivery extension::

    seq        u8   per-connection monotonically increasing frame id
                    (WELCOME: the session's highest admitted seq;
                    BUSY/REDIRECT: the seq of the frame being refused)
    reserved   u8   zero

followed by the payload, in order. With flag bit2 set (either direction) a
16-byte **trace extension** sits FIRST, between header and columns —
REQUEST: ``<u8 trace_id, u8 parent_span>`` (the Dapper context the
producer stamps; ``obs.new_trace()``); REPLY: ``<u8 trace_id,
f4 queue_age_s, f4 dispatch_s>`` (the compact server-timing block).
Flag-gated so an untraced frame — every v1 frame, every seq-only v2
frame — stays byte-identical to the pre-trace wire. Then:

- REQUEST: features ``f4[n_rows, n_features]``, prices ``f4[n_rows,
  n_prices]`` (flag bit0), deadlines ``f8[n_rows]`` (flag bit1 —
  per-row budgets in SECONDS, overriding ``deadline_ms``);
- REPLY: status ``u1[n_rows]``, phi ``f4[n_rows]``, psi ``f4[n_rows]``,
  value ``f4[n_rows]`` (flag bit0);
- METRICS: empty = a live-scrape request; else the UTF-8 Prometheus text
  exposition of the serving process's registry;
- HEALTH: empty (or a JSON options object — ``{"dump_flight": true}``
  additionally dumps the gateway's armed flight recorder, the doctor
  hook; a plain probe never writes) = a request; the answer is a JSON
  health document (draining flag, session count, ledgers, flight-ring
  state);
- ERROR: the UTF-8 message (flag-speak: it names the field to fix);
- PING/PONG: empty;
- HELLO: the 16-byte session token to RESUME (empty = new session);
- WELCOME: the session token the gateway speaks for this connection;
- BUSY: optional UTF-8 advisory — the frame named by ``seq`` was NOT
  admitted (backpressure: slow down and resend it, nothing was shed);
- REDIRECT: ``host:port`` of the successor gateway — the frame named by
  ``seq`` was NOT admitted; reconnect there and replay.

**Compatibility**: v1 frames are still accepted and answered with v1
replies — a v1 producer keeps working, it just gets no sequencing and
therefore no reconnect-replay/dedup guarantees. Delivery guarantees start
at the HELLO/RESUME handshake and ``seq``-bearing v2 frames (the JAX
package's ``serve/client.py`` is the reference producer; the port's gateway
and client are not ported yet).

The frame is self-describing in length: a decoder knows the exact payload
size from the header, and ANY mismatch (bad magic, unknown version/kind/
dtype, truncated or oversized payload, absurd row count) is refused with a
:class:`WireError` whose message is what the gateway ships back in a
structured ERROR frame — a malformed frame never reaches the batcher.
Transport framing (the ``u4`` length prefix on the socket) belongs to the
gateway; this module sees complete frame buffers.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from orp_tpu_torch.serve.ingest import BlockResult

MAGIC = b"ORPI"
#: the current protocol: v2 = v1 + the seq/handshake delivery extension
VERSION = 2
V1 = 1

KIND_REQUEST = 1
KIND_REPLY = 2
KIND_ERROR = 3
KIND_PING = 4
KIND_PONG = 5
KIND_HELLO = 6
KIND_WELCOME = 7
KIND_BUSY = 8
KIND_REDIRECT = 9
KIND_METRICS = 10
KIND_HEALTH = 11

_KIND_NAMES = {KIND_REQUEST: "request", KIND_REPLY: "reply",
               KIND_ERROR: "error", KIND_PING: "ping", KIND_PONG: "pong",
               KIND_HELLO: "hello", KIND_WELCOME: "welcome",
               KIND_BUSY: "busy", KIND_REDIRECT: "redirect",
               KIND_METRICS: "metrics", KIND_HEALTH: "health"}
#: kinds that exist only in the v2 protocol (always seq-bearing frames)
_V2_KINDS = frozenset({KIND_HELLO, KIND_WELCOME, KIND_BUSY, KIND_REDIRECT,
                       KIND_METRICS, KIND_HEALTH})

DTYPE_F32 = 1
_DTYPES = {DTYPE_F32: np.dtype("<f4")}

FLAG_PRICES = 1     # request: a prices column follows the features
FLAG_DEADLINES = 2  # request: a per-row f8 deadline column closes the frame
FLAG_VALUE = 1      # reply: the value column is present
#: bit 2, both directions: a 16-byte trace extension sits between the
#: header and the payload columns. REQUEST: ``<u8 trace_id, u8 parent_span>``
#: (the Dapper context the producer stamps). REPLY: ``<u8 trace_id,
#: f4 queue_age_s, f4 dispatch_s>`` — the compact server-timing block the
#: gateway returns. Flag-gated: an untraced frame is BYTE-IDENTICAL to the
#: pre-trace wire (v1 and seq-only v2 encodes unchanged).
FLAG_TRACE = 4

_TRACE_REQ = struct.Struct("<QQ")    # trace_id, parent_span
_TRACE_REPLY = struct.Struct("<Qff")  # trace_id, queue_age_s, dispatch_s
TRACE_BYTES = _TRACE_REQ.size         # 16, both directions

TENANT_BYTES = 16
#: session tokens are fixed-width like the tenant field: 16 ASCII bytes
TOKEN_BYTES = 16
#: refuse absurd frames before allocating anything for them
MAX_ROWS = 1 << 24
MAX_COLS = 1 << 16

_V1_FIELDS = [
    ("magic", "S4"),
    ("version", "<u1"),
    ("kind", "<u1"),
    ("dtype_tag", "<u1"),
    ("flags", "<u1"),
    ("tenant", f"S{TENANT_BYTES}"),
    ("date_idx", "<i4"),
    ("n_rows", "<u4"),
    ("n_features", "<u4"),
    ("n_prices", "<u4"),
    ("deadline_ms", "<f8"),
]
HEADER = np.dtype(_V1_FIELDS)
HEADER_BYTES = HEADER.itemsize  # 48
# v2 = the v1 layout verbatim + the delivery extension, so a v2 decoder can
# sniff the version from the common prefix before committing to a width
HEADER_V2 = np.dtype(_V1_FIELDS + [("seq", "<u8"), ("reserved", "<u8")])
HEADER_V2_BYTES = HEADER_V2.itemsize  # 64


class WireError(ValueError):
    """A frame this codec refuses — malformed, truncated, or from a future
    version. The message is flag-speak (it names what to fix) and is what
    the gateway returns in a structured ERROR frame."""


def _header(kind: int, *, dtype_tag: int = DTYPE_F32, flags: int = 0,
            tenant: str = "", date_idx: int = 0, n_rows: int = 0,
            n_features: int = 0, n_prices: int = 0,
            deadline_ms: float = float("nan"),
            seq: int | None = None) -> bytes:
    """``seq=None`` emits the v1 48-byte header (the pre-sequencing wire,
    still what un-handshaken producers speak); any integer ``seq`` emits
    the 64-byte v2 header carrying it."""
    t = tenant.encode("ascii")
    if len(t) > TENANT_BYTES:
        raise WireError(
            f"tenant {tenant!r} exceeds the wire's {TENANT_BYTES}-byte "
            "field — use a shorter tenant name")
    v2 = seq is not None or kind in _V2_KINDS
    h = np.zeros(1, HEADER_V2 if v2 else HEADER)
    h["magic"] = MAGIC
    h["version"] = VERSION if v2 else V1
    h["kind"] = kind
    h["dtype_tag"] = dtype_tag
    h["flags"] = flags
    h["tenant"] = t
    h["date_idx"] = int(date_idx)
    h["n_rows"] = int(n_rows)
    h["n_features"] = int(n_features)
    h["n_prices"] = int(n_prices)
    h["deadline_ms"] = deadline_ms
    if v2:
        h["seq"] = int(seq or 0)
    return h.tobytes()


# -- encode -------------------------------------------------------------------


def encode_request(tenant: str, date_idx: int, states, prices=None,
                   deadlines=None, *, deadline_ms: float | None = None,
                   seq: int | None = None,
                   trace: tuple[int, int] | None = None) -> bytes:
    """One request block as a frame: columns in, bytes out — no per-row
    work. ``deadlines`` (per-row budgets, seconds) ships as an f8 column;
    ``deadline_ms`` is the cheaper block-level budget when every row shares
    one. ``seq`` (v2): the per-connection frame id a handshaken producer
    stamps — ``None`` emits a v1 frame, byte-identical to the old wire.
    ``trace``: an optional ``(trace_id, parent_span)`` pair of u64s
    (``obs.new_trace()``) carried in-band as a 16-byte extension between
    header and columns — the Dapper context the serving chain links its
    spans under. ``None`` adds no bytes and no flag."""
    feats = np.ascontiguousarray(np.atleast_2d(np.asarray(states)),
                                 dtype="<f4")
    n, f = feats.shape
    parts = [feats.tobytes()]
    flags = 0
    n_prices = 0
    if trace is not None:
        flags |= FLAG_TRACE
        parts.insert(0, _TRACE_REQ.pack(int(trace[0]) & (1 << 64) - 1,
                                        int(trace[1]) & (1 << 64) - 1))
    if prices is not None:
        pr = np.ascontiguousarray(np.atleast_2d(np.asarray(prices)),
                                  dtype="<f4")
        if pr.shape[0] != n:
            raise WireError(
                f"prices column has {pr.shape[0]} rows, features {n} — a "
                "frame carries one row set")
        flags |= FLAG_PRICES
        n_prices = pr.shape[1]
        parts.append(pr.tobytes())
    if deadlines is not None:
        col = np.ascontiguousarray(
            np.broadcast_to(np.asarray(deadlines, "<f8"), (n,)))
        flags |= FLAG_DEADLINES
        parts.append(col.tobytes())
    head = _header(KIND_REQUEST, flags=flags, tenant=tenant,
                   date_idx=date_idx, n_rows=n, n_features=f,
                   n_prices=n_prices,
                   deadline_ms=(float("nan") if deadline_ms is None
                                else float(deadline_ms)),
                   seq=seq)
    return b"".join([head, *parts])


def encode_reply(result: BlockResult, *, date_idx: int = 0,
                 seq: int | None = None,
                 timing: tuple[int, float, float] | None = None) -> bytes:
    """A BlockResult as a frame: the status column plus the contiguous
    phi/psi(/value) columns, straight ``tobytes``. ``seq`` echoes the
    request's frame id (v2) so a pipelining producer can ack out of
    order. ``timing``: the compact server-timing block of a TRACED frame —
    ``(trace_id, queue_age_s, dispatch_s)``, 16 bytes between header and
    columns (flag-gated; ``None`` leaves the frame byte-identical to the
    pre-trace wire)."""
    n = result.n_rows
    flags = FLAG_VALUE if result.value is not None else 0
    parts = [
        np.ascontiguousarray(result.status, "u1").tobytes(),
        np.ascontiguousarray(result.phi, "<f4").tobytes(),
        np.ascontiguousarray(result.psi, "<f4").tobytes(),
    ]
    if result.value is not None:
        parts.append(np.ascontiguousarray(result.value, "<f4").tobytes())
    if timing is not None:
        flags |= FLAG_TRACE
        parts.insert(0, _TRACE_REPLY.pack(int(timing[0]) & (1 << 64) - 1,
                                          float(timing[1]),
                                          float(timing[2])))
    head = _header(KIND_REPLY, flags=flags, date_idx=date_idx, n_rows=n,
                   seq=seq)
    return b"".join([head, *parts])


def encode_error(message: str, *, seq: int | None = None) -> bytes:
    """A structured refusal: the flag-speak message as the payload. ``seq``
    scopes it to one frame (that frame failed, the connection is fine);
    without it the refusal is connection-level."""
    body = message.encode("utf-8")
    return _header(KIND_ERROR, seq=seq) + body


def encode_ping() -> bytes:
    return _header(KIND_PING)


def encode_pong() -> bytes:
    return _header(KIND_PONG)


def encode_hello(token: bytes = b"") -> bytes:
    """The v2 handshake opener: an empty token asks for a NEW session, a
    previous WELCOME's token RESUMES it (the reconnect-replay path)."""
    if token and len(token) != TOKEN_BYTES:
        raise WireError(
            f"session token is {len(token)} bytes; HELLO carries either an "
            f"empty token (new session) or a {TOKEN_BYTES}-byte one (resume)")
    return _header(KIND_HELLO, seq=0) + bytes(token)


def encode_welcome(token: bytes, last_seq: int) -> bytes:
    """The handshake answer: the session token (save it for RESUME) and, in
    the seq field, the session's highest ADMITTED frame id — informational:
    a correct producer replays every unacknowledged frame regardless, and
    the dedup window answers the already-served ones from cache."""
    if len(token) != TOKEN_BYTES:
        raise WireError(f"WELCOME token must be {TOKEN_BYTES} bytes, got "
                        f"{len(token)}")
    return _header(KIND_WELCOME, seq=int(last_seq)) + bytes(token)


def encode_busy(seq: int, message: str = "") -> bytes:
    """Backpressure, not shedding: frame ``seq`` was NOT admitted — the
    producer should slow down and resend it; no rows died."""
    return _header(KIND_BUSY, seq=int(seq)) + message.encode("utf-8")


def encode_redirect(host: str, port: int, *, seq: int = 0) -> bytes:
    """Drain-and-redirect: frame ``seq`` was NOT admitted; reconnect to
    ``host:port`` (the successor gateway) and replay there."""
    return _header(KIND_REDIRECT, seq=int(seq)) + \
        f"{host}:{int(port)}".encode("utf-8")


def encode_metrics(text: str = "") -> bytes:
    """The live-scrape kind: an empty payload ASKS the gateway for its
    metrics; the answer carries the Prometheus text exposition of the
    serving process's registry — ``metrics.prom`` from the LIVE process,
    no exit required."""
    return _header(KIND_METRICS, seq=0) + text.encode("utf-8")


def encode_health(payload: dict | None = None) -> bytes:
    """The health kind: an empty payload ASKS; the answer is a compact
    JSON health document (draining flag, session count, cumulative
    ledgers, flight-ring state). A HEALTH request also triggers the
    gateway's flight-recorder dump when one is armed — the ``orp doctor``
    black-box hook."""
    body = b"" if payload is None else json.dumps(payload).encode("utf-8")
    return _header(KIND_HEALTH, seq=0) + body


# -- decode -------------------------------------------------------------------


def _decode_header(buf) -> tuple[np.void, int]:
    """Parse the version-appropriate header; returns ``(header, off)`` where
    ``off`` is the payload offset (48 for v1, 64 for v2)."""
    if len(buf) < HEADER_BYTES:
        raise WireError(
            f"frame of {len(buf)} bytes is shorter than the {HEADER_BYTES}-"
            "byte orp-ingest header")
    h = np.frombuffer(buf, HEADER, count=1)[0]
    if bytes(h["magic"]) != MAGIC:
        raise WireError(
            f"bad magic {bytes(h['magic'])!r}; this endpoint speaks "
            "orp-ingest frames (magic b'ORPI')")
    ver = int(h["version"])
    if ver not in (V1, VERSION):
        raise WireError(
            f"frame version {ver} is not v1/v2; upgrade the older side of "
            "this connection")
    if ver == VERSION:
        if len(buf) < HEADER_V2_BYTES:
            raise WireError(
                f"v2 frame of {len(buf)} bytes is shorter than the "
                f"{HEADER_V2_BYTES}-byte v2 header")
        h = np.frombuffer(buf, HEADER_V2, count=1)[0]
    kind = int(h["kind"])
    if kind not in _KIND_NAMES:
        raise WireError(f"unknown frame kind {kind}")
    if ver == V1 and kind in _V2_KINDS:
        raise WireError(
            f"{_KIND_NAMES[kind]} frames exist only in orp-ingest-v2; "
            "stamp version 2")
    return h, (HEADER_V2_BYTES if ver == VERSION else HEADER_BYTES)


def decode_kind(buf) -> int:
    """Validate the header and return the frame kind — the gateway's one
    branch point per frame."""
    return int(_decode_header(buf)[0]["kind"])


def frame_seq(buf) -> int:
    """The frame's sequence id — 0 for v1 frames (no delivery guarantees)."""
    h, off = _decode_header(buf)
    return int(h["seq"]) if off == HEADER_V2_BYTES else 0


def frame_meta(buf) -> tuple[int, int]:
    """``(kind, seq)`` in ONE header parse — the gateway/client per-frame
    branch point (``decode_kind`` + ``frame_seq`` would validate the same
    header twice on a path whose thesis is minimal per-frame Python)."""
    h, off = _decode_header(buf)
    return (int(h["kind"]),
            int(h["seq"]) if off == HEADER_V2_BYTES else 0)


def _expect(buf, expected: int, what: str) -> None:
    if len(buf) != expected:
        raise WireError(
            f"{what} frame is {len(buf)} bytes, expected {expected} from "
            "its own header — truncated or corrupt")


def decode_request(buf) -> dict:
    """Decode a REQUEST frame into the ``submit_block`` arguments:
    ``{"tenant", "date_idx", "states", "prices", "deadlines", "seq"}``
    (``seq`` 0 for v1 frames). Columns are zero-copy read-only views over
    ``buf`` (the engine pads from them without writing). Any malformation
    raises :class:`WireError` with the field to fix."""
    h, off0 = _decode_header(buf)
    if int(h["kind"]) != KIND_REQUEST:
        raise WireError(
            f"expected a request frame, got {_KIND_NAMES[int(h['kind'])]}")
    dt = _DTYPES.get(int(h["dtype_tag"]))
    if dt is None:
        raise WireError(
            f"unknown dtype tag {int(h['dtype_tag'])}; this build serves "
            f"{sorted(_DTYPES)} (1 = float32)")
    n = int(h["n_rows"])
    f = int(h["n_features"])
    k = int(h["n_prices"])
    flags = int(h["flags"])
    if not 1 <= n <= MAX_ROWS:
        raise WireError(
            f"n_rows={n} outside [1, {MAX_ROWS}] — split the block")
    if not 1 <= f <= MAX_COLS:
        raise WireError(f"n_features={f} outside [1, {MAX_COLS}]")
    has_prices = bool(flags & FLAG_PRICES)
    if has_prices and not 1 <= k <= MAX_COLS:
        raise WireError(f"n_prices={k} outside [1, {MAX_COLS}] with the "
                        "prices flag set")
    if not has_prices and k:
        raise WireError(f"n_prices={k} without the prices flag — set flag "
                        "bit0 or zero the count")
    has_deadlines = bool(flags & FLAG_DEADLINES)
    has_trace = bool(flags & FLAG_TRACE)
    expected = (off0 + (TRACE_BYTES if has_trace else 0) + 4 * n * f
                + (4 * n * k if has_prices else 0)
                + (8 * n if has_deadlines else 0))
    _expect(buf, expected, "request")
    off = off0
    trace = None
    if has_trace:
        trace = _TRACE_REQ.unpack_from(buf, off)
        off += TRACE_BYTES
    states = np.frombuffer(buf, dt, count=n * f, offset=off).reshape(n, f)
    off += 4 * n * f
    prices = None
    if has_prices:
        prices = np.frombuffer(buf, dt, count=n * k, offset=off).reshape(n, k)
        off += 4 * n * k
    deadlines = None
    if has_deadlines:
        deadlines = np.frombuffer(buf, "<f8", count=n, offset=off)
    elif np.isfinite(h["deadline_ms"]):
        deadlines = float(h["deadline_ms"]) / 1e3
    try:
        tenant = bytes(h["tenant"]).rstrip(b"\x00").decode("ascii")
    except UnicodeDecodeError:
        # a flipped tenant byte must refuse like every other malformation —
        # as a WireError the gateway answers, never as a handler-killing
        # UnicodeDecodeError (found by the wire fuzz suite)
        raise WireError(
            "tenant field is not ASCII — corrupt frame or wrong encoder"
        ) from None
    return {
        "tenant": tenant,
        "date_idx": int(h["date_idx"]),
        "states": states,
        "prices": prices,
        "deadlines": deadlines,
        "seq": int(h["seq"]) if off0 == HEADER_V2_BYTES else 0,
        "trace": trace,
    }


def decode_reply(buf) -> BlockResult:
    """Decode a REPLY frame back into a :class:`BlockResult` (read-only
    column views)."""
    h, off = _decode_header(buf)
    if int(h["kind"]) == KIND_ERROR:
        raise WireError(decode_error(buf))
    if int(h["kind"]) != KIND_REPLY:
        raise WireError(
            f"expected a reply frame, got {_KIND_NAMES[int(h['kind'])]}")
    n = int(h["n_rows"])
    if not 1 <= n <= MAX_ROWS:
        raise WireError(f"n_rows={n} outside [1, {MAX_ROWS}]")
    has_value = bool(int(h["flags"]) & FLAG_VALUE)
    has_trace = bool(int(h["flags"]) & FLAG_TRACE)
    expected = (off + (TRACE_BYTES if has_trace else 0)
                + n * (1 + 4 + 4 + (4 if has_value else 0)))
    _expect(buf, expected, "reply")
    timing = None
    if has_trace:
        _tid, queue_s, dispatch_s = _TRACE_REPLY.unpack_from(buf, off)
        timing = (float(queue_s), float(dispatch_s))
        off += TRACE_BYTES
    status = np.frombuffer(buf, "u1", count=n, offset=off)
    off += n
    phi = np.frombuffer(buf, "<f4", count=n, offset=off)
    off += 4 * n
    psi = np.frombuffer(buf, "<f4", count=n, offset=off)
    off += 4 * n
    value = (np.frombuffer(buf, "<f4", count=n, offset=off)
             if has_value else None)
    return BlockResult(phi=phi, psi=psi, value=value, status=status,
                       timing=timing)


def _payload(buf, kind: int, what: str) -> bytes:
    h, off = _decode_header(buf)
    if int(h["kind"]) != kind:
        raise WireError(
            f"expected a {what} frame, got {_KIND_NAMES[int(h['kind'])]}")
    return bytes(buf[off:])


def decode_error(buf) -> str:
    """The flag-speak message of an ERROR frame."""
    return _payload(buf, KIND_ERROR, "error").decode("utf-8",
                                                     errors="replace")


def decode_hello(buf) -> bytes:
    """The HELLO's session token (``b""`` = new session)."""
    token = _payload(buf, KIND_HELLO, "hello")
    if token and len(token) != TOKEN_BYTES:
        raise WireError(
            f"HELLO token is {len(token)} bytes; expected 0 (new session) "
            f"or {TOKEN_BYTES} (resume)")
    return token


def decode_welcome(buf) -> tuple[bytes, int]:
    """``(session_token, last_admitted_seq)`` from a WELCOME frame."""
    h, off = _decode_header(buf)
    if int(h["kind"]) != KIND_WELCOME:
        raise WireError(
            f"expected a welcome frame, got {_KIND_NAMES[int(h['kind'])]}")
    token = bytes(buf[off:])
    if len(token) != TOKEN_BYTES:
        raise WireError(
            f"WELCOME token is {len(token)} bytes, expected {TOKEN_BYTES}")
    return token, int(h["seq"])


def decode_busy(buf) -> tuple[int, str]:
    """``(refused_seq, advisory_message)`` from a BUSY frame."""
    h, off = _decode_header(buf)
    if int(h["kind"]) != KIND_BUSY:
        raise WireError(
            f"expected a busy frame, got {_KIND_NAMES[int(h['kind'])]}")
    return int(h["seq"]), bytes(buf[off:]).decode("utf-8", errors="replace")


def decode_metrics(buf) -> str:
    """The Prometheus text of a METRICS frame (empty = a scrape request)."""
    return _payload(buf, KIND_METRICS, "metrics").decode("utf-8",
                                                         errors="replace")


def decode_health(buf) -> dict:
    """The JSON health document of a HEALTH frame (``{}`` = a probe
    request). A payload that does not parse as a JSON object refuses with
    :class:`WireError` like every other malformation — never a raw
    JSONDecodeError out of the codec (the fuzz contract)."""
    body = _payload(buf, KIND_HEALTH, "health")
    if not body:
        return {}
    try:
        doc = json.loads(body.decode("utf-8", errors="replace"))
    except json.JSONDecodeError:
        raise WireError(
            "health payload is not valid JSON — corrupt frame or a "
            "non-orp endpoint") from None
    if not isinstance(doc, dict):
        raise WireError(
            f"health payload decodes to {type(doc).__name__}, expected a "
            "JSON object")
    return doc


def decode_redirect(buf) -> tuple[str, int, int]:
    """``(host, port, refused_seq)`` from a REDIRECT frame."""
    h, off = _decode_header(buf)
    if int(h["kind"]) != KIND_REDIRECT:
        raise WireError(
            f"expected a redirect frame, got {_KIND_NAMES[int(h['kind'])]}")
    target = bytes(buf[off:]).decode("utf-8", errors="replace")
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        raise WireError(
            f"REDIRECT names {target!r}; expected host:port of the "
            "successor gateway")
    return host, int(port), int(h["seq"])
