"""The socket gateway (counterpart of ``orp_tpu/serve/gateway.py``): a
delivery-guaranteed ingest front over ``ServeHost``.

Requests arrive over TCP as ``orp-ingest`` frames (``serve/wire.py``,
byte-identical to the JAX package's, so either package's clients speak to
either package's gateway), and the whole per-frame Python bill is

    decode (header check + 3 buffer views)
    → ``ServeHost.submit_block`` (one lock pass, one future)
    → encode (status/phi/psi/value ``tobytes``)

amortized over every row in the block. The decoded columns are read-only
numpy views over the received bytes; the engine copies them into its padded
bucket before anything reaches ``torch``, so no tensor aliases a frame.

On the card the host's batchers launch the kernels from their own worker
threads; the gateway's threads (an acceptor, one handler per connection, a
writer per connection) only decode, submit and encode.

**Delivery guarantees (orp-ingest-v2).** Every robustness feature below the
process boundary (guard's deadlines, shedding, device-loss replay) used to
stop at the socket: a dropped connection, a stalled mid-frame client or a
gateway restart silently lost in-flight rows with no way for the producer
to know which. The v2 protocol closes that gap:

- **sessions** — a HELLO/RESUME handshake binds a connection to a session
  token; sequenced REQUEST frames (monotonically increasing per-session
  ``seq``) are deduplicated against the session's admitted window, so a
  reconnecting producer replaying unacknowledged frames gets
  at-least-once-SUBMIT / exactly-once-SERVE semantics: a frame already
  answered is re-answered from a bounded **reply cache**, a frame still in
  flight is adopted (its reply lands on the new connection), and only a
  genuinely new frame reaches the batcher.
- **frame deadline** — a peer holding a HALF-WRITTEN frame past
  ``frame_deadline_s`` is answered with an ERROR frame and reset
  (``serve/gateway_errors{stage="stall"}``), freeing the handler; other
  connections' frames keep serving throughout (one handler thread per
  connection).
- **backpressure** — past ``max_inflight_replies`` unanswered frames on
  one connection, the next frame is refused with a structured BUSY frame
  (the producer is told to slow down and resend; distinct from watermark
  shed, where rows died by policy).
- **drain-and-redirect** — ``close(successor=(host, port))`` answers NEW
  frames with a REDIRECT frame naming the successor while in-flight frames
  finish, so two gateway processes hand off a live producer with zero lost
  rows.

``GatewayClient`` is the minimal v1 reference client (one frame in flight,
no replay); ``serve/client.py::ResilientGatewayClient`` is the v2 producer
that turns these primitives into reconnect-replay delivery.
"""

from __future__ import annotations

import collections
import secrets
import socket
import struct
import threading
import time

from orp_tpu_torch.guard import inject
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import emit_trace_span, flight, prometheus_text
from orp_tpu_torch.obs import state as obs_state
from orp_tpu_torch.serve import wire
from orp_tpu_torch.serve.batcher import SlimFuture
from orp_tpu_torch.serve.ingest import BlockResult

_LEN = struct.Struct("<I")
#: transport-level ceiling on one frame (the wire's own MAX_ROWS is the
#: semantic cap; this one bounds the recv allocation before decoding)
MAX_FRAME_BYTES = 1 << 28


class GatewayError(RuntimeError):
    """The server answered with a structured ERROR frame; the message is
    the server's flag-speak refusal."""


class FrameStall(wire.WireError):
    """A partial frame outlived the read deadline: the peer wrote some
    bytes and went silent. The connection is reset — the stream offset is
    unknowable — and a sequenced producer replays the frame on reconnect."""


def _recv_exact(sock: socket.socket, n: int, closed, clock=None,
                idle=None) -> bytes | None:
    """Read exactly ``n`` bytes, polling the drain flag between timeouts;
    None when the peer closed (or the gateway is draining).

    ``clock`` (``{"t0": float|None, "wall": float|None}``, shared across
    one frame's reads): ``t0`` is stamped at the frame's first byte and a
    partial read outliving ``wall`` seconds raises :class:`FrameStall` —
    an unbounded poll on a half-sent frame is impossible. ``idle`` is
    called on timeouts while NO frame is in progress (client-side
    housekeeping between replies)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if closed is not None and closed.is_set():
            return None
        if (clock is not None and clock["t0"] is not None
                and clock["wall"] is not None
                and time.perf_counter() - clock["t0"] > clock["wall"]):
            raise FrameStall(  # orp: noqa[ORP016] -- the catcher emits: the handler's stall eviction counts serve/gateway_errors{stage=stall} + the flight record with the stall wall
                f"partial frame stalled past the {clock['wall'] * 1e3:.0f}ms "
                "frame deadline — resetting the connection (a sequenced "
                "client replays the frame on reconnect)")
        try:
            k = sock.recv_into(view[got:], n - got)  # orp: noqa[ORP014] -- the socket's poll timeout is set at accept/connect; `clock` bounds a partial frame
        except socket.timeout:
            if closed is None and clock is None and idle is None:
                raise  # a caller with no polling contract wants its timeout
            if idle is not None and (clock is None or clock["t0"] is None):
                idle()
            continue
        except OSError:
            return None
        if k == 0:
            return None
        got += k
        if clock is not None and clock["t0"] is None:
            clock["t0"] = time.perf_counter()
    return bytes(buf)


def _send_frame(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(_LEN.pack(len(frame)) + frame)  # orp: noqa[ORP014] -- every socket entering this helper had settimeout applied at accept/connect


def _recv_frame(sock: socket.socket, closed=None,
                max_bytes: int = MAX_FRAME_BYTES, *,
                deadline_s: float | None = None,
                idle=None) -> bytes | None:
    """One length-prefixed frame off the stream. ``deadline_s`` starts at
    the frame's FIRST byte (length prefix included): a peer that begins a
    frame must finish it inside the deadline or the read raises
    :class:`FrameStall`. An idle connection (no bytes at all) waits
    forever — silence between frames is a healthy producer."""
    clock = (None if deadline_s is None and idle is None
             else {"t0": None, "wall": deadline_s})
    head = _recv_exact(sock, _LEN.size, closed, clock=clock, idle=idle)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > max_bytes:
        raise wire.WireError(
            f"frame length {n} exceeds the {max_bytes}-byte transport cap "
            "— split the block")
    return _recv_exact(sock, n, closed, clock=clock)


def _chain(relay: SlimFuture, fut) -> None:
    """Copy a resolved block future into the session's relay future (the
    adoptable pending entry installed at claim time)."""
    err = fut.exception()
    if relay.set_running_or_notify_cancel():
        if err is not None:
            relay.set_exception(err)
        else:
            relay.set_result(fut.result())


class _Session:
    """One producer's delivery window, independent of any connection: the
    highest admitted seq, the in-flight futures, and the bounded cache of
    encoded replies that answers replayed duplicates without re-dispatch."""

    __slots__ = ("token", "lock", "last_seq", "pending", "replies",
                 "evicted_below", "rows", "frames", "replayed_from_cache")

    def __init__(self, token: bytes):
        self.token = token
        self.lock = threading.Lock()
        self.last_seq = 0                        # highest ADMITTED seq
        self.pending: dict[int, tuple] = {}      # seq -> (future, date_idx)
        self.replies: collections.OrderedDict[int, bytes] = \
            collections.OrderedDict()            # seq -> encoded reply frame
        # seqs below this left the reply cache: the one frame class the
        # window can no longer answer (a frame BELOW it that is neither
        # cached nor pending was served and forgotten)
        self.evicted_below = 1
        self.rows = 0
        self.frames = 0
        self.replayed_from_cache = 0


class _Conn:
    """Per-connection handler state: the socket, its send lock, the bound
    session, the in-flight reply count the BUSY bound acts on, and the
    reply outbox its lazy writer thread drains (block replies must never
    be sent from the batcher's resolving thread — a consumer that stops
    reading would stall the dispatch loop for every tenant)."""

    __slots__ = ("sock", "send_lock", "lock", "session", "inflight", "stats",
                 "outbox", "cv", "writer", "dead")

    def __init__(self, sock, stats):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.lock = threading.Lock()
        self.session: _Session | None = None
        self.inflight = 0
        self.stats = stats
        self.outbox: collections.deque[bytes] = collections.deque()
        self.cv = threading.Condition()
        self.writer: threading.Thread | None = None
        self.dead = False


class ServeGateway:
    """Length-prefixed TCP front over a :class:`~orp_tpu_torch.serve.host.ServeHost`.

    ``host``           — the multi-tenant host that serves decoded blocks.
    ``addr``/``port``  — bind address (``port=0`` picks a free port; read
    it back from :attr:`address`).
    ``default_tenant`` — tenant for frames whose tenant field is empty.
    ``reply_timeout_s`` — bound on waiting for a v1 block's future (a stuck
    block answers the CONNECTION with an ERROR frame instead of wedging
    the handler forever).
    ``frame_deadline_s`` — partial-frame read deadline: a peer that began
    a frame and stalls past it is answered with an ERROR frame and reset.
    ``max_inflight_replies`` — per-connection unanswered-frame bound; past
    it sequenced frames are refused with BUSY (backpressure, not shed).
    ``reply_cache``    — per-session encoded-reply window answering
    replayed duplicates (size it ≥ the producer's replay window).

    Per-connection observability: ``serve/gateway_connections`` (opened),
    ``serve/gateway_frames{kind}``, ``serve/gateway_rows``,
    ``serve/gateway_errors{stage}``, ``serve/gateway_busy``,
    ``serve/gateway_redirects``, ``serve/gateway_replays`` counters, plus
    :meth:`stats` (live per-connection ledgers) and :meth:`totals` (the
    cumulative ledger, retired connections included — two draining
    gateways' ``totals()["rows"]`` sum to the rows the fleet served).

    The telemetry plane: METRICS/HEALTH wire kinds answer the LIVE
    Prometheus exposition (:meth:`metrics_text`) and the JSON health
    document (:meth:`health_report` — which also dumps the armed flight
    recorder, the doctor hook); trace-stamped frames (``FLAG_TRACE``)
    leave decode/encode segment spans here and queue/dispatch/resolve
    spans in the batcher, all under the producer's trace id, with the
    compact server-timing block returned in the reply's trace extension.
    """

    def __init__(self, host, *, addr: str = "127.0.0.1", port: int = 0,
                 default_tenant: str | None = None, backlog: int = 16,
                 reply_timeout_s: float = 60.0,
                 frame_deadline_s: float | None = 30.0,
                 max_inflight_replies: int = 8,
                 reply_cache: int = 64,
                 max_sessions: int = 256,
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        self.host = host
        self.default_tenant = default_tenant
        self.reply_timeout_s = float(reply_timeout_s)
        self.frame_deadline_s = (None if frame_deadline_s is None
                                 else float(frame_deadline_s))
        self.max_inflight_replies = int(max_inflight_replies)
        self.reply_cache = int(reply_cache)
        self.max_sessions = int(max_sessions)
        self.max_frame_bytes = int(max_frame_bytes)
        self._closed = threading.Event()
        self._draining = threading.Event()
        self.aborted = threading.Event()
        self._redirect: tuple[str, int] | None = None
        self._lock = threading.Lock()
        self._conns: dict[int, dict] = {}
        self._csocks: dict[int, socket.socket] = {}
        self._handlers: list[threading.Thread] = []
        self._next_conn = 0
        self._sessions: collections.OrderedDict[bytes, _Session] = \
            collections.OrderedDict()
        self._retired = {"frames": 0, "rows": 0, "errors": 0}
        # retired connections keep their LIVE stats dicts for a while: a
        # frame admitted on a connection that then died settles its row
        # count from the resolve callback AFTER the handler retired — a
        # snapshot-at-retire would lose those rows from totals() (the
        # fleet-handoff row-sum contract). Folded into _retired only once
        # old enough that every callback has long settled.
        self._recent_retired: collections.deque = collections.deque()
        self._submitted_frames = 0
        # replies mid-callback (pending already deleted, send not yet done):
        # the drain must wait these out too, or close() can cut a reply off
        # between the pending-delete and its send
        self._replying = 0
        # poll fine enough that a stall is caught soon after its deadline
        self._poll_s = (0.25 if self.frame_deadline_s is None
                        else min(0.25, max(0.005, self.frame_deadline_s / 5)))
        # pre-intern the core serve series into the host registry so a
        # LIVE scrape (METRICS wire kind / --metrics-port) always carries
        # them — a fresh gateway's exposition must be probe-able
        # (`orp doctor --metrics`) before the first frame arrives
        reg = host.registry
        reg.counter("serve/gateway_rows")
        reg.counter("guard/shed")
        # labelled like the batcher's real observations (obs_observe with
        # outcome="served") — an unlabeled twin would shadow the live
        # series in label-free quantile lookups (`orp top`)
        reg.histogram("serve/queue_age_seconds", {"outcome": "served"})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((addr, int(port)))
        self._sock.listen(backlog)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="orp-serve-gateway", daemon=True)
        self._acceptor.start()

    # -- accept / serve ------------------------------------------------------

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.25)
        while not self._closed.is_set() and not self._draining.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: the drain path
            conn.settimeout(self._poll_s)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = self._next_conn
                self._next_conn += 1
                self._conns[cid] = {"peer": f"{peer[0]}:{peer[1]}",
                                    "frames": 0, "rows": 0, "errors": 0}
                self._csocks[cid] = conn
                t = threading.Thread(
                    target=self._serve_conn, args=(conn, cid),
                    name=f"orp-gateway-conn-{cid}", daemon=True)
                # prune finished handlers so a long-lived gateway's ledger
                # stays O(live connections)
                self._handlers = [h for h in self._handlers if h.is_alive()]
                self._handlers.append(t)
            obs_count("serve/gateway_connections")
            t.start()

    def _serve_conn(self, conn: socket.socket, cid: int) -> None:
        # the accept loop registers cid under _lock before starting this
        # thread; take the same lock for the lookup so the read is ordered
        # against concurrent registrations mutating the dict
        with self._lock:
            stats = self._conns[cid]
        st = _Conn(conn, stats)
        try:
            while not self._closed.is_set():
                try:
                    frame = _recv_frame(conn, self._closed,
                                        self.max_frame_bytes,
                                        deadline_s=self.frame_deadline_s)
                except FrameStall as e:
                    # the stalled-reader eviction: answer, reset, free the
                    # handler — the stream offset is garbage past the tear
                    stats["errors"] += 1
                    obs_count("serve/gateway_errors", stage="stall")
                    flight.record("wire_error", stage="stall",
                                  peer=stats.get("peer"))
                    self._send_on(st, wire.encode_error(str(e)))
                    return
                except wire.WireError as e:
                    # transport-level refusal: answer, then close — past an
                    # oversized length prefix the stream offset is garbage
                    stats["errors"] += 1
                    obs_count("serve/gateway_errors", stage="transport")
                    flight.record("wire_error", stage="transport",
                                  peer=stats.get("peer"))
                    self._send_on(st, wire.encode_error(str(e)))
                    return
                if frame is None:
                    return  # peer closed (or drain): a clean end
                stats["frames"] += 1
                if not self._handle_frame(frame, st):
                    return
        finally:
            with st.cv:
                st.dead = True
                st.cv.notify_all()  # release the writer thread
            try:
                conn.close()
            except OSError:  # best-effort close of a dead socket; nothing to emit
                pass
            with self._lock:
                gone = self._conns.pop(cid, None)
                self._csocks.pop(cid, None)
                if gone is not None:
                    # keep the dict LIVE (late resolve callbacks still
                    # write rows into it); fold only well-settled ones
                    self._recent_retired.append(gone)
                    while len(self._recent_retired) > 1024:
                        old = self._recent_retired.popleft()
                        for k in ("frames", "rows", "errors"):
                            self._retired[k] += old[k]

    # -- frame handling ------------------------------------------------------

    def _handle_frame(self, frame: bytes, st: _Conn) -> bool:
        """One frame, any protocol version. Returns False when the
        connection must close (injected kill, reset-after-submit). Every
        per-frame failure mode becomes a structured ERROR frame in
        flag-speak; the connection survives anything the framing
        survived."""
        stats = st.stats
        try:
            kind, seq = wire.frame_meta(frame)
        except wire.WireError as e:
            stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="decode")
            self._send_on(st, wire.encode_error(str(e)))
            # a handshaken stream that yields an undecodable header is
            # desynced — reset it so the producer reconnects and replays
            # (the client treats a seq-less ERROR as connection poison)
            return st.session is None
        obs_count("serve/gateway_frames", kind=str(kind), sink_event=False)
        if kind == wire.KIND_PING:
            return self._send_on(st, wire.encode_pong())
        if kind == wire.KIND_METRICS:
            # the live scrape — answered even mid-drain: a draining
            # gateway's telemetry is exactly what an operator watches
            return self._send_on(st, wire.encode_metrics(
                self.metrics_text()))
        if kind == wire.KIND_HEALTH:
            try:
                ask = wire.decode_health(frame)
            except wire.WireError as e:
                st.stats["errors"] += 1
                obs_count("serve/gateway_errors", stage="decode")
                return self._send_on(st, wire.encode_error(str(e)))
            return self._send_on(st, wire.encode_health(self.health_report(
                dump_flight=bool(ask.get("dump_flight")),
                route=ask.get("route"))))
        if kind == wire.KIND_HELLO:
            return self._handle_hello(frame, st)
        if kind != wire.KIND_REQUEST:
            stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="decode")
            return self._send_on(st, wire.encode_error(
                "this endpoint takes request/ping/hello frames only",
                seq=seq or None))
        if self._draining.is_set():
            if self._closed.is_set():
                # aborted (abort() sets closed before draining, so a handler
                # that sees draining here after an abort sees closed too): a
                # dead process answers nothing. A draining ERROR would reach a
                # forwarding client as the producer's error, not as a dead
                # replica, and the fleet would fail the block instead of
                # re-routing it
                return False
            # drain-and-redirect: NEW frames go elsewhere, in-flight ones
            # finish and their replies flush — zero rows lost in the
            # handoff. REDIRECT is a v2-only kind: an unsequenced (v1)
            # producer gets the draining ERROR its decoder understands
            if self._redirect is not None and seq:
                obs_count("serve/gateway_redirects")
                return self._send_on(st, wire.encode_redirect(
                    *self._redirect, seq=seq))
            msg = ("gateway is draining — reconnect elsewhere and replay"
                   if self._redirect is None else
                   "gateway is draining — reconnect to "
                   f"{self._redirect[0]}:{self._redirect[1]}")
            return self._send_on(st, wire.encode_error(msg, seq=seq or None))
        if seq:
            return self._handle_request_v2(frame, seq, st)
        return self._handle_request_v1(frame, st)

    def _handle_hello(self, frame: bytes, st: _Conn) -> bool:
        try:
            token = wire.decode_hello(frame)
        except wire.WireError as e:
            st.stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="decode")
            return self._send_on(st, wire.encode_error(str(e)))
        if self._draining.is_set() and self._redirect is not None:
            obs_count("serve/gateway_redirects")
            return self._send_on(st, wire.encode_redirect(*self._redirect))
        with self._lock:
            sess = self._sessions.get(token) if token else None
            if sess is None:
                # adopt an unknown token verbatim (a successor gateway has
                # no state for a resumed session: the producer replays every
                # unacked frame and last_seq=0 admits them all)
                sess = _Session(token or secrets.token_hex(8).encode())
                self._sessions[sess.token] = sess
                while len(self._sessions) > self.max_sessions:
                    # prefer evicting a session with nothing in flight —
                    # killing one mid-frame silently voids its replay
                    # guarantee (racy len() read: a heuristic, not a gate)
                    victim = next(
                        (t for t, s in self._sessions.items()
                         if not s.pending and s is not sess), None)
                    if victim is None:
                        victim = next(t for t in self._sessions
                                      if t != sess.token)
                    del self._sessions[victim]
            else:
                self._sessions.move_to_end(token)
        st.session = sess
        return self._send_on(st, wire.encode_welcome(sess.token,
                                                     sess.last_seq))

    def _handle_request_v2(self, frame: bytes, seq: int, st: _Conn) -> bool:
        sess = st.session
        if sess is None:
            st.stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="route")
            return self._send_on(st, wire.encode_error(
                "sequenced frames need a HELLO handshake first — send HELLO "
                "(empty token) and use the WELCOME token to resume",
                seq=seq))
        # decode BEFORE the window check: a fresh frame must be CLAIMED
        # (pending entry installed) inside the same lock hold that
        # classified it, and the claim needs the decoded date
        t0 = time.perf_counter()
        try:
            req = wire.decode_request(frame)
        except wire.WireError as e:
            st.stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="decode")
            flight.record("wire_error", stage="decode", seq=seq)
            return self._send_on(st, wire.encode_error(str(e), seq=seq))
        trace = req["trace"]
        # decode wall captured now, EMITTED only for a FRESH frame (below):
        # a replayed or BUSY-resent frame decodes again but must not
        # duplicate its decode segment under the same trace id
        decode_s = time.perf_counter() - t0
        tenant = req["tenant"] or self.default_tenant
        if tenant is None:
            st.stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="route")
            return self._send_on(st, wire.encode_error(
                "frame names no tenant and the gateway has no default — "
                "set the tenant field or start with --tenant", seq=seq))
        # the dedup window, membership-based: a seq already CACHED answers
        # from the reply cache, one still PENDING adopts the in-flight
        # future, one below the eviction floor is unknowable — and anything
        # else is FRESH, whatever its ordering (a restarted gateway sees a
        # resumed producer's replay start mid-sequence; a BUSY-deferred
        # retransmit arrives after its successors; both are legitimate).
        # A fresh frame is claimed ATOMICALLY with its classification: the
        # relay future goes into pending inside the same lock hold, so a
        # replay racing in on another connection adopts the relay instead
        # of classifying fresh and double-dispatching the block
        relay = None
        with sess.lock:
            cached = sess.replies.get(seq)
            pending = sess.pending.get(seq) if cached is None else None
            if cached is not None or pending is not None:
                action = "replay"
            elif seq < sess.evicted_below:
                action = "evicted"
            else:
                with st.lock:
                    busy = st.inflight >= self.max_inflight_replies
                    if not busy:
                        st.inflight += 1
                if busy:
                    action = "busy"
                else:
                    action = "fresh"
                    relay = SlimFuture()
                    sess.pending[seq] = (relay, req["date_idx"], trace)
                    sess.last_seq = max(sess.last_seq, seq)
                    sess.frames += 1
        if action == "replay":
            # at-least-once-submit, exactly-once-serve
            obs_count("serve/gateway_replays")
            if cached is not None:
                with sess.lock:
                    sess.replayed_from_cache += 1
                return self._send_on(st, cached)
            # adopt the orphan: the frame was submitted on a connection
            # that died; its reply lands HERE when the block resolves
            fut, date_idx, a_trace = pending
            fut.add_done_callback(
                lambda f: self._reply_ready(sess, seq, date_idx, st, f,
                                            trace=a_trace))
            return True
        if action == "evicted":
            st.stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="sequence")
            return self._send_on(st, wire.encode_error(
                f"seq {seq} was served but evicted from the "
                f"{self.reply_cache}-frame reply cache — shrink the client "
                "replay window or grow the gateway's reply_cache", seq=seq))
        if action == "busy":
            # backpressure, not shedding: nothing was admitted, nothing died
            obs_count("serve/gateway_busy")
            flight.record("busy", seq=seq)
            return self._send_on(st, wire.encode_busy(
                seq, f"{self.max_inflight_replies} replies in flight on "
                     "this connection — wait for acks and resend"))
        if trace is not None:
            # the first serving-chain segment, once per ADMITTED frame
            emit_trace_span("trace/decode", trace[0], trace[1], decode_s,
                            attrs={"bytes": len(frame), "seq": seq})
        return self._submit_v2(req, seq, relay, sess, st)

    def _submit_v2(self, req: dict, seq: int, relay, sess: _Session,
                   st: _Conn) -> bool:
        """Dispatch a CLAIMED fresh frame: the relay future is already in
        the session's pending window (adoptable by replays), the host's
        block future chains into it."""
        date_idx = req["date_idx"]
        trace = req["trace"]
        relay.add_done_callback(
            lambda f: self._reply_ready(sess, seq, date_idx, st, f,
                                        claimer=True, trace=trace))
        tenant = req["tenant"] or self.default_tenant
        try:
            fut = self.host.submit_block(tenant, date_idx,
                                         req["states"], req["prices"],
                                         req["deadlines"], trace=trace)
        except Exception as e:  # emitted: _reply_ready counts it AND ships it as an ERROR frame
            relay.set_exception(e)
            return True
        with self._lock:
            self._submitted_frames += 1
            n_sub = self._submitted_frames
            # the session saw traffic: keep it off the LRU eviction edge
            # (HELLO-only refresh would evict the BUSIEST long-lived
            # session first, silently breaking its replay guarantee)
            if sess.token in self._sessions:
                self._sessions.move_to_end(sess.token)
        fut.add_done_callback(lambda f: _chain(relay, f))
        inj = inject.active()
        if inj is not None and inj.gateway_kill(n_sub):
            # the chaos drill's process death: frame k is ADMITTED (the
            # nastiest point — the producer will never see its reply and
            # must replay it against whatever comes up on this port next)
            self.abort()
            return False
        return True

    def _reply_ready(self, sess: _Session, seq: int, date_idx: int,
                     st: _Conn, fut, claimer: bool = False,
                     trace=None) -> None:
        """Done-callback of a sequenced block future: encode the reply ONCE
        into the session's cache, then hand it to ``st``'s writer thread (a
        dead connection just leaves it cached for the replay). Runs on the
        resolving thread — encode + enqueue only, so a slow consumer never
        stalls the dispatch loop. ``claimer`` marks the callback installed
        at claim time: EXACTLY that one settles the admitting connection's
        inflight/ledger accounting (an adopting connection's callback may
        resolve first, but it never incremented anything). The whole
        callback is bracketed by the ``_replying`` counter so a graceful
        drain waits the send out, not just the pending-delete."""
        with self._lock:
            self._replying += 1
        try:
            self._reply_ready_inner(sess, seq, date_idx, st, fut, claimer,
                                    trace)
        finally:
            with self._lock:
                self._replying -= 1

    def _reply_ready_inner(self, sess: _Session, seq: int, date_idx: int,
                           st: _Conn, fut, claimer: bool, trace) -> None:
        err = fut.exception()
        if err is not None:
            reply = wire.encode_error(f"{type(err).__name__}: {err}",
                                      seq=seq)
            n = 0
        else:
            result: BlockResult = fut.result()
            t0 = time.perf_counter()
            timing = None
            if trace is not None and result.timing is not None:
                # the compact server-timing block rides the reply's trace
                # extension back to the producer
                timing = (trace[0], *result.timing)
            reply = wire.encode_reply(result, date_idx=date_idx, seq=seq,
                                      timing=timing)
            n = result.n_rows
            if trace is not None and claimer:
                # the last serving-chain segment: reply encode wall. Only
                # the CLAIMER's callback emits it — an adopting replay's
                # racing callback re-encodes the same frame and would
                # duplicate the segment in the trace
                emit_trace_span("trace/encode", trace[0], trace[1],
                                time.perf_counter() - t0,
                                attrs={"rows": n, "seq": seq})
        with sess.lock:
            first = seq in sess.pending
            if first:
                del sess.pending[seq]
                sess.replies[seq] = reply
                sess.rows += n
                while len(sess.replies) > self.reply_cache:
                    old_seq, _ = sess.replies.popitem(last=False)
                    sess.evicted_below = max(sess.evicted_below,
                                             old_seq + 1)
            else:
                # the racing callback already cached it; send that encoding
                reply = sess.replies.get(seq, reply)
        if claimer:
            with st.lock:
                st.inflight -= 1
                if err is not None:
                    st.stats["errors"] += 1
                else:
                    st.stats["rows"] += n
            if err is not None:
                obs_count("serve/gateway_errors", stage="serve")
            else:
                obs_count("serve/gateway_rows", n, sink_event=False)
            inj = inject.active()
            if inj is not None:
                try:
                    inj.fire("gateway/reply")
                except Exception:  # orp: noqa[ORP009] -- the injected reset IS the emission: the producer must recover from it
                    # connection-reset-after-submit-before-reply: the reply
                    # stays cached; the producer's replay is answered from it
                    try:
                        st.sock.close()
                    except OSError:  # best-effort close of the injected reset
                        pass
                    return
        self._enqueue_reply(st, reply)

    def _handle_request_v1(self, frame: bytes, st: _Conn) -> bool:
        """The pre-sequencing path, unchanged semantics: decode →
        submit_block → block on the future → reply inline. No session, no
        dedup — a v1 producer that loses its connection cannot know which
        rows landed (exactly the gap the v2 handshake closes)."""
        stats = st.stats
        t0 = time.perf_counter()
        try:
            req = wire.decode_request(frame)
        except wire.WireError as e:
            stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="decode")
            flight.record("wire_error", stage="decode")
            return self._send_on(st, wire.encode_error(str(e)))
        trace = req["trace"]
        if trace is not None:
            emit_trace_span("trace/decode", trace[0], trace[1],
                            time.perf_counter() - t0,
                            attrs={"bytes": len(frame)})
        tenant = req["tenant"] or self.default_tenant
        if tenant is None:
            stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="route")
            return self._send_on(st, wire.encode_error(
                "frame names no tenant and the gateway has no default — "
                "set the tenant field or start with --tenant"))
        try:
            fut = self.host.submit_block(tenant, req["date_idx"],
                                         req["states"], req["prices"],
                                         req["deadlines"], trace=trace)
            with self._lock:
                self._submitted_frames += 1
            result: BlockResult = fut.result(timeout=self.reply_timeout_s)
        except Exception as e:  # emitted: counted AND shipped to the client as an ERROR frame
            stats["errors"] += 1
            obs_count("serve/gateway_errors", stage="serve")
            return self._send_on(st, wire.encode_error(
                f"{type(e).__name__}: {e}"))
        n = result.n_rows
        stats["rows"] += n
        obs_count("serve/gateway_rows", n, sink_event=False)
        t0 = time.perf_counter()
        timing = (None if trace is None or result.timing is None
                  else (trace[0], *result.timing))
        reply = wire.encode_reply(result, date_idx=req["date_idx"],
                                  timing=timing)
        if trace is not None:
            emit_trace_span("trace/encode", trace[0], trace[1],
                            time.perf_counter() - t0, attrs={"rows": n})
        return self._send_on(st, reply)

    def _send_on(self, st: _Conn, frame: bytes) -> bool:
        """One frame onto the wire from the HANDLER thread (pongs, errors,
        cached replays, v1 replies): synchronous, resumable, bounded."""
        with st.send_lock:
            return self._send_bytes(st, frame)

    def _send_bytes(self, st: _Conn, frame: bytes) -> bool:
        """Resumable bounded send (call with ``st.send_lock`` held). Each
        ``send`` attempt is bounded by the socket's poll timeout — NEVER by
        mutating the shared socket timeout, which would race the handler's
        recv poll and stretch stall eviction to the send bound — with the
        offset carried across attempts (a partial write is resumed, never a
        torn stream) and the WHOLE frame bounded by ``reply_timeout_s``.
        Any failure closes the connection (a sequenced producer reconnects
        and is answered from the reply cache)."""
        data = _LEN.pack(len(frame)) + frame
        view = memoryview(data)
        off = 0
        deadline = time.perf_counter() + self.reply_timeout_s
        try:
            while off < len(data):
                try:
                    off += st.sock.send(view[off:])  # poll timeout set at accept; the loop carries its own reply_timeout_s deadline
                except socket.timeout:
                    if time.perf_counter() > deadline:
                        raise OSError(  # orp: noqa[ORP016] -- the enclosing except OSError emits serve/gateway_errors{stage=send} + the flight record three lines down
                            "reply send exceeded reply_timeout_s") from None
            return True
        except OSError:
            obs_count("serve/gateway_errors", stage="send")
            flight.record("wire_error", stage="send")
            st.dead = True
            try:
                st.sock.close()
            except OSError:  # already dead; the close was the response
                pass
            return False

    def _enqueue_reply(self, st: _Conn, frame: bytes) -> None:
        """Hand a block reply to the connection's writer thread. Called
        from the RESOLVING thread (`_reply_ready` is a block-future done
        callback, which runs on the batcher worker): the enqueue is the
        only work done there — a consumer that stops reading stalls its
        own writer, never the dispatch loop. ``_replying`` covers the
        enqueued-but-unsent window so a graceful drain flushes it."""
        with self._lock:
            self._replying += 1
        with st.cv:
            st.outbox.append(frame)
            if st.writer is None:
                st.writer = threading.Thread(
                    target=self._writer_loop, args=(st,),
                    name="orp-gateway-writer", daemon=True)
                st.writer.start()
            st.cv.notify()

    def _writer_loop(self, st: _Conn) -> None:
        while True:
            with st.cv:
                while not st.outbox:
                    if st.dead or self._closed.is_set():
                        # retire under the cv: a late enqueue either sees
                        # writer=None (starts a fresh one that fail-fast
                        # flushes) or a live writer that will see its item
                        st.writer = None
                        return
                    st.cv.wait(0.25)
                frame = st.outbox.popleft()
            try:
                with st.send_lock:
                    self._send_bytes(st, frame)
            finally:
                with self._lock:
                    self._replying -= 1

    # -- introspection / lifecycle -------------------------------------------

    def metrics_text(self) -> str:
        """The live Prometheus exposition this process can honestly serve:
        the host registry (tenant serving series + the pre-interned core
        gateway series) plus, when an obs session is active with a DIFFERENT
        registry, that one too. This is what the METRICS wire kind and the
        ``--metrics-port`` HTTP endpoint both answer — ``metrics.prom``
        from the LIVE process, no clean exit required."""
        regs = [self.host.registry]
        st = obs_state()
        if st is not None and st.registry is not regs[0]:
            regs.append(st.registry)
        return "".join(prometheus_text(r) for r in regs)

    def health_report(self, *, dump_flight: bool = False,
                      route=None) -> dict:
        """Compact JSON health document (the HEALTH wire kind): draining
        flag, session count, cumulative ledgers, per-tenant pending, and
        the flight-ring state. ``dump_flight=True`` (a HEALTH request with
        ``{"dump_flight": true}`` — what ``orp doctor --metrics`` sends)
        additionally DUMPS the flight ring when the recorder is armed: a
        probe against a sick gateway leaves the evidence on disk. A plain
        probe (``orp top``'s per-refresh HEALTH) never writes — a
        read-only dashboard must not cause disk I/O in the serving
        process.

        When the host is a fleet router (``serve/fleet.py::FleetHost``)
        the document additionally carries ``routing``: the routing-table
        version, healthy set, per-replica health ages and the mapping of
        a tenant sample (``route`` — a HEALTH request with ``{"route":
        [...names...]}``; the default sample when omitted) — what ``orp
        doctor --fleet`` compares across gateway processes."""
        dump = flight.RECORDER.dump() if dump_flight else None
        with self._lock:
            sessions = len(self._sessions)
        tenants = {
            name: {k: s[k] for k in ("live", "pending", "version")}
            for name, s in self.host.stats().items()
        }
        routing = None
        route_sample = getattr(self.host, "route_sample", None)
        if route_sample is not None:
            routing = route_sample(route)
        return {
            **({"routing": routing} if routing is not None else {}),
            "draining": self._draining.is_set(),
            "aborted": self.aborted.is_set(),
            "sessions": sessions,
            "totals": self.totals(),
            "tenants": tenants,
            "flight_recorded": flight.RECORDER.recorded,
            "flight_dump": None if dump is None else str(dump),
        }

    def stats(self) -> dict:
        """Live per-connection ledgers: ``{conn_id: {peer, frames, rows,
        errors}}``."""
        with self._lock:
            return {cid: dict(s) for cid, s in self._conns.items()}

    def totals(self) -> dict:
        """The cumulative ledger, retired connections included:
        ``frames``/``rows``/``errors`` plus ``submitted_frames`` (blocks
        that reached the host — the exactly-once-serve count a chaos drill
        pins)."""
        with self._lock:
            t = dict(self._retired)
            for s in list(self._conns.values()) + list(self._recent_retired):
                for k in ("frames", "rows", "errors"):
                    t[k] += s[k]
            t["submitted_frames"] = self._submitted_frames
            t["replayed_from_cache"] = sum(
                s.replayed_from_cache for s in self._sessions.values())
        return t

    def _pending_frames(self) -> int:
        with self._lock:
            sessions = list(self._sessions.values())
        n = 0
        for s in sessions:
            with s.lock:
                n += len(s.pending)
        return n

    def close(self, timeout: float = 5.0, *, successor=None) -> None:
        """Graceful drain: stop accepting, answer NEW frames with REDIRECT
        (when ``successor=(host, port)`` names where traffic should go) or
        a draining ERROR, flush every in-flight reply, then close.

        The drain-and-redirect contract: a producer mid-stream loses zero
        rows — admitted frames finish and their replies flush here, refused
        frames carry their seq so the producer replays them against the
        successor."""
        if self._closed.is_set():
            return
        if successor is not None:
            self._redirect = (str(successor[0]), int(successor[1]))
        self._draining.set()
        try:
            self._sock.close()
        except OSError:  # already closed; the drain continues
            pass
        self._acceptor.join(timeout)
        # flush: every admitted frame resolves AND its reply hits the wire
        # (_replying covers the pending-delete → send window) before the
        # handlers are told to stop
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                replying = self._replying
            if not replying and not self._pending_frames():
                break
            time.sleep(0.005)
        self._closed.set()
        with self._lock:
            handlers = list(self._handlers)
        for t in handlers:
            t.join(timeout)

    def abort(self) -> None:
        """Simulated process death (the chaos drill's kill switch): close
        the listener and every live connection immediately — no drain, no
        flush; sessions die with the object exactly as they would with the
        process. A frame a handler read just before the abort is dropped
        unanswered (the JAX package's gateway may answer it with a draining
        ERROR, which its fleet then takes for the producer's error)."""
        self._closed.set()
        self._draining.set()
        try:
            self._sock.close()
        except OSError:  # already closed; the abort continues
            pass
        with self._lock:
            socks = list(self._csocks.values())
        for s in socks:
            try:
                s.close()
            except OSError:  # racing the handler's own close; nothing to emit
                pass
        self.aborted.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class GatewayClient:
    """The minimal ``orp-ingest`` v1 client: one TCP connection, columnar
    frames in, :class:`BlockResult` out, one frame in flight. The
    five-line usage::

        from orp_tpu_torch.serve.gateway import GatewayClient
        with GatewayClient("127.0.0.1", 7433) as c:
            res = c.submit_block("desk-a", date_idx=3, states=feats)
        print(res.phi, res.status)

    ``timeout_s`` bounds the CONNECT and EVERY recv: a dead-but-accepting
    endpoint surfaces as ``socket.timeout`` (an ``OSError``) within it,
    never an indefinite block. No replay, no sequencing — for delivery
    guarantees across reconnects use
    :class:`~orp_tpu_torch.serve.client.ResilientGatewayClient`."""

    def __init__(self, addr: str, port: int, *, timeout_s: float = 60.0):
        self.timeout_s = float(timeout_s)
        self._sock = socket.create_connection((addr, int(port)),
                                              timeout=self.timeout_s)
        # create_connection seeds the timeout, but state it explicitly: the
        # per-recv bound is this class's contract, not an inherited default
        self._sock.settimeout(self.timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()  # one in-flight frame per connection

    def submit_block(self, tenant: str, date_idx: int, states, prices=None,
                     deadlines=None, *,
                     deadline_ms: float | None = None,
                     trace=None) -> BlockResult:
        """Ship one block and block on its columnar reply. Raises
        :class:`GatewayError` with the server's flag-speak message when the
        server refused the frame (or the serve itself failed). ``trace``:
        an optional ``(trace_id, parent_span)`` pair (``obs.new_trace()``)
        stamped into the frame — the serving process links its segment
        spans under it and the returned :class:`BlockResult` carries the
        server-timing pair in ``timing``."""
        frame = wire.encode_request(tenant, date_idx, states, prices,
                                    deadlines, deadline_ms=deadline_ms,
                                    trace=trace)
        reply = self._roundtrip(frame)
        if wire.decode_kind(reply) == wire.KIND_ERROR:
            raise GatewayError(wire.decode_error(reply))
        return wire.decode_reply(reply)

    def ping(self) -> bool:
        """One PING round trip — the doctor probe's liveness check."""
        reply = self._roundtrip(wire.encode_ping())
        return wire.decode_kind(reply) == wire.KIND_PONG

    def metrics(self) -> str:
        """Scrape the gateway's LIVE Prometheus exposition over the wire
        (the METRICS kind) — what ``orp top`` and ``orp doctor --metrics``
        read."""
        reply = self._roundtrip(wire.encode_metrics())
        if wire.decode_kind(reply) == wire.KIND_ERROR:
            raise GatewayError(wire.decode_error(reply))
        return wire.decode_metrics(reply)

    def health(self, *, dump_flight: bool = False, route=None) -> dict:
        """One HEALTH round trip: the gateway's JSON health document
        (draining flag, ledgers, per-tenant pending). ``dump_flight=True``
        asks the serving process to dump its flight recorder (when armed)
        — the doctor's black-box hook; plain probes never cause writes.
        ``route`` (a list of tenant names) asks a FLEET gateway for its
        routing view of that sample (``routing`` in the document)."""
        ask = {}
        if dump_flight:
            ask["dump_flight"] = True
        if route is not None:
            ask["route"] = list(route)
        reply = self._roundtrip(wire.encode_health(ask or None))
        if wire.decode_kind(reply) == wire.KIND_ERROR:
            raise GatewayError(wire.decode_error(reply))
        return wire.decode_health(reply)

    def _roundtrip(self, frame: bytes) -> bytes:
        with self._lock:
            _send_frame(self._sock, frame)
            reply = _recv_frame(self._sock)
        if reply is None:
            raise GatewayError("connection closed by the gateway mid-reply")
        return reply

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # best-effort close; nothing to emit
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
