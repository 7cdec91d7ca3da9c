"""``ResilientGatewayClient`` (counterpart of ``orp_tpu/serve/client.py``):
delivery-guaranteed producer for the ingest plane.
plane.

The plain :class:`~orp_tpu_torch.serve.gateway.GatewayClient` is one socket and
one in-flight frame: if the connection drops between send and reply the
caller cannot know whether its rows were served. This client closes that
gap with the ``orp-ingest-v2`` delivery machinery (``serve/wire.py``):

- every REQUEST frame carries a per-session monotonically increasing
  ``seq`` and stays in a **bounded replay buffer** until its reply (ack)
  arrives — ``window`` unacknowledged frames is also the client-side
  backpressure bound: ``submit_block`` blocks when the buffer is full;
- on ANY connection loss the client **reconnects with exponential backoff
  off the guard retry machinery** (:class:`~orp_tpu_torch.guard.GuardPolicy`'s
  ``backoff_s`` schedule), RESUMEs its session token with a HELLO
  handshake and **replays** every unacknowledged frame in order. The
  gateway's per-session dedup window makes this at-least-once-submit /
  exactly-once-serve: an already-served frame is re-answered from the
  reply cache, an in-flight one is adopted, only genuinely new frames
  dispatch;
- a **BUSY** frame (gateway backpressure) schedules the named frame for
  retransmit after a backoff — the producer slows down, no rows died;
- a **REDIRECT** frame (drain-and-redirect handoff) marks the named frame
  for replay against the successor; the client keeps the old connection
  until every ADMITTED frame's reply has flushed, then reconnects to the
  successor and replays the refused ones — zero rows lost across the
  handoff.

One background reader thread owns every socket read (replies, handshakes,
reconnects); ``submit_block``/``submit_block_async`` run on the caller's
thread. Usage::

    from orp_tpu_torch.serve.client import ResilientGatewayClient
    with ResilientGatewayClient("127.0.0.1", 7433) as c:
        futs = [c.submit_block_async("desk-a", 0, blk) for blk in blocks]
        results = [f.result(timeout=30) for f in futs]
    # a dropped connection, BUSY spell or gateway handoff in between is
    # absorbed: every block resolves exactly once, bitwise what an
    # uninterrupted run serves
"""

from __future__ import annotations

import collections
import socket
import threading
import time

from orp_tpu_torch.guard import inject
from orp_tpu_torch.guard.serve import GuardPolicy
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight
from orp_tpu_torch.serve import wire
from orp_tpu_torch.serve.batcher import SlimFuture
from orp_tpu_torch.serve.gateway import MAX_FRAME_BYTES, GatewayError, _LEN, _recv_frame

#: default reconnect schedule: 29 attempts, 50ms doubling to a 2s cap —
#: ~55s total budget, sized to survive a supervisor restart of a serving
#: process (its imports and bundle load take seconds cold). A producer that
#: wants fail-fast passes its own GuardPolicy.
DEFAULT_RETRY = GuardPolicy(max_retries=29, backoff_ms=50.0,
                            backoff_cap_ms=2000.0)


def _tx(sock: socket.socket, data: bytes) -> None:
    sock.sendall(data)  # orp: noqa[ORP014] -- every socket entering this helper was settimeout'd at _open


class _Entry:
    """One unacknowledged frame: the encoded bytes (the replay buffer IS
    the frames — nothing is re-encoded), its future, and its retransmit
    state."""

    __slots__ = ("seq", "frame", "future", "due", "busy_n", "redirected",
                 "sent_at")

    def __init__(self, seq: int, frame: bytes):
        self.seq = seq
        self.frame = frame
        self.future = SlimFuture()
        self.due = None          # perf_counter instant of a BUSY retransmit
        self.busy_n = 0
        self.redirected = False  # refused by a draining gateway: replay
        self.sent_at = time.perf_counter()


class ResilientGatewayClient:
    """Reconnect-replay producer over the ``orp-ingest-v2`` wire.

    ``window``     — replay-buffer bound = max unacknowledged frames in
    flight; ``submit_block`` blocks (client-side backpressure) when full.
    ``retry``      — the reconnect :class:`~orp_tpu_torch.guard.GuardPolicy`:
    ``max_retries`` connection attempts per outage, ``backoff_s`` schedule
    between them (also the BUSY retransmit schedule). Budget exhausted =
    every outstanding future fails with :class:`GatewayError` and the
    client is dead.
    ``timeout_s``  — connect timeout, mid-reply stall deadline, and the
    default ``submit_block`` result bound.

    ``stats`` counts ``reconnects``/``replayed_frames``/``busy``/
    ``redirects``/``duplicate_replies`` — the drill's evidence that
    exactly-once-serve held (``duplicate_replies`` stays 0).
    """

    def __init__(self, addr: str, port: int, *, window: int = 8,
                 retry: GuardPolicy = DEFAULT_RETRY,
                 timeout_s: float = 30.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
        self._target = (str(addr), int(port))
        self._retry = retry
        self.timeout_s = float(timeout_s)
        self._window = int(window)
        self._max_frame_bytes = int(max_frame_bytes)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._unacked: collections.OrderedDict[int, _Entry] = \
            collections.OrderedDict()
        self._next_seq = 1
        self._token = b""
        self._sock: socket.socket | None = None
        # connection generation: bumped by every reconnect. A producer-side
        # send is only valid for the generation its entry was queued under —
        # past it, the reconnect's replay owns the frame (sending it again
        # would deliver the same seq twice on one connection)
        self._gen = 0
        self._send_lock = threading.Lock()
        self._closed = False
        self._dead: Exception | None = None
        self._redirect: tuple[str, int] | None = None
        self._interrupt = threading.Event()
        self._pong = threading.Event()
        self.stats = {"reconnects": 0, "replayed_frames": 0, "busy": 0,
                      "redirects": 0, "duplicate_replies": 0}
        # connect in the constructor (fail fast on a wrong address); every
        # LATER outage is the reader thread's to absorb
        sock = self._open(self._target)
        with self._lock:
            self._sock = sock
        self._reader = threading.Thread(
            target=self._read_loop, name="orp-gateway-client", daemon=True)
        self._reader.start()

    # -- producer side -------------------------------------------------------

    @property
    def dead(self) -> bool:
        """True once the client is unusable: closed, or its reconnect
        budget exhausted (every submit raises). A fleet router polls this
        to decide whether a fresh client is needed for the replica."""
        with self._lock:
            return self._closed or self._dead is not None

    def submit_block_async(self, tenant: str, date_idx: int, states,
                           prices=None, deadlines=None, *,
                           deadline_ms: float | None = None,
                           trace=None) -> SlimFuture:
        """Enqueue one block; the future resolves to its
        :class:`~orp_tpu_torch.serve.ingest.BlockResult` exactly once — across
        reconnects, replays, BUSY spells and gateway handoffs — or raises
        :class:`GatewayError` when the gateway refused the frame or the
        reconnect budget died. Blocks while the replay buffer is full (the
        client-side backpressure bound).

        ``trace``: an optional ``(trace_id, parent_span)`` pair
        (``obs.new_trace()``) stamped into the frame's trace extension.
        The replay buffer keeps the encoded bytes, so a replayed frame
        carries the SAME trace context — one trace id spans the frame's
        whole delivery story, reconnects included — and the resolved
        ``BlockResult.timing`` carries the gateway's server-timing pair."""
        with self._space:
            if self._closed:
                raise RuntimeError("ResilientGatewayClient is closed")
            if self._dead is not None:
                raise self._dead
            while len(self._unacked) >= self._window:
                self._space.wait(timeout=0.05)
                if self._closed:
                    raise RuntimeError("ResilientGatewayClient is closed")
                if self._dead is not None:
                    raise self._dead
            seq = self._next_seq
            self._next_seq += 1
        # encode OUTSIDE the lock: a multi-MB block's column copy must not
        # stall the reader's ack processing (with concurrent producer
        # threads the window may overshoot by at most threads-1 — the
        # buffer bound is per-producer-tight, not global-exact)
        frame = wire.encode_request(tenant, date_idx, states, prices,
                                    deadlines, deadline_ms=deadline_ms,
                                    seq=seq, trace=trace)
        e = _Entry(seq, frame)
        with self._space:
            if self._closed:
                raise RuntimeError("ResilientGatewayClient is closed")
            self._unacked[seq] = e
            gen = self._gen
        self._send_entry(e, gen)
        return e.future

    def submit_block(self, tenant: str, date_idx: int, states, prices=None,
                     deadlines=None, *, deadline_ms: float | None = None,
                     timeout_s: float | None = None, trace=None):
        """Synchronous convenience: ``submit_block_async(...).result()``."""
        fut = self.submit_block_async(tenant, date_idx, states, prices,
                                      deadlines, deadline_ms=deadline_ms,
                                      trace=trace)
        return fut.result(timeout=self.timeout_s if timeout_s is None
                          else timeout_s)

    def ping(self, timeout_s: float = 5.0) -> bool:
        """One PING round trip through the live connection."""
        self._pong.clear()
        self._send(wire.encode_ping())
        return self._pong.wait(timeout_s)

    def close(self) -> None:
        with self._space:
            if self._closed:
                return
            self._closed = True
            entries = list(self._unacked.values())
            self._unacked.clear()
            self._space.notify_all()
            sock, self._sock = self._sock, None
        self._interrupt.set()
        if sock is not None:
            try:
                sock.close()
            except OSError:  # best-effort close; nothing to emit
                pass
        self._reader.join(5.0)
        err = GatewayError("client closed with the frame unacknowledged")
        for e in entries:
            if e.future.set_running_or_notify_cancel() and not e.future.done():
                e.future.set_exception(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- socket plumbing -----------------------------------------------------

    def _open(self, target) -> socket.socket:
        """One connect + HELLO/RESUME handshake; raises OSError/WireError
        on failure (the reconnect loop's retry unit)."""
        sock = socket.create_connection(target, timeout=self.timeout_s)
        sock.settimeout(0.05)  # the reader's housekeeping poll
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            hello = wire.encode_hello(self._token)
            sock.sendall(_LEN.pack(len(hello)) + hello)
            # bound the WHOLE handshake, not just a started frame: the
            # frame deadline only arms at the first byte, and a
            # dead-but-accepting endpoint sends none — without this wall
            # the constructor (and every reconnect attempt) hangs forever
            t0 = time.perf_counter()

            def handshake_wall():
                self._check_interrupt()
                if time.perf_counter() - t0 > self.timeout_s:
                    raise OSError(  # orp: noqa[ORP016] -- the reconnect loop that catches this counts client/reconnects + flight-records the failure with its wall
                        f"no WELCOME within {self.timeout_s}s — the "
                        "endpoint accepts connections but does not speak "
                        "orp-ingest (dead-but-accepting)")

            reply = _recv_frame(sock, None, self._max_frame_bytes,
                                deadline_s=self.timeout_s,
                                idle=handshake_wall)
            if reply is None:
                raise OSError("connection closed during the HELLO handshake")
            kind = wire.decode_kind(reply)
            if kind == wire.KIND_REDIRECT:
                host, port, _ = wire.decode_redirect(reply)
                with self._lock:
                    self._redirect = (host, port)
                raise OSError(f"gateway is draining; redirected to "
                              f"{host}:{port}")
            token, last_seq = wire.decode_welcome(reply)
            self._token = token
            obs_count("serve/client_sessions", sink_event=False)
            return sock
        except BaseException:
            try:
                sock.close()
            except OSError:  # the handshake failure is re-raised; the close is best effort
                pass
            raise

    def _check_interrupt(self) -> None:
        if self._interrupt.is_set():
            raise OSError("client closing")

    def _send(self, frame: bytes) -> None:
        """Best-effort transmit of an UNSEQUENCED frame (ping): a failure
        just pokes the reader."""
        with self._lock:
            sock = self._sock
        if sock is None:
            return  # an outage is in progress; the reconnect replays
        try:
            self._send_raw(sock, frame)
        except OSError:
            self._drop_sock(sock)

    def _send_entry(self, e: _Entry, gen: int) -> None:
        """Transmit a buffered frame only while the connection generation
        it was queued under is still current. A reconnect in the window
        between queueing and sending means the replay loop owns this frame
        (its snapshot included the entry) — sending it here too would put
        the same seq on the new connection twice and the second reply
        would count as a duplicate."""
        with self._lock:
            if self._gen != gen or self._sock is None:
                return  # superseded: the reconnect replay delivers it
            sock = self._sock
        try:
            self._send_raw(sock, e.frame)
        except OSError:
            self._drop_sock(sock)

    def _send_raw(self, sock: socket.socket, frame: bytes) -> None:
        data = _LEN.pack(len(frame)) + frame
        inj = inject.active()
        if inj is not None:
            hold = inj.stall_send("client/send")
            if hold is not None:
                # the stalled-reader fault: half a frame, then silence with
                # the socket OPEN — the gateway's frame deadline must evict
                with self._send_lock:
                    _tx(sock, data[:max(1, len(data) // 2)])
                time.sleep(hold)
                raise OSError("injected stalled send (gateway should have "
                              "evicted this connection)")
            if inj.torn_send("client/send"):
                # the torn-frame fault: half a frame, then a dead socket —
                # the gateway discards the partial, the replay re-delivers
                with self._send_lock:
                    _tx(sock, data[:max(1, len(data) // 2)])
                sock.close()
                raise OSError("injected torn frame")
        with self._send_lock:
            _tx(sock, data)

    def _drop_sock(self, sock) -> None:
        """Retire a dead socket; the reader notices and reconnects."""
        with self._lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:  # already dead; the reconnect is the response
            pass

    # -- reader thread -------------------------------------------------------

    def _read_loop(self) -> None:
        """The one thread that reads: replies, handshakes, reconnects. Its
        poll ticks (``idle``) also run the BUSY retransmit schedule."""
        while True:
            with self._lock:
                if self._closed:
                    return
                sock = self._sock
            if sock is None:
                if not self._reconnect():
                    return
                continue
            try:
                frame = _recv_frame(sock, None, self._max_frame_bytes,
                                    deadline_s=self.timeout_s,
                                    idle=self._housekeep)
            except (OSError, wire.WireError):
                # mid-reply stall, reset, or garbage: the connection is
                # unusable — reconnect and replay
                self._drop_sock(sock)
                continue
            if frame is None:
                self._drop_sock(sock)
                continue
            try:
                self._on_frame(frame)
            except wire.WireError:
                self._drop_sock(sock)

    def _on_frame(self, frame: bytes) -> None:
        kind, seq = wire.frame_meta(frame)
        if kind == wire.KIND_PONG:
            self._pong.set()
            return
        if kind == wire.KIND_BUSY:
            self.stats["busy"] += 1
            obs_count("serve/client_busy")
            with self._lock:
                e = self._unacked.get(seq)
                if e is not None:
                    e.busy_n += 1
                    e.due = time.perf_counter() + \
                        self._retry.backoff_s(min(e.busy_n, 8))
            return
        if kind == wire.KIND_REDIRECT:
            host, port, seq = wire.decode_redirect(frame)
            self.stats["redirects"] += 1
            obs_count("serve/client_redirects")
            with self._lock:
                self._redirect = (host, port)
                if seq:
                    e = self._unacked.get(seq)
                    if e is not None:
                        e.redirected = True
            self._maybe_follow_redirect()
            return
        if kind not in (wire.KIND_REPLY, wire.KIND_ERROR):
            return  # WELCOME out of band etc.: nothing to correlate
        if seq == 0:
            # a connection-level (seq-less) ERROR means the gateway could
            # not even attribute the failure to a frame — the stream is
            # not trustworthy. Treat it as poison: raise so the read loop
            # drops the socket and the reconnect replays every unacked
            # frame (waiting for a reset that may never come would leak
            # the frames' window slots forever)
            obs_count("serve/client_conn_errors")
            raise wire.WireError(
                "connection-level ERROR from the gateway: "
                + (wire.decode_error(frame) if kind == wire.KIND_ERROR
                   else "unsequenced reply"))
        # decode BEFORE popping from the replay buffer: a corrupt reply
        # raises WireError to the read loop (drop + reconnect) with the
        # frame STILL buffered — popping first would lose it forever
        if kind == wire.KIND_ERROR:
            outcome_err = GatewayError(wire.decode_error(frame))
            outcome = None
        else:
            outcome_err = None
            outcome = wire.decode_reply(frame)
        with self._space:
            e = self._unacked.pop(seq, None)
            self._space.notify_all()
        if e is None:
            # an ack for a frame we no longer track (e.g. the reply raced a
            # retransmit): MUST stay 0 in the exactly-once drill
            self.stats["duplicate_replies"] += 1
            obs_count("serve/client_duplicate_replies")
            return
        if e.future.set_running_or_notify_cancel():
            if outcome_err is not None:
                e.future.set_exception(outcome_err)
            else:
                e.future.set_result(outcome)
        self._maybe_follow_redirect()

    def _housekeep(self) -> None:
        """Reader poll tick: retransmit BUSY-deferred frames whose backoff
        elapsed (the producer slowing down, as told)."""
        if self._interrupt.is_set():
            raise OSError("client closing")
        now = time.perf_counter()
        with self._lock:
            due = [e for e in self._unacked.values()
                   if e.due is not None and e.due <= now]
            for e in due:
                e.due = None
            gen = self._gen
        for e in due:
            self._send_entry(e, gen)

    def _maybe_follow_redirect(self) -> None:
        """Drain-and-redirect: once every still-unacked frame has been
        REDIRECTed (the admitted ones' replies all flushed), drop the old
        connection — the reconnect targets the successor and replays."""
        with self._lock:
            if self._redirect is None or self._sock is None:
                return
            if not all(e.redirected for e in self._unacked.values()):
                return  # admitted frames still owe replies on this socket
            sock, self._sock = self._sock, None
        try:
            sock.close()
        except OSError:  # handing off; the successor connect is the response
            pass

    def _reconnect(self) -> bool:
        """Exponential-backoff reconnect + RESUME + replay — the guard
        retry schedule applied to the connection itself. Returns False when
        the client is dead (budget exhausted or closed)."""
        pol = self._retry
        attempts = 1 + pol.max_retries
        last: Exception | None = None
        for attempt in range(1, attempts + 1):
            with self._lock:
                if self._closed:
                    return False
                target = self._redirect or self._target
            try:
                sock = self._open(target)
            except (OSError, wire.WireError) as e:
                last = e
                if attempt < attempts:
                    obs_count("guard/retry", site="client/connect",
                              attempt=str(attempt))
                    self._interrupt.wait(pol.backoff_s(attempt))
                continue
            with self._space:
                self._target = target
                self._redirect = None
                self._sock = sock
                # new generation: any in-flight producer send queued under
                # the old one stands down — the snapshot below owns delivery
                self._gen += 1
                entries = list(self._unacked.values())
                for e in entries:
                    e.redirected = False
                    e.due = None
            self.stats["reconnects"] += 1
            self.stats["replayed_frames"] += len(entries)
            obs_count("serve/client_reconnects")
            flight.record("reconnect", attempt=attempt,
                          target=f"{target[0]}:{target[1]}",
                          replayed=len(entries))
            # replay in seq order: the session window admits them in order,
            # answering already-served ones from the reply cache
            for e in entries:
                try:
                    self._send_raw(sock, e.frame)
                except OSError:
                    self._drop_sock(sock)
                    break  # next loop iteration reconnects again
            return True
        flight.record("client_dead", attempts=attempts,
                      target=f"{self._target[0]}:{self._target[1]}")
        dead = GatewayError(
            f"reconnect budget exhausted after {attempts} attempts to "
            f"{self._target[0]}:{self._target[1]}: {last}")
        with self._space:
            self._dead = dead
            entries = list(self._unacked.values())
            self._unacked.clear()
            self._space.notify_all()
        for e in entries:
            if e.future.set_running_or_notify_cancel():
                e.future.set_exception(dead)
        return False
