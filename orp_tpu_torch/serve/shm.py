"""Shared-memory ring ingest (counterpart of ``orp_tpu/serve/shm.py``): the
``orp-ingest`` wire without the socket.

On a co-located producer the TCP stack is a per-frame bill of its own: two
syscalls and two kernel copies per direction for bytes that never leave the
box. This lane skips it: the SAME ``orp-ingest-v2`` frames (``serve/
wire.py``), carried through an mmap'd SPSC ring instead of a socket. The file
layout (``MAGIC``, ``VERSION``, the seqlock cursors) is the JAX package's, so
a ring created by one package is attached by the other.

A record may take at most ``capacity // MAX_FRAME_FRACTION`` bytes: a
1,048,576-row block of one f32 feature is a 4 MiB request frame and a ~13 MiB
reply (status, phi, psi, value), so it needs rings of at least 64 MiB
(``RingPair.create(req_capacity=..., rep_capacity=...)``). The default file
lives in ``tempfile.gettempdir()``.

**The ring** (:class:`ShmRing`): one producer, one consumer, over a
file-backed mmap both processes attach. Cursors are MONOTONIC u64 byte
watermarks (``head`` = bytes ever written, ``tail`` = bytes ever
consumed; ``head - tail`` = bytes in flight — full and empty are never
ambiguous), each published through a **seqlock** (counter odd while the
cursor is mid-update; a reader that observes an odd or changing counter
retries instead of trusting a torn value — and a counter that STAYS odd
is a crashed writer, surfaced as a clean :class:`RingError`, never as
garbage frames). Records are ``u4 length + payload`` padded to 8 bytes;
a lap that cannot fit the next record contiguously is closed with a wrap
marker so every frame is one contiguous slice — ``np.frombuffer`` points
straight at it.

**Backpressure parity**: a full ring refuses the push (:meth:`ShmRing.
push` returns False) exactly like the gateway's BUSY frame — the
producer backs off and RESENDS; nothing is shed, no rows die. A consumer
that stops draining stalls its producer into that same BUSY loop, which
is the whole contract (bounded memory, no silent drops).

**The endpoints**: :class:`RingServer` is the gateway-shaped consumer —
pop → decode → ``host.submit_block`` → encode reply → reply ring, with
replies enqueued to a writer thread exactly like the TCP gateway (a slow
consumer stalls its own writer, never the batcher's dispatch loop).
:class:`RingClient` mirrors :class:`~orp_tpu_torch.serve.client.
ResilientGatewayClient` semantics: sequenced frames, a bounded
unacked window (client-side backpressure), BUSY retransmit with the
guard backoff schedule, ``stats`` pinning ``duplicate_replies == 0``.
What it deliberately does NOT mirror is reconnect-replay: a ring dies
with its processes (there is no half-open TCP state to survive), so a
torn ring is a loud :class:`RingError`, not a silent retry loop.
"""

from __future__ import annotations

import collections
import mmap
import pathlib
import struct
import tempfile
import threading
import time

from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.serve import wire
from orp_tpu_torch.serve.batcher import SlimFuture
from orp_tpu_torch.serve.gateway import GatewayError
from orp_tpu_torch.serve.ingest import BlockResult

MAGIC = b"ORPS"
VERSION = 1

_GLOBAL = struct.Struct("<4sIQQI")   # magic, version, req_cap, rep_cap, closed
_GLOBAL_BYTES = 64
_CURSOR_BYTES = 64                   # one cache-line-ish region per ring header
_RING_HEADER = 64                    # head seqlock+value, tail seqlock+value
_WRAP = 0xFFFFFFFF
_ALIGN = 8
#: a frame must leave room for its length word and the wrap marker
MAX_FRAME_FRACTION = 4


class RingError(RuntimeError):
    """The ring is unusable — torn writer, foreign/corrupt file, or closed
    with frames outstanding. Message is flag-speak."""


class _Cursor:
    """One u64 watermark published through a seqlock at ``off`` in the
    mmap: ``seq`` (u8) then ``value`` (u8). The writer brackets every
    update odd→write→even; a reader retries while the counter is odd or
    changes under it, so a torn 16-byte update can never be consumed —
    and a counter that stays odd past the retry budget is a crashed
    writer, raised as :class:`RingError` instead of returned as data."""

    __slots__ = ("_mm", "_off")
    _PAIR = struct.Struct("<QQ")

    def __init__(self, mm, off: int):
        self._mm = mm
        self._off = off

    def read(self) -> int:
        # SPSC: the only legitimate odd window is the few instructions of
        # the writer's own update — microseconds. Spin briefly, then back
        # off on a WALL-CLOCK budget (a writer descheduled on a loaded
        # box must not read as dead — scheduler starvation runs hundreds
        # of ms), and only a seqlock odd past that is the torn write it is.
        deadline = None
        spin = 0
        while True:
            s1, v = self._PAIR.unpack_from(self._mm, self._off)
            if s1 & 1:
                spin += 1
                if spin > 100:
                    now = time.perf_counter()
                    if deadline is None:
                        deadline = now + 2.0
                    elif now > deadline:
                        break
                    time.sleep(0.0001)
                continue
            s2 = struct.unpack_from("<Q", self._mm, self._off)[0]
            if s1 == s2:
                return v
        raise RingError(
            "ring cursor seqlock is stuck mid-update (torn write: the peer "
            "process died inside a cursor publish) — recreate the ring; "
            "sequenced producers replay their unacked frames on the new one")

    def write(self, value: int) -> None:
        s = struct.unpack_from("<Q", self._mm, self._off)[0]
        struct.pack_into("<Q", self._mm, self._off, s + 1)      # odd: in update
        struct.pack_into("<Q", self._mm, self._off + 8, value)
        struct.pack_into("<Q", self._mm, self._off, s + 2)      # even: stable

    def init(self) -> None:
        self._PAIR.pack_into(self._mm, self._off, 0, 0)


class ShmRing:
    """One direction of the shm lane: an SPSC byte ring over ``mm`` at
    ``[data_off, data_off + capacity)`` with its cursor header at
    ``header_off``. One process calls :meth:`push`, the other :meth:`pop`
    — the roles are fixed at attach time (SPSC is the protocol, not a
    convention)."""

    __slots__ = ("_mm", "_head", "_tail", "_data", "capacity")

    def __init__(self, mm, header_off: int, data_off: int, capacity: int):
        self._mm = mm
        self._head = _Cursor(mm, header_off)
        self._tail = _Cursor(mm, header_off + 16)
        self._data = data_off
        self.capacity = int(capacity)

    def init(self) -> None:
        self._head.init()
        self._tail.init()

    # -- producer side --------------------------------------------------------

    def push(self, frame: bytes) -> bool:
        """Write one frame; False when the ring lacks space (the BUSY
        parity — the producer backs off and resends; nothing was shed).
        Payload bytes land BEFORE the head watermark publishes, so the
        consumer can never observe a half-written record."""
        n = len(frame)
        need = _aligned(4 + n)
        if need > self.capacity // MAX_FRAME_FRACTION:
            raise wire.WireError(
                f"frame of {n} bytes exceeds the ring's "
                f"{self.capacity // MAX_FRAME_FRACTION}-byte record cap — "
                "split the block or grow the ring")
        head = self._head.read()
        tail = self._tail.read()
        pos = head % self.capacity
        contiguous = self.capacity - pos
        wrap = contiguous if contiguous < need else 0
        if self.capacity - (head - tail) < wrap + need:
            return False
        if wrap:
            if contiguous >= 4:
                struct.pack_into("<I", self._mm, self._data + pos, _WRAP)
            head += wrap
            pos = 0
        base = self._data + pos
        self._mm[base + 4:base + 4 + n] = frame
        struct.pack_into("<I", self._mm, base, n)
        self._head.write(head + need)
        return True

    # -- consumer side --------------------------------------------------------

    def pop(self) -> bytes | None:
        """One frame off the ring, or None when it is empty RIGHT NOW (the
        caller owns the wait policy — spin, sleep, or give up)."""
        head = self._head.read()
        tail = self._tail.read()
        while tail < head:
            pos = tail % self.capacity
            contiguous = self.capacity - pos
            if contiguous < 4:
                tail += contiguous
                continue
            (n,) = struct.unpack_from("<I", self._mm, self._data + pos)
            if n == _WRAP:
                tail += contiguous
                continue
            base = self._data + pos
            frame = bytes(self._mm[base + 4:base + 4 + n])
            # the copy above is the ONE memcpy of the lane (no syscalls, no
            # kernel buffers); the tail publishes only after it, so the
            # producer can never overwrite bytes still being read
            self._tail.write(tail + _aligned(4 + n))
            return frame
        return None

    def depth(self) -> int:
        """Bytes currently in flight (head - tail) — the watermark gap."""
        return self._head.read() - self._tail.read()


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class RingPair:
    """The duplex shm lane one producer/consumer pair shares: a request
    ring (producer → server) and a reply ring (server → producer) over
    one file-backed mmap. ``create`` makes and maps the file (the server
    side, conventionally); ``attach`` maps an existing one (the
    co-located producer). ``close`` sets the closed flag both sides poll;
    ``unlink`` removes the file."""

    def __init__(self, path, mm, req_capacity: int, rep_capacity: int,
                 own_file: bool):
        self.path = pathlib.Path(path)
        self._mm = mm
        self._own = own_file
        data0 = _GLOBAL_BYTES + 2 * _CURSOR_BYTES
        self.request = ShmRing(mm, _GLOBAL_BYTES, data0, req_capacity)
        self.reply = ShmRing(mm, _GLOBAL_BYTES + _CURSOR_BYTES,
                             data0 + req_capacity, rep_capacity)

    @staticmethod
    def create(path=None, *, req_capacity: int = 1 << 20,
               rep_capacity: int = 1 << 20) -> "RingPair":
        if req_capacity < 4096 or rep_capacity < 4096:
            raise ValueError("ring capacities must be >= 4096 bytes")
        if path is None:
            fd, path = tempfile.mkstemp(prefix="orp-ring-", suffix=".shm")
            import os

            os.close(fd)
        p = pathlib.Path(path)
        total = (_GLOBAL_BYTES + 2 * _CURSOR_BYTES + req_capacity
                 + rep_capacity)
        with open(p, "wb") as f:
            f.truncate(total)
        mm = _map(p, total)
        _GLOBAL.pack_into(mm, 0, MAGIC, VERSION, req_capacity, rep_capacity,
                          0)
        pair = RingPair(p, mm, req_capacity, rep_capacity, own_file=True)
        pair.request.init()
        pair.reply.init()
        return pair

    @staticmethod
    def attach(path) -> "RingPair":
        p = pathlib.Path(path)
        size = p.stat().st_size
        if size < _GLOBAL_BYTES:
            raise RingError(  # orp: noqa[ORP016] -- file-format validation (the wire plane's WireError discipline), not a measured acceptance gate
                f"{p}: {size} bytes is no orp shm ring")
        mm = _map(p, size)
        magic, version, req_cap, rep_cap, _closed = _GLOBAL.unpack_from(mm, 0)
        if magic != MAGIC:
            raise RingError(
                f"{p}: bad magic {magic!r}; this file is not an orp-ring")
        if version != VERSION:
            raise RingError(f"{p}: ring version {version} != {VERSION}; "
                            "upgrade the older side")
        want = _GLOBAL_BYTES + 2 * _CURSOR_BYTES + req_cap + rep_cap
        if size < want:
            raise RingError(  # orp: noqa[ORP016] -- file-format validation (the wire plane's WireError discipline), not a measured acceptance gate
                f"{p}: file is {size} bytes, the header claims "
                f"{want} — truncated ring")
        return RingPair(p, mm, req_cap, rep_cap, own_file=False)

    @property
    def closed(self) -> bool:
        return bool(struct.unpack_from("<I", self._mm, 24)[0])

    def close(self) -> None:
        struct.pack_into("<I", self._mm, 24, 1)

    def detach(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):  # a live numpy view pins the map; the OS reclaims it with the process
            pass

    def unlink(self) -> None:
        self.detach()
        if self._own:
            self.path.unlink(missing_ok=True)


def _map(path: pathlib.Path, size: int) -> mmap.mmap:
    with open(path, "r+b") as f:
        return mmap.mmap(f.fileno(), size)


# -- endpoints ----------------------------------------------------------------


class RingServer:
    """The gateway-shaped consumer of a :class:`RingPair`: pop → decode →
    ``host.submit_block`` → encode → reply ring, with the TCP gateway's
    division of labour kept exactly — the serve loop never blocks on a
    future (done-callbacks hand encoded replies to a writer thread), and
    a slow producer-side consumer stalls only that writer, never the
    batcher's dispatch loop. PING answers PONG; malformed frames answer
    structured ERROR frames scoped by seq. ``totals()`` is the ledger the
    bench and the chaos pins read."""

    def __init__(self, host, pair: RingPair, *,
                 default_tenant: str | None = None,
                 poll_s: float = 0.0002):
        self.host = host
        self.pair = pair
        self.default_tenant = default_tenant
        self.poll_s = float(poll_s)
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._totals = {"frames": 0, "rows": 0, "errors": 0,
                        "submitted_frames": 0}
        self._outbox: collections.deque[bytes] = collections.deque()
        self._out_cv = threading.Condition()
        self._replying = 0
        # flush accounting: every reply owed = a host future still
        # resolving (_replying), an encoded frame in the outbox, or a
        # frame the writer popped but has not yet pushed — close() waits
        # out ALL three, or a producer's last replies silently die with
        # the server (found in review: the submitted-but-unresolved
        # window was invisible to the outbox/_replying test)
        self._enqueued = 0
        self._pushed = 0
        self._answered = 0
        self._serve = threading.Thread(
            target=self._serve_loop, name="orp-ring-server", daemon=True)
        self._writer = threading.Thread(
            target=self._writer_loop, name="orp-ring-writer", daemon=True)
        self._serve.start()
        self._writer.start()

    def _serve_loop(self) -> None:
        idle = 0
        while not self._closed.is_set():
            try:
                frame = self.pair.request.pop()
            except RingError:
                obs_count("serve/ring_errors", stage="torn")
                return
            if frame is None:
                if self.pair.closed:
                    return
                idle += 1
                if idle > 64:
                    time.sleep(self.poll_s)
                continue
            idle = 0
            with self._lock:
                self._totals["frames"] += 1
            self._handle(frame)

    def _handle(self, frame: bytes) -> None:
        try:
            kind, seq = wire.frame_meta(frame)
        except wire.WireError as e:
            with self._lock:
                self._totals["errors"] += 1
            obs_count("serve/ring_errors", stage="decode")
            self._enqueue(wire.encode_error(str(e)))
            return
        if kind == wire.KIND_PING:
            self._enqueue(wire.encode_pong())
            return
        if kind != wire.KIND_REQUEST:
            with self._lock:
                self._totals["errors"] += 1
            self._enqueue(wire.encode_error(
                "the ring lane takes request/ping frames only",
                seq=seq or None))
            return
        try:
            req = wire.decode_request(frame)
        except wire.WireError as e:
            with self._lock:
                self._totals["errors"] += 1
            obs_count("serve/ring_errors", stage="decode")
            self._enqueue(wire.encode_error(str(e), seq=seq or None))
            return
        tenant = req["tenant"] or self.default_tenant
        if tenant is None:
            with self._lock:
                self._totals["errors"] += 1
            self._enqueue(wire.encode_error(
                "frame names no tenant and the ring server has no default "
                "— set the tenant field or construct with default_tenant",
                seq=seq or None))
            return
        date_idx = req["date_idx"]
        try:
            fut = self.host.submit_block(tenant, date_idx, req["states"],
                                         req["prices"], req["deadlines"],
                                         trace=req["trace"])
        except Exception as e:  # emitted: shipped back as a structured ERROR frame + counted
            with self._lock:
                self._totals["errors"] += 1
            obs_count("serve/ring_errors", stage="serve")
            self._enqueue(wire.encode_error(f"{type(e).__name__}: {e}",
                                            seq=seq or None))
            return
        with self._lock:
            self._totals["submitted_frames"] += 1
        fut.add_done_callback(
            lambda f: self._reply_ready(f, seq, date_idx))

    def _reply_ready(self, fut, seq: int, date_idx: int) -> None:
        with self._lock:
            self._replying += 1
        try:
            err = fut.exception()
            if err is not None:
                with self._lock:
                    self._totals["errors"] += 1
                self._enqueue(wire.encode_error(
                    f"{type(err).__name__}: {err}", seq=seq or None))
                return
            result: BlockResult = fut.result()
            with self._lock:
                self._totals["rows"] += result.n_rows
            self._enqueue(wire.encode_reply(result, date_idx=date_idx,
                                            seq=seq or None))
        finally:
            with self._lock:
                self._replying -= 1
                self._answered += 1

    def _enqueue(self, frame: bytes) -> None:
        with self._out_cv:
            self._outbox.append(frame)
            self._enqueued += 1
            self._out_cv.notify()

    def _writer_loop(self) -> None:
        while True:
            with self._out_cv:
                while not self._outbox:
                    if self._closed.is_set():
                        return
                    self._out_cv.wait(0.05)
                frame = self._outbox.popleft()
            backoff = 0
            while True:
                try:
                    if self.pair.reply.push(frame):
                        with self._out_cv:
                            self._pushed += 1
                        break
                except RingError:
                    obs_count("serve/ring_errors", stage="torn")
                    return
                if self._closed.is_set():
                    # abandoning a popped frame is only legal once close()
                    # gave up its flush window — count it so totals stay
                    # honest about the drop
                    obs_count("serve/ring_errors", stage="abandoned")
                    return
                # slow consumer: the reply ring is full — this writer (and
                # only this writer) waits it out, the BUSY-parity twin of
                # the producer side
                backoff = min(backoff + 1, 50)
                time.sleep(self.poll_s * backoff)

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def close(self, timeout: float = 5.0) -> None:
        # flush: admitted frames resolve and their replies hit the RING
        # (not just the outbox) — a frame is owed a reply from the moment
        # host.submit_block accepted it, so the wait covers the whole
        # submitted→resolved→enqueued→pushed chain
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                replying = self._replying
                owed = self._totals["submitted_frames"]
                answered = self._answered
            with self._out_cv:
                unpushed = self._enqueued - self._pushed
            if not replying and not unpushed and answered >= owed:
                break
            time.sleep(0.005)
        self._closed.set()
        self.pair.close()
        with self._out_cv:
            self._out_cv.notify_all()
        self._serve.join(timeout)
        self._writer.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RingClient:
    """The co-located producer over a :class:`RingPair` — the shm mirror
    of :class:`~orp_tpu_torch.serve.client.ResilientGatewayClient`: sequenced
    frames, a bounded unacked ``window`` (client-side backpressure), a
    full ring answered with the guard backoff schedule (BUSY parity:
    resend, never shed), ``stats`` pinning ``duplicate_replies == 0``.
    The one semantic it does NOT carry is reconnect-replay — a ring has
    no half-open state to resume; a torn ring fails loudly."""

    def __init__(self, pair_or_path, *, window: int = 32,
                 timeout_s: float = 30.0, retry=None,
                 poll_s: float = 0.0002):
        from orp_tpu_torch.guard.serve import GuardPolicy

        self.pair = (pair_or_path if isinstance(pair_or_path, RingPair)
                     else RingPair.attach(pair_or_path))
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self._window = int(window)
        self._retry = retry if retry is not None else GuardPolicy(
            max_retries=0, backoff_ms=0.2, backoff_cap_ms=5.0)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._unacked: dict[int, SlimFuture] = {}
        self._next_seq = 1
        self._closed = False
        self._pong = threading.Event()
        self.stats = {"busy": 0, "duplicate_replies": 0, "frames": 0}
        self._send_lock = threading.Lock()
        self._reader = threading.Thread(
            target=self._read_loop, name="orp-ring-client", daemon=True)
        self._reader.start()

    def submit_block_async(self, tenant: str, date_idx: int, states,
                           prices=None, deadlines=None, *,
                           deadline_ms: float | None = None,
                           trace=None) -> SlimFuture:
        """Enqueue one block through the ring; the future resolves to its
        :class:`~orp_tpu_torch.serve.ingest.BlockResult`. Blocks while the
        unacked window is full; a full RING backs off and resends on the
        retry schedule (nothing shed), failing loudly only past
        ``timeout_s``."""
        with self._space:
            if self._closed:
                raise RuntimeError("RingClient is closed")
            while len(self._unacked) >= self._window:
                self._space.wait(timeout=0.05)
                if self._closed:
                    raise RuntimeError("RingClient is closed")
            seq = self._next_seq
            self._next_seq += 1
            fut = SlimFuture()
            self._unacked[seq] = fut
        frame = wire.encode_request(tenant, date_idx, states, prices,
                                    deadlines, deadline_ms=deadline_ms,
                                    seq=seq, trace=trace)
        try:
            self._push(frame)
        except BaseException:
            with self._space:
                self._unacked.pop(seq, None)
                self._space.notify_all()
            raise
        self.stats["frames"] += 1
        return fut

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
        self._pong.clear()
        self._push(wire.encode_ping())
        return self._pong.wait(timeout_s)

    def _push(self, frame: bytes) -> None:
        deadline = time.perf_counter() + self.timeout_s
        attempt = 0
        with self._send_lock:
            while True:
                if self.pair.closed:
                    raise GatewayError("ring closed by the server")
                if self.pair.request.push(frame):
                    return
                # BUSY parity: the ring is full — back off and RESEND;
                # no rows died, the consumer just owes us a drain
                attempt += 1
                if attempt == 1:
                    self.stats["busy"] += 1
                    obs_count("serve/client_busy", lane="ring")
                if time.perf_counter() > deadline:
                    raise GatewayError(  # the busy counter above recorded the backpressure before this verdict
                        f"ring full for {self.timeout_s}s — the consumer "
                        "stopped draining; restart the serving process")
                time.sleep(self._retry.backoff_s(min(attempt, 8)))  # orp: noqa[ORP021] -- the ring is FULL: every sender must wait, and releasing _send_lock between retries would reorder frames

    def _read_loop(self) -> None:
        idle = 0
        while not self._closed:  # orp: noqa[ORP020] -- monotonic shutdown flag: a stale read costs one extra poll iteration, never a wrong result
            try:
                frame = self.pair.reply.pop()
            except RingError:
                self._fail_all(RingError(
                    "reply-ring seqlock torn (the server died mid-publish) "
                    "— recreate the ring and resubmit"))
                return
            if frame is None:
                if self.pair.closed:
                    # the server flushed every owed reply BEFORE setting
                    # the closed flag (RingServer.close), so an empty
                    # ring + closed pair means nothing more is coming:
                    # fail the stragglers LOUDLY now instead of letting
                    # each waiter sit out its full result() timeout
                    self._fail_all(GatewayError(
                        "ring closed by the server with the frame "
                        "unanswered — restart the serving process and "
                        "resubmit"))
                    return
                idle += 1
                if idle > 64:
                    time.sleep(self.poll_s)
                continue
            idle = 0
            self._on_frame(frame)

    def _on_frame(self, frame: bytes) -> None:
        try:
            kind, seq = wire.frame_meta(frame)
        except wire.WireError:
            return
        if kind == wire.KIND_PONG:
            self._pong.set()
            return
        if kind not in (wire.KIND_REPLY, wire.KIND_ERROR):
            return
        if seq == 0:
            # a seq-less ERROR cannot be attributed to a frame (a decode
            # refusal before the header parsed): count it, never let it
            # masquerade as a duplicate reply
            obs_count("serve/ring_errors", stage="unattributed")
            return
        if kind == wire.KIND_ERROR:
            err = GatewayError(wire.decode_error(frame))
            outcome = None
        else:
            err = None
            try:
                outcome = wire.decode_reply(frame)
            except wire.WireError as e:
                # a reply whose header parsed but whose body didn't: the
                # ring has no reconnect-replay to redeliver it, so fail
                # the frame LOUDLY now — silently dropping it left the
                # future (and its window slot) hung until full timeout
                obs_count("serve/ring_errors", stage="reply_decode")
                err = GatewayError(
                    f"undecodable reply for seq {seq}: {e} — the ring "
                    "carried a torn or foreign frame; resubmit")
        with self._space:
            fut = self._unacked.pop(seq, None)
            self._space.notify_all()
        if fut is None:
            self.stats["duplicate_replies"] += 1
            obs_count("serve/client_duplicate_replies", lane="ring")
            return
        if fut.set_running_or_notify_cancel():
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(outcome)

    def _fail_all(self, err: Exception) -> None:
        with self._space:
            entries = list(self._unacked.values())
            self._unacked.clear()
            self._space.notify_all()
        for fut in entries:
            if fut.set_running_or_notify_cancel() and not fut.done():
                fut.set_exception(err)

    def close(self) -> None:
        with self._space:
            if self._closed:
                return
            self._closed = True
            self._space.notify_all()
        self._reader.join(5.0)
        self._fail_all(GatewayError(
            "ring client closed with the frame unacknowledged"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
