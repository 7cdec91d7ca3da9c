"""The port's ``orp-ingest`` socket plane on the CPU (``orp_tpu_torch/serve/
{gateway,client,scrape}.py`` and the wire faults of ``guard/inject.py``),
held against the JAX package's.

Interop: one scripted frame sequence (HELLO, sequenced REQUESTs, a replayed
seq, an unknown tenant, a frame past ``max_inflight_replies``, METRICS,
HEALTH, PING, a v1 frame, malformed frames) goes to the port's gateway over
the port's ``ServeHost`` and to the JAX package's over its own, on the same
params: reply kinds, seqs, statuses and error messages equal, result columns
within ``TOL`` (two packages' f32 forwards sum in other orders). Each
package's clients serve through the other package's gateway. Then the
port's counterparts of the JAX package's delivery pins (reset replay,
torn and stalled frames, kill at frame k, the reconnect budget, BUSY,
drain-and-redirect) and its ingest-gateway cases, bitwise against the port's
own ``HedgeEngine``.

Every wait is bounded (sockets, ``result``, ``join``), every gateway, host
and client is closed in a ``with`` block or a ``finally``, and no sleep is
longer than 50 ms."""

import dataclasses
import socket
import struct
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from orp_tpu import guard as jguard
from orp_tpu.serve import GatewayClient as JGatewayClient
from orp_tpu.serve import HedgeEngine as JHedgeEngine
from orp_tpu.serve import ResilientGatewayClient as JResilientGatewayClient
from orp_tpu.serve import ServeGateway as JServeGateway
from orp_tpu.serve import ServeHost as JServeHost
from orp_tpu.serve.scrape import parse_prometheus as jparse_prometheus
from orp_tpu_torch import guard, obs
from orp_tpu_torch.guard import GuardPolicy
from orp_tpu_torch.serve import (SERVED, GatewayClient, GatewayError, HedgeEngine, MetricsServer,
                                 ResilientGatewayClient, ServeGateway, ServeHost, concat_results,
                                 parse_prometheus, render_top, top_snapshot, wire)
from orp_tpu_torch.serve import bench

from test_torch_serve import TOL, _pair

CPU = {"device": "cpu"}
T = 10.0  # the bound on every socket read, result() and join() here


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The same 1-feature, 4-date policy as a JAX PolicyBundle and the port's."""
    return _pair(n_features=1, n_dates=4, seed=3)


@pytest.fixture(scope="module")
def policy(pair):
    return pair[1]


def _host(**kw):
    return ServeHost(engine_kwargs=CPU, **kw)


def _blocks(n, rows=8, nf=1, seed=0):
    rng = np.random.default_rng(seed)
    return [(1.0 + 0.1 * rng.standard_normal((rows, nf))).astype(np.float32)
            for _ in range(n)]


def _engine(policy):
    return HedgeEngine(policy, device="cpu")


def _assert_bits(res, want):
    np.testing.assert_array_equal(res.phi, want[0])
    np.testing.assert_array_equal(res.psi, want[1])


# -- raw-socket helpers ----------------------------------------------------------


def _connect(address):
    s = socket.create_connection(address, timeout=T)
    s.settimeout(T)
    return s


def _send(s, frame: bytes) -> None:
    s.sendall(struct.pack("<I", len(frame)) + frame)


def _recv(s) -> bytes | None:
    """One length-prefixed frame, or None at EOF / reset (bounded by ``T``)."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            try:
                chunk = s.recv(n - len(buf))
            except (ConnectionResetError, socket.timeout):
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    head = exact(4)
    if head is None:
        return None
    return exact(struct.unpack("<I", head)[0])


# -- the wire faults -------------------------------------------------------------


def test_wire_fault_fields_match_the_jax_package():
    mine = {f.name: f for f in dataclasses.fields(guard.FaultPlan)}
    ref = {f.name: f for f in dataclasses.fields(jguard.FaultPlan)}
    for name in ("torn_send", "stall_send", "kill_gateway_at_frame"):
        assert mine[name].type == ref[name].type
        plan_m, plan_j = guard.FaultPlan(), jguard.FaultPlan()
        assert getattr(plan_m, name) == getattr(plan_j, name)
    assert list(mine) == list(ref)


def test_the_same_plan_fires_the_same_log():
    kw = dict(torn_send={"client/send": 2}, stall_send={"client/send": (1, 0.01)},
              kill_gateway_at_frame=3, fail={"gateway/reply": 1})
    logs, outs = [], []
    for pkg in (guard, jguard):
        with pkg.faults(pkg.FaultPlan(**kw)) as inj:
            out = [inj.torn_send("client/send") for _ in range(3)]
            out += [inj.stall_send("client/send") for _ in range(2)]
            out += [inj.gateway_kill(k) for k in (1, 3, 3, 4)]
            out += [inj.torn_send("other/site")]
            try:
                inj.fire("gateway/reply")
            except Exception as e:  # noqa: BLE001 - both packages raise their InjectedFault
                out.append(type(e).__name__)
            inj.fire("gateway/reply")
        logs.append(list(inj.log))
        outs.append(out)
    assert logs[0] == logs[1] and outs[0] == outs[1]
    assert outs[0][:9] == [True, True, False, 0.01, None, False, True, False, False]


# -- the frame script, both packages ----------------------------------------------


def _script(address, x, prices):
    """The scripted frame sequence against one gateway: ``[(kind, seq,
    payload)]`` in the order read (the session token, random by design, is
    left out)."""
    out = []

    def read(s):
        f = _recv(s)
        if f is None:
            out.append(("eof", 0, None))
            return
        kind, seq = wire.frame_meta(f)
        if kind == wire.KIND_REPLY:
            r = wire.decode_reply(f)
            payload = (r.status.copy(), r.phi.copy(), r.psi.copy(),
                       None if r.value is None else r.value.copy())
        elif kind == wire.KIND_ERROR:
            payload = wire.decode_error(f)
        elif kind == wire.KIND_WELCOME:
            payload = wire.decode_welcome(f)[1]
        elif kind == wire.KIND_BUSY:
            payload = wire.decode_busy(f)[0]
        elif kind == wire.KIND_METRICS:
            payload = "serve_gateway_rows" in parse_prometheus(wire.decode_metrics(f))
        elif kind == wire.KIND_HEALTH:
            payload = sorted(wire.decode_health(f))
        else:
            payload = None
        out.append((kind, seq, payload))

    a = _connect(address)
    try:
        _send(a, wire.encode_hello(b""))
        read(a)
        _send(a, wire.encode_request("d", 0, x, seq=1))
        read(a)
        _send(a, wire.encode_request("d", 2, x, prices, seq=2))
        read(a)
        _send(a, wire.encode_request("d", 0, x, seq=1))  # replayed: from the cache
        read(a)
        _send(a, wire.encode_request("nobody", 0, x, seq=3))
        read(a)
        # back to back: the second is past max_inflight_replies=1 while the
        # first waits out the batcher's window
        _send(a, wire.encode_request("d", 1, x, seq=4))
        _send(a, wire.encode_request("d", 1, x, seq=5))
        read(a)
        read(a)
        for frame in (wire.encode_metrics(), wire.encode_health(None), wire.encode_ping()):
            _send(a, frame)
            read(a)
        b = _connect(address)
        try:
            _send(b, wire.encode_request("d", 3, x))  # v1: unsequenced
            read(b)
            _send(b, b"not-a-frame!")  # no session: answered, connection kept
            read(b)
            _send(b, wire.encode_ping())
            read(b)
        finally:
            b.close()
        _send(a, b"GARBAGE-GARBAGE-GARBAGE-GARBAGE-GARBAGE-GARBAGE-GARBAGE")
        read(a)  # a handshaken stream that desyncs: ERROR, then the reset
        read(a)
    finally:
        a.close()
    c = _connect(address)
    try:
        c.sendall(struct.pack("<I", 1 << 30))  # past the transport cap
        read(c)
        read(c)
    finally:
        c.close()
    return out


def test_one_frame_script_through_both_packages_gateways(pair):
    jpol, tpol = pair
    x = _blocks(1, rows=8, seed=1)[0]
    prices = np.stack([x[:, 0], np.full(8, 0.97, np.float32)], axis=1)
    gw_kw = dict(port=0, max_inflight_replies=1)
    with ServeHost(engine_kwargs=CPU, batcher_kwargs={"max_wait_us": 150_000.0}) as host:
        host.add_tenant("d", tpol)
        with ServeGateway(host, **gw_kw) as gw:
            mine = _script(gw.address, x, prices)
    with JServeHost(batcher_kwargs={"max_wait_us": 150_000.0}) as jhost:
        jhost.add_tenant("d", jpol)
        with JServeGateway(jhost, **gw_kw) as jgw:
            ref = _script(jgw.address, x, prices)
    assert [(k, s) for k, s, _ in mine] == [(k, s) for k, s, _ in ref]
    kinds = [k for k, _, _ in mine]
    assert kinds == [wire.KIND_WELCOME, wire.KIND_REPLY, wire.KIND_REPLY, wire.KIND_REPLY,
                     wire.KIND_ERROR, wire.KIND_BUSY, wire.KIND_REPLY, wire.KIND_METRICS,
                     wire.KIND_HEALTH, wire.KIND_PONG, wire.KIND_REPLY, wire.KIND_ERROR,
                     wire.KIND_PONG, wire.KIND_ERROR, "eof", wire.KIND_ERROR, "eof"]
    engine = _engine(tpol)
    for (kind, seq, got), (_, _, want) in zip(mine, ref):
        if kind == wire.KIND_REPLY:
            np.testing.assert_array_equal(got[0], want[0])
            for g, w in zip(got[1:], want[1:]):
                assert (g is None) == (w is None)
                if g is not None:
                    np.testing.assert_allclose(g, w, **TOL)
        else:
            assert got == want, (kind, seq)
    replies = {seq: p for k, seq, p in mine if k == wire.KIND_REPLY}
    _assert_bits(type("R", (), {"phi": replies[1][1], "psi": replies[1][2]}),
                 engine.evaluate(0, x))
    np.testing.assert_array_equal(replies[2][3], engine.evaluate(2, x, prices)[2])
    assert (replies[4][0] == SERVED).all()


@pytest.mark.parametrize("way", ["jax-clients->port-gateway", "port-clients->jax-gateway"])
def test_each_packages_clients_serve_through_the_others_gateway(pair, way):
    jpol, tpol = pair
    feats = _blocks(6, rows=16, seed=2)
    if way.startswith("jax"):
        host, gw_cls, client_v1, client_v2 = (_host(), ServeGateway, JGatewayClient,
                                              JResilientGatewayClient)
        host.add_tenant("d", tpol)
    else:
        host, gw_cls, client_v1, client_v2 = (JServeHost(), JServeGateway, GatewayClient,
                                              ResilientGatewayClient)
        host.add_tenant("d", jpol)
    served = _engine(tpol) if way.startswith("jax") else JHedgeEngine(jpol)
    other = JHedgeEngine(jpol) if way.startswith("jax") else _engine(tpol)
    try:
        with gw_cls(host, port=0) as gw:
            with client_v1(*gw.address, timeout_s=T) as c:
                assert c.ping()
                res = c.submit_block("d", 2, feats[0])
                assert "serve_gateway_rows" in parse_prometheus(c.metrics())
                assert set(c.health()["tenants"]) == {"d"}
            with client_v2(*gw.address, window=4, timeout_s=T) as rc:
                futs = [rc.submit_block_async("d", 1, f) for f in feats]
                results = [f.result(timeout=T) for f in futs]
                assert rc.stats["duplicate_replies"] == 0
    finally:
        host.close()
    want = served.evaluate(2, feats[0])
    np.testing.assert_array_equal(np.asarray(res.phi), np.asarray(want[0]))
    np.testing.assert_allclose(res.phi, np.asarray(other.evaluate(2, feats[0])[0]), **TOL)
    for f, r in zip(feats, results):
        np.testing.assert_array_equal(np.asarray(r.phi), np.asarray(served.evaluate(1, f)[0]))
        np.testing.assert_allclose(r.psi, np.asarray(other.evaluate(1, f)[1]), **TOL)


def test_scrape_parses_alike_and_serves_over_http(policy):
    """``parse_prometheus`` of the port's live gateway exposition equals the JAX
    package's parser's reading; the HTTP sidecar answers /metrics and /healthz,
    and the scrape carries the serve series (under a telemetry session, whose
    registry the counters land in)."""
    with obs.telemetry(None), _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            with GatewayClient(*gw.address, timeout_s=T) as c:
                c.submit_block("d", 0, _blocks(1)[0])
                with pytest.raises(GatewayError):
                    c.submit_block("nobody", 0, _blocks(1)[0])
            text = gw.metrics_text()
            with MetricsServer(gw.metrics_text, health_fn=gw.health_report) as ms:
                base = "http://%s:%d" % ms.address
                with urllib.request.urlopen(base + "/metrics", timeout=T) as r:
                    live = r.read().decode()
                with urllib.request.urlopen(base + "/healthz", timeout=T) as r:
                    health = r.read().decode()
    assert parse_prometheus(text) == jparse_prometheus(text)
    series = parse_prometheus(live)
    for name in ("serve_gateway_rows", "serve_gateway_errors", "guard_shed",
                 "serve_queue_age_seconds", "serve_requests_total",
                 "serve_request_latency_seconds"):
        assert name in series, name
    assert '"tenants"' in health
    snap = top_snapshot(live)
    assert snap["gateway_rows"] >= 8 and snap["errors"] >= 1
    assert "orp top" in render_top(snap, target="gw")


# -- delivery pins ----------------------------------------------------------------


def test_reset_after_submit_replays_from_cache_exactly_once(policy):
    feats = _blocks(12, seed=1)
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            with ResilientGatewayClient(*gw.address, window=1, timeout_s=T) as rc:
                with guard.faults(guard.FaultPlan(fail={"gateway/reply": 1})) as inj:
                    results = [rc.submit_block("d", 0, f) for f in feats]
                assert [s for s, _ in inj.log] == ["gateway/reply"]
                stats = dict(rc.stats)
            totals = gw.totals()
    assert all(r.n_served == 8 for r in results)
    assert stats["reconnects"] == 1 and stats["duplicate_replies"] == 0
    assert totals["submitted_frames"] == 12 and totals["replayed_from_cache"] == 1
    engine = _engine(policy)
    for f, r in zip(feats, results):
        _assert_bits(r, engine.evaluate(0, f))


def test_torn_frame_mid_body_discarded_and_redelivered(policy):
    feats = _blocks(10, seed=2)
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            with ResilientGatewayClient(*gw.address, window=2, timeout_s=T) as rc:
                with guard.faults(guard.FaultPlan(torn_send={"client/send": 1})) as inj:
                    results = [rc.submit_block("d", 0, f) for f in feats]
                assert ("client/send", "torn") in inj.log
                stats = dict(rc.stats)
            totals = gw.totals()
    assert all(r.n_served == 8 for r in results)
    assert stats["reconnects"] == 1 and stats["duplicate_replies"] == 0
    assert totals["submitted_frames"] == 10


def test_gateway_kill_at_frame_k_zero_loss_bitwise(policy):
    rec = bench.gateway_drill(policy, blocks=32, block_rows=8, kill_at_frame=12, seed=3,
                              repeats=1, device="cpu")
    assert rec["rows_lost"] == 0 and rec["duplicate_serves"] == 0
    assert rec["replayed_bits_equal"] is True
    assert rec["reconnects"] >= 1 and rec["replayed_frames"] >= 1
    assert rec["mttr_ms"] is not None and rec["mttr_ms"] > 0
    assert rec["frames_submitted_total"] >= rec["blocks"]


def test_reconnect_budget_exhausted_fails_loudly():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    addr, port = lst.getsockname()[:2]

    def one_shot():
        conn, _ = lst.accept()
        conn.settimeout(2.0)
        _recv(conn)  # the HELLO
        _send(conn, wire.encode_welcome(b"0123456789abcdef", 0))
        time.sleep(0.02)
        conn.close()
        lst.close()

    t = threading.Thread(target=one_shot, daemon=True)
    t.start()
    client = ResilientGatewayClient(
        addr, port, window=2, timeout_s=T,
        retry=GuardPolicy(max_retries=2, backoff_ms=5.0, backoff_cap_ms=10.0))
    try:
        fut = client.submit_block_async("d", 0, _blocks(1)[0])
        with pytest.raises(GatewayError, match="reconnect budget exhausted"):
            fut.result(timeout=T)
        with pytest.raises(GatewayError, match="reconnect budget exhausted"):
            client.submit_block_async("d", 0, _blocks(1)[0])
    finally:
        client.close()
    t.join(5)


def test_client_handshake_bounded_on_dead_but_accepting_endpoint():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    try:
        t0 = time.perf_counter()
        with pytest.raises(OSError, match="dead-but-accepting"):
            ResilientGatewayClient(*lst.getsockname()[:2], timeout_s=0.2,
                                   retry=GuardPolicy(max_retries=0, backoff_ms=1.0))
        assert time.perf_counter() - t0 < 3.0
    finally:
        lst.close()


def test_corrupt_reply_keeps_frame_buffered_for_replay(policy):
    from orp_tpu_torch.serve.client import _Entry
    from orp_tpu_torch.serve.ingest import BlockResult

    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            with ResilientGatewayClient(*gw.address, timeout_s=T) as rc:
                ent = _Entry(99, b"frame-bytes")
                with rc._space:
                    rc._unacked[99] = ent
                res = BlockResult(phi=np.ones(4, np.float32), psi=np.zeros(4, np.float32),
                                  value=None, status=np.zeros(4, np.uint8))
                good = wire.encode_reply(res, seq=99)
                with pytest.raises(wire.WireError):
                    rc._on_frame(good[:-3])
                with rc._space:
                    assert 99 in rc._unacked
                rc._on_frame(good)
                with rc._space:
                    assert 99 not in rc._unacked
                np.testing.assert_array_equal(ent.future.result(timeout=T).phi, res.phi)


def test_stalled_half_frame_evicted_while_healthy_conn_serves(policy):
    feats = _blocks(2, seed=4)
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, default_tenant="d", frame_deadline_s=0.05) as gw:
            stalled = _connect(gw.address)
            try:
                frame = wire.encode_request("d", 0, feats[0])
                t0 = time.perf_counter()
                stalled.sendall(struct.pack("<I", len(frame)) + frame[:20])
                served = 0
                with GatewayClient(*gw.address, timeout_s=T) as healthy:
                    while time.perf_counter() - t0 < 0.12:
                        assert healthy.submit_block("d", 0, feats[1]).n_served == 8
                        served += 1
                assert served > 0
                body = _recv(stalled)
                evicted_at = time.perf_counter()
                assert wire.decode_kind(body) == wire.KIND_ERROR
                assert "frame deadline" in wire.decode_error(body)
                assert _recv(stalled) is None
            finally:
                stalled.close()
            assert evicted_at - t0 < 0.05 * 8 + 0.2  # the deadline plus the 0.12 s loop


def test_injected_stalled_send_recovers_through_eviction(policy):
    feats = _blocks(6, seed=5)
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, frame_deadline_s=0.02) as gw:
            with ResilientGatewayClient(*gw.address, window=1, timeout_s=T) as rc:
                with guard.faults(guard.FaultPlan(stall_send={"client/send": (1, 0.04)})) as inj:
                    results = [rc.submit_block("d", 0, f) for f in feats]
                assert any("stall" in d for _, d in inj.log)
                stats = dict(rc.stats)
    assert all(r.n_served == 8 for r in results)
    assert stats["reconnects"] >= 1 and stats["duplicate_replies"] == 0


def test_busy_backpressure_resends_no_rows_shed(policy):
    feats = _blocks(10, rows=4, seed=6)
    with _host(batcher_kwargs={"max_wait_us": 30_000.0}) as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, max_inflight_replies=1) as gw:
            with ResilientGatewayClient(*gw.address, window=4, timeout_s=T) as rc:
                futs = [rc.submit_block_async("d", 0, f) for f in feats]
                results = [f.result(timeout=T) for f in futs]
                stats = dict(rc.stats)
    assert all(r.n_served == 4 for r in results)
    assert stats["busy"] >= 1 and stats["duplicate_replies"] == 0
    engine = _engine(policy)
    for f, r in zip(feats, results):
        _assert_bits(r, engine.evaluate(0, f))


def test_drain_and_redirect_zero_loss_ledgers_sum(policy):
    n_blocks, rows = 20, 8
    feats = _blocks(n_blocks, rows=rows, seed=7)
    with _host() as host:
        host.add_tenant("d", policy)
        gw_a = ServeGateway(host, port=0)
        gw_b = ServeGateway(host, port=0)
        closer = None
        try:
            with ResilientGatewayClient(*gw_a.address, window=4, timeout_s=T) as rc:
                futs = []
                for i, f in enumerate(feats):
                    futs.append(rc.submit_block_async("d", 0, f))
                    if i == 7:
                        closer = threading.Thread(target=gw_a.close,
                                                  kwargs={"successor": gw_b.address},
                                                  daemon=True)
                        closer.start()
                results = [f.result(timeout=T) for f in futs]
                stats = dict(rc.stats)
            closer.join(T)
            ta, tb = gw_a.totals(), gw_b.totals()
        finally:
            gw_a.close()
            gw_b.close()
    assert all(r.n_served == rows for r in results)
    assert stats["redirects"] >= 1 and stats["duplicate_replies"] == 0
    assert ta["rows"] + tb["rows"] == n_blocks * rows
    assert ta["rows"] > 0 and tb["rows"] > 0
    served = concat_results(results)
    engine = _engine(policy)
    evals = [engine.evaluate(0, f) for f in feats]
    np.testing.assert_array_equal(served.phi, np.concatenate([e[0] for e in evals]))
    np.testing.assert_array_equal(served.psi, np.concatenate([e[1] for e in evals]))


def test_v1_client_during_drain_gets_error_not_redirect(policy):
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            with GatewayClient(*gw.address, timeout_s=T) as v1:
                assert v1.submit_block("d", 0, _blocks(1)[0]).n_served == 8
                gw._redirect = ("127.0.0.1", 1)
                gw._draining.set()
                with pytest.raises(GatewayError, match="draining"):
                    v1.submit_block("d", 0, _blocks(1)[0])
            gw._draining.clear()
            gw._redirect = None


def test_an_aborted_gateway_answers_a_frame_it_already_read_with_nothing(policy):
    """The race a fleet's kill drill hit on the card: a handler that read a
    frame just before ``abort()`` must drop it unanswered (a dead process),
    not answer the draining ERROR a forwarding client would take for the
    producer's error; a gracefully draining gateway still answers it."""
    from orp_tpu_torch.serve.gateway import _Conn

    class Sock:
        def __init__(self):
            self.sent = []

        def send(self, data):
            self.sent.append(bytes(data))
            return len(data)

        def close(self):
            pass

    frame = wire.encode_request("d", 0, _blocks(1)[0])
    with _host() as host:
        host.add_tenant("d", policy)
        gw = ServeGateway(host, port=0)
        try:
            gw._draining.set()  # graceful drain, no successor: the draining ERROR
            st = _Conn(Sock(), {"frames": 0, "rows": 0, "errors": 0})
            assert gw._handle_frame(frame, st) is True
            [sent] = st.sock.sent
            assert "draining" in wire.decode_error(sent[4:])
            gw.abort()
            st = _Conn(Sock(), {"frames": 0, "rows": 0, "errors": 0})
            assert gw._handle_frame(frame, st) is False and st.sock.sent == []
            assert gw.totals()["submitted_frames"] == 0
        finally:
            gw.close()


# -- the ingest gateway's cases ----------------------------------------------------


def _frame_corpus():
    x = _blocks(1, rows=6, nf=1, seed=1)[0]
    p = np.concatenate([x, np.full((6, 1), 0.97, np.float32)], axis=1)
    from orp_tpu_torch.serve.ingest import BlockResult

    res = BlockResult(phi=x[:, 0].copy(), psi=x[:, 0] * 2, value=x[:, 0] * 3,
                      status=np.zeros(6, np.uint8))
    return [wire.encode_request("d", 1, x), wire.encode_request("d", 2, x, p, np.full(6, 9.0)),
            wire.encode_request("d", 0, x, seq=7, trace=(5, 6)), wire.encode_reply(res, seq=3),
            wire.encode_error("no"), wire.encode_ping(), wire.encode_hello(b""),
            wire.encode_busy(4, "later"), wire.encode_metrics(), wire.encode_health(None)]


def test_gateway_fuzz_mutated_frames_answered_within_deadline(policy):
    rng = np.random.default_rng(0xF023)
    corpus = _frame_corpus()
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, default_tenant="d", frame_deadline_s=0.5) as gw:
            for trial in range(24):
                frame = bytearray(corpus[int(rng.integers(len(corpus)))])
                for _ in range(int(rng.integers(1, 6))):
                    frame[int(rng.integers(len(frame)))] ^= int(rng.integers(1, 256))
                prefix = (1 << 30) if trial % 8 == 7 else len(frame)
                s = socket.create_connection(gw.address, timeout=5.0)
                s.settimeout(5.0)
                try:
                    s.sendall(struct.pack("<I", prefix) + bytes(frame))
                    body = _recv(s)
                    if body is not None:
                        assert wire.decode_kind(body) in (
                            wire.KIND_ERROR, wire.KIND_REPLY, wire.KIND_PONG, wire.KIND_WELCOME,
                            wire.KIND_BUSY, wire.KIND_METRICS, wire.KIND_HEALTH)
                finally:
                    s.close()
            with GatewayClient(*gw.address, timeout_s=T) as c:
                assert c.submit_block("d", 0, _blocks(1)[0]).n_served == 8


def test_gateway_loopback_bitwise_equals_direct_evaluate(policy):
    engine = _engine(policy)
    feats = _blocks(1, rows=9, seed=5)[0]
    prices = np.stack([feats[:, 0], np.full(9, 1.02, np.float32)], axis=1)
    with _host(max_live_engines=1) as host:
        host.add_tenant("desk", policy)
        with ServeGateway(host, port=0) as gw:
            with GatewayClient(*gw.address, timeout_s=T) as client:
                assert client.ping()
                res = client.submit_block("desk", 2, feats, prices)
                res_nop = client.submit_block("desk", 2, feats)
                with pytest.raises(GatewayError, match="unknown tenant"):
                    client.submit_block("nobody", 0, feats)
                stats = gw.stats()
    phi, psi, value = engine.evaluate(2, feats, prices)
    assert (res.status == SERVED).all()
    np.testing.assert_array_equal(res.phi, phi)
    np.testing.assert_array_equal(res.psi, psi)
    np.testing.assert_array_equal(res.value, value)
    assert res_nop.value is None
    np.testing.assert_array_equal(res_nop.phi, phi)
    [conn] = stats.values()
    assert conn["frames"] == 4 and conn["rows"] == 18 and conn["errors"] == 1


def test_gateway_answers_malformed_frames_with_error_frames(policy):
    with _host() as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, default_tenant="d") as gw:
            s = _connect(gw.address)
            try:
                _send(s, b"not-a-frame!")
                body = _recv(s)
                assert wire.decode_kind(body) == wire.KIND_ERROR
                assert "orp-ingest" in wire.decode_error(body)
            finally:
                s.close()
            with GatewayClient(*gw.address, timeout_s=T) as client:
                assert client.submit_block("", 0, _blocks(1, rows=3)[0]).n_served == 3


# -- the port's own contracts ------------------------------------------------------


def test_read_only_frame_columns_never_reach_torch_as_views(policy):
    """``wire.decode_request`` hands the host read-only numpy views over the
    frame's bytes; the engine copies them into its padded bucket, so serving
    them raises no "not writable" warning and leaves the frame untouched."""
    x = _blocks(1, rows=5, seed=8)[0]
    frame = wire.encode_request("d", 1, x)
    req = wire.decode_request(frame)
    assert not req["states"].flags.writeable
    with _host() as host:
        host.add_tenant("d", policy)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            res = host.submit_block("d", 1, req["states"]).result(timeout=T)
    _assert_bits(res, _engine(policy).evaluate(1, x))
    assert wire.decode_request(frame)["states"].tobytes() == x.tobytes()


def test_single_row_frames_at_many_dates_ride_one_mixed_dispatch(policy):
    """The gateway's mixed-date lane: single-row frames at every date from
    four connections fill one batch (``max_batch`` rows) and ride ONE mixed
    dispatch, within ``TOL`` of the per-date lane; a lone block keeps the
    bitwise per-date path."""
    n, per = 32, 8
    rng = np.random.default_rng(11)
    rows = (1.0 + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    dates = np.arange(n) % 4
    engine = _engine(policy)
    with _host(batcher_kwargs={"mixed_dates": True, "max_batch": n,
                               "max_wait_us": 5e6}) as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0, max_inflight_replies=n) as gw:
            out = [None] * n

            def producer(k):
                with ResilientGatewayClient(*gw.address, window=per, timeout_s=T) as rc:
                    idx = range(k * per, (k + 1) * per)
                    futs = [rc.submit_block_async("d", int(dates[i]), rows[i:i + 1])
                            for i in idx]
                    for i, f in zip(idx, futs):
                        out[i] = f.result(timeout=T)

            threads = [threading.Thread(target=producer, args=(k,)) for k in range(n // per)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
            eng = host._tenants["d"].engine
            assert eng.cache_info()["mixed_buckets"] == [n]
            assert eng.misses == 1  # one mixed bucket, no per-date dispatch
            with GatewayClient(*gw.address, timeout_s=T) as c:
                lone = c.submit_block("d", 2, rows[:n])  # fills the batch alone
            assert eng.cache_info()["buckets"] == [n]
    got = np.concatenate([r.phi for r in out])
    want = np.concatenate([engine.evaluate(int(d), rows[i:i + 1])[0]
                           for i, d in enumerate(dates)])
    np.testing.assert_allclose(got, want, **TOL)
    _assert_bits(lone, engine.evaluate(2, rows[:n]))
