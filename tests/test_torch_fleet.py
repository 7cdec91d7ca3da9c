"""The port's fleet and shared-memory lanes on the CPU (``orp_tpu_torch/serve/
{fleet,shm}.py``, the batcher's cross-connection coalescing, and
``serve/bench.fleet_phase``), held against the JAX package's.

The routing table is the fleet's founding invariant: for the same replica
specs both packages compute the same ``RoutingTable.version()``, the same
``mapping(ROUTE_SAMPLE)`` and the same ``route_weight``, so a mixed fleet
routes alike; the port's ``fleet.py``, loaded standalone by path in
subprocesses under two ``PYTHONHASHSEED`` values, agrees with itself and
imports no ``torch``. The ring's file layout is the JAX package's: a ring
created by either package is attached by the other. Everything served is
bitwise the port's own ``HedgeEngine`` on the CPU.

Every wait is bounded, every gateway, host, client and ring is closed in a
``with`` block or a ``finally``, ring files live under ``tmp_path``, and no
sleep is longer than 50 ms."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from orp_tpu.serve import fleet as jfleet
from orp_tpu.serve.shm import RingPair as JRingPair
from orp_tpu_torch.guard import GuardPolicy
from orp_tpu_torch.serve import (GatewayClient, GatewayError, HedgeEngine, MicroBatcher,
                                 ServeGateway, ServeHost, bench, wire)
from orp_tpu_torch.serve import fleet as fleet_mod
from orp_tpu_torch.serve.fleet import (ROUTE_SAMPLE, FleetError, FleetHost, NoHealthyReplica,
                                       ReplicaHealth, ReplicaSpec, RoutingTable, fleet_snapshot,
                                       load_topology, render_fleet_top, route_weight)
from orp_tpu_torch.serve.metrics import ServingMetrics
from orp_tpu_torch.serve.shm import RingClient, RingError, RingPair, RingServer

from test_torch_serve import _pair

CPU = {"device": "cpu"}
T = 10.0
FAST_RETRY = GuardPolicy(max_retries=2, backoff_ms=2.0, backoff_cap_ms=10.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def policy():
    return _pair(n_features=1, n_dates=4, seed=3)[1]


def _engine(policy):
    return HedgeEngine(policy, device="cpu")


def _rows(n, nf=1, seed=0):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.1 * rng.standard_normal((n, nf))).astype(np.float32)


def _specs(n, base=7500, pkg=fleet_mod):
    return [pkg.ReplicaSpec(f"r{i}", "127.0.0.1", base + i) for i in range(n)]


def _bits(res, want):
    np.testing.assert_array_equal(res.phi, want[0])
    np.testing.assert_array_equal(res.psi, want[1])


# -- routing ----------------------------------------------------------------------


@pytest.mark.parametrize("healthy", [None, {"r0", "r2", "r4"}, {"r3"}])
def test_routing_table_equal_to_the_jax_packages(healthy):
    mine = RoutingTable(_specs(5), healthy=healthy)
    ref = jfleet.RoutingTable(_specs(5, pkg=jfleet), healthy=healthy)
    assert mine.version() == ref.version()
    assert mine.mapping(ROUTE_SAMPLE) == ref.mapping(jfleet.ROUTE_SAMPLE)
    tenants = [f"desk-{i}" for i in range(40)]
    assert mine.mapping(tenants) == ref.mapping(tenants)
    assert mine.assigned(tenants, "r0") == ref.assigned(tenants, "r0")
    assert ROUTE_SAMPLE == jfleet.ROUTE_SAMPLE
    for t in tenants[:8]:
        for r in ("r0", "r4", "replica-x"):
            assert route_weight(t, r) == jfleet.route_weight(t, r)


def test_routing_identical_across_processes_despite_hash_salt():
    script = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('fleet_sa', sys.argv[1])\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "sys.modules['fleet_sa'] = m\n"
        "spec.loader.exec_module(m)\n"
        "reps = [m.ReplicaSpec(f'r{i}', '127.0.0.1', 7500 + i) for i in range(5)]\n"
        "t = m.RoutingTable(reps)\n"
        "print(json.dumps({'version': t.version(), 'map': t.mapping(list(m.ROUTE_SAMPLE)),"
        " 'torch': 'torch' in sys.modules, 'pkg': any(k.startswith('orp_tpu')"
        " for k in sys.modules)}))\n")
    views = []
    for seed in ("1", "31337"):
        env = {**os.environ, "PYTHONHASHSEED": seed}
        out = subprocess.run([sys.executable, "-c", script, fleet_mod.__file__],
                             capture_output=True, text=True, env=env, timeout=60, check=True)
        views.append(json.loads(out.stdout))
    assert views[0] == views[1]
    assert views[0]["torch"] is False and views[0]["pkg"] is False
    ref = jfleet.RoutingTable(_specs(5, pkg=jfleet))
    assert views[0]["version"] == ref.version()
    assert views[0]["map"] == ref.mapping(list(ROUTE_SAMPLE))


def test_rendezvous_drop_moves_only_the_dead_replicas_tenants():
    tenants = [f"desk-{i}" for i in range(64)]
    before = RoutingTable(_specs(4)).mapping(tenants)
    after = RoutingTable(_specs(4), healthy={"r0", "r1", "r3"}).mapping(tenants)
    moved = {t for t in tenants if before[t] != after[t]}
    assert moved and all(before[t] == "r2" for t in moved)
    assert all(after[t] != "r2" for t in tenants)
    assert RoutingTable(_specs(4)).version() != RoutingTable(
        _specs(4), healthy={"r0", "r1", "r3"}).version()


def test_no_healthy_replica_fails_loudly():
    with pytest.raises(NoHealthyReplica, match="start replicas"):
        RoutingTable(_specs(2), healthy=()).replica_for("desk-a")
    with pytest.raises(FleetError, match="duplicate replica names"):
        RoutingTable(_specs(2) + _specs(1))


def test_load_topology_refuses_malformations(tmp_path):
    bad = tmp_path / "t.json"
    bad.write_text("not json")
    with pytest.raises(FleetError, match="expected a JSON object"):
        load_topology(bad)
    bad.write_text(json.dumps({"replicas": {"r0": "no-port-here"}}))
    with pytest.raises(FleetError, match="host:port"):
        load_topology(bad)
    bad.write_text(json.dumps({"replicas": {}}))
    with pytest.raises(FleetError, match="zero replicas"):
        load_topology(bad)
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"gateways": ["127.0.0.1:7433"],
                                "replicas": {"r0": "127.0.0.1:7500", "r1": "127.0.0.1:7501"}}))
    topo = load_topology(good)
    assert [r.name for r in topo["replicas"]] == ["r0", "r1"]
    assert topo["gateways"] == [("127.0.0.1", 7433)]
    assert topo["replicas"] == [ReplicaSpec(r.name, r.addr, r.port)
                                for r in jfleet.load_topology(good)["replicas"]]


# -- cross-connection coalescing ------------------------------------------------------


def test_coalesced_blocks_bitwise_vs_uncoalesced_per_connection(policy):
    engine = _engine(policy)
    blocks = [_rows(16, seed=s) for s in range(6)]
    results, dispatches = {}, {}
    for coalesce in (True, False):
        metrics = ServingMetrics()
        with MicroBatcher(engine, max_batch=16 * len(blocks), max_wait_us=5000.0,
                          metrics=metrics, coalesce_blocks=coalesce) as mb:
            with mb._cv:
                futures = [mb.submit_block(0, b) for b in blocks]
            results[coalesce] = [f.result(timeout=T) for f in futures]
        dispatches[coalesce] = metrics.summary()["dispatches"]
    for a, b in zip(results[True], results[False]):
        np.testing.assert_array_equal(a.phi, b.phi)
        np.testing.assert_array_equal(a.psi, b.psi)
        np.testing.assert_array_equal(a.status, b.status)
    assert dispatches[True] == 1 and dispatches[False] == len(blocks)
    for blk, res in zip(blocks, results[True]):
        _bits(res, engine.evaluate(0, blk))
    rec = bench.coalesce_pin(engine, _rows(64, seed=9), blocks=8, block_rows=8,
                             max_wait_us=500.0)
    assert rec["bitwise_equal"] and rec["dispatches_coalesced"] == 1


def test_coalescing_keeps_guard_status_columns(policy):
    engine = _engine(policy)
    b1, b2 = _rows(8, seed=1), _rows(8, seed=2)
    dl = np.full(8, 60.0)
    dl[:3] = -1.0
    with MicroBatcher(engine, max_batch=64, max_wait_us=5000.0,
                      policy=GuardPolicy(deadline_ms=50.0), coalesce_blocks=True) as mb:
        with mb._cv:
            f1 = mb.submit_block(0, b1)
            f2 = mb.submit_block(0, b2, deadlines=dl)
        r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert not r1.status.any()
    assert (r2.status[:3] != 0).all() and not r2.status[3:].any()
    np.testing.assert_array_equal(r1.phi, engine.evaluate(0, b1)[0])
    np.testing.assert_array_equal(r2.phi[3:], engine.evaluate(0, b2[3:])[0])


# -- fleet fan-out ------------------------------------------------------------------


def _replica(policy, tenants):
    host = ServeHost(max_live_engines=max(4, len(tenants)), engine_kwargs=CPU)
    for t in tenants:
        host.add_tenant(t, policy)
    return host, ServeGateway(host, port=0)


def _close(fleets, hosts_gws):
    for fh in fleets:
        fh.close()
    for h, g in hosts_gws:
        g.close(timeout=5.0)
        h.close()


def test_fleet_forwards_bitwise_with_routing_agreement(policy):
    engine = _engine(policy)
    tenants = [f"desk-{i}" for i in range(4)]
    hosts_gws = [_replica(policy, tenants) for _ in range(2)]
    specs = [ReplicaSpec(f"r{i}", *hg[1].address) for i, hg in enumerate(hosts_gws)]
    fleets = [FleetHost(specs, retry=FAST_RETRY, timeout_s=T,
                        health=ReplicaHealth(specs, start=False)) for _ in range(2)]
    try:
        views = [fh.route_sample(tenants) for fh in fleets]
        assert views[0]["version"] == views[1]["version"]
        assert views[0]["map"] == views[1]["map"]
        assert set(views[0]["map"].values()) == {"r0", "r1"}
        for i, t in enumerate(tenants):
            feats = _rows(16, seed=10 + i)
            res = fleets[i % 2].submit_block(t, 0, feats).result(timeout=T)
            _bits(res, engine.evaluate(0, feats))
            assert not res.status.any()
        stats = fleets[0].stats()
        assert set(stats) == {"r0", "r1"} and all(s["live"] for s in stats.values())
    finally:
        _close(fleets, hosts_gws)


def test_kill_one_replica_remaps_tenants_zero_loss(policy):
    engine = _engine(policy)
    tenants = [f"desk-{i}" for i in range(6)]
    hosts_gws = [_replica(policy, tenants) for _ in range(2)]
    specs = [ReplicaSpec(f"r{i}", *hg[1].address) for i, hg in enumerate(hosts_gws)]
    fleet = FleetHost(specs, retry=FAST_RETRY, timeout_s=T,
                      health=ReplicaHealth(specs, start=False))
    try:
        mapping = fleet.table().mapping(tenants)
        victim = mapping[tenants[0]]
        affected = {t for t in tenants if mapping[t] == victim}
        warm = {t: fleet.submit_block(t, 0, _rows(8, seed=50)) for t in tenants}
        for fut in warm.values():
            assert not fut.result(timeout=T).status.any()
        hosts_gws[int(victim[1:])][1].abort()
        blocks = {t: _rows(16, seed=60 + i) for i, t in enumerate(tenants)}
        futs = {t: fleet.submit_block(t, 0, blocks[t]) for t in tenants}
        for t, fut in futs.items():
            res = fut.result(timeout=T)
            _bits(res, engine.evaluate(0, blocks[t]))
            assert not res.status.any()
        assert sum(c.stats["duplicate_replies"] for c in fleet._clients.values()) == 0
        remapped = fleet.table().mapping(tenants)
        assert all(r != victim for r in remapped.values())
        assert {t for t in tenants if mapping[t] != remapped[t]} == affected
    finally:
        _close([fleet], hosts_gws)


def test_poison_frame_error_passes_through_without_reroute(policy):
    host, rep_gw = _replica(policy, ["desk-0"])
    specs = [ReplicaSpec("r0", *rep_gw.address), ReplicaSpec("r1", *rep_gw.address)]
    fleet = FleetHost(specs, retry=FAST_RETRY, timeout_s=T,
                      health=ReplicaHealth(specs, start=False))
    try:
        with pytest.raises(GatewayError, match="(?i)tenant"):
            fleet.submit_block("nope", 0, _rows(4)).result(timeout=T)
        assert fleet.table().healthy == frozenset({"r0", "r1"})
        assert not fleet.submit_block("desk-0", 0, _rows(4)).result(timeout=T).status.any()
    finally:
        _close([fleet], [(host, rep_gw)])


def test_health_probe_drops_dead_replica_and_readmits(policy):
    import socket

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    changes = []
    specs = [ReplicaSpec("r0", "127.0.0.1", lsock.getsockname()[1]),
             ReplicaSpec("r1", "127.0.0.1", 1)]
    h = ReplicaHealth(specs, start=False, fail_after=1, timeout_s=0.3,
                      on_change=lambda s: changes.append(s))
    try:
        assert h.probe_once() == frozenset()
        assert changes and changes[-1] == frozenset()
        assert h.ages() == {"r0": None, "r1": None}
        h.mark_suspect("nope")
    finally:
        h.close()
        lsock.close()
    # a live replica re-admits on the next round
    host, gw = _replica(policy, ["d"])
    try:
        live = ReplicaHealth([ReplicaSpec("r0", *gw.address)], start=False, fail_after=1,
                             timeout_s=T)
        live.mark_suspect("r0")
        assert live.healthy_set() == frozenset()
        assert live.probe_once() == frozenset({"r0"})
        assert live.ages()["r0"] is not None
        live.close()
    finally:
        _close([], [(host, gw)])


def test_fleet_snapshot_aggregates_and_flags_split_routing():
    snap_a = {"requests": 10.0, "rows": 100.0, "gateway_rows": 100.0, "shed": 1.0,
              "busy": 0.0, "errors": 0.0, "rates": {"requests_per_s": 5.0},
              "queue_age_p99_ms": 2.0}
    snap_b = {**snap_a, "rates": {"requests_per_s": 7.0}}
    per = {"g1": {"snap": snap_a, "routing": {"version": "aaa"}},
           "g2": {"snap": snap_b, "routing": {"version": "aaa"}}}
    agg = fleet_snapshot(per)
    assert agg == jfleet.fleet_snapshot(per)
    assert agg["routing_consistent"] is True
    assert agg["rates"]["requests_per_s"] == pytest.approx(12.0)
    assert "CONSISTENT aaa" in render_fleet_top(agg)
    per["g2"]["routing"] = {"version": "bbb"}
    split = fleet_snapshot(per)
    assert split["routing_consistent"] is False and split["routing_versions"] == ["aaa", "bbb"]
    per["g2"]["routing"] = None
    noview = fleet_snapshot(per)
    assert noview["routing_consistent"] is False and noview["routing_viewless"] == ["g2"]
    assert render_fleet_top(noview) == jfleet.render_fleet_top(noview)


def test_gateway_health_carries_routing_view(policy):
    host, rep_gw = _replica(policy, ["desk-0"])
    specs = [ReplicaSpec("r0", *rep_gw.address)]
    fleet = FleetHost(specs, retry=FAST_RETRY, timeout_s=T,
                      health=ReplicaHealth(specs, start=False))
    fleet_gw = ServeGateway(fleet, port=0)
    try:
        with GatewayClient(*fleet_gw.address, timeout_s=T) as c:
            routing = c.health(route=["desk-0", "desk-1"])["routing"]
        assert routing["version"] == jfleet.RoutingTable(
            [jfleet.ReplicaSpec("r0", *rep_gw.address)]).version()
        assert routing["map"] == {"desk-0": "r0", "desk-1": "r0"}
        assert routing["healthy"] == ["r0"]
        with GatewayClient(*rep_gw.address, timeout_s=T) as c:
            assert "routing" not in c.health()
    finally:
        fleet_gw.close(timeout=5.0)
        _close([fleet], [(host, rep_gw)])


def test_fleet_phase_at_one_and_two_replicas(policy):
    rec = bench.fleet_phase(policy, replica_counts=(1, 2), gateways=2, tenants=3,
                            blocks_per_tenant=3, block_rows=8, repeats=1, device="cpu")
    assert [lv["replicas"] for lv in rec["levels"]] == [1, 2]
    for lv in rec["levels"]:
        assert lv["routing_consistent"] and lv["bitwise_equal"] and lv["rows_per_s"] > 0
    drill = rec["kill_drill"]
    assert drill["rows_lost"] == 0 and drill["duplicate_serves"] == 0
    assert drill["tenants_remapped"] >= 1 and drill["rows_served"] == drill["rows_sent"]
    assert rec["coalesce"]["bitwise_equal"]


# -- the shared-memory ring -----------------------------------------------------------


def test_ring_wraparound_preserves_every_frame_bitwise(tmp_path):
    pair = RingPair.create(tmp_path / "r.shm", req_capacity=4096, rep_capacity=4096)
    try:
        ring = pair.request
        rng = np.random.default_rng(7)
        for i in range(200):
            frame = rng.integers(0, 256, size=int(rng.integers(1, 700)),
                                 dtype=np.uint8).tobytes() + bytes([i % 256])
            assert ring.push(frame) is True
            assert ring.pop() == frame, i
        assert ring.pop() is None and ring.depth() == 0
    finally:
        pair.unlink()


def test_ring_full_refuses_with_busy_parity_then_drains(tmp_path):
    pair = RingPair.create(tmp_path / "r.shm", req_capacity=4096, rep_capacity=4096)
    try:
        ring, frame, pushed = pair.request, bytes(900), 0
        while ring.push(frame):
            pushed += 1
            assert pushed < 100
        assert ring.push(frame) is False
        assert ring.pop() == frame
        assert ring.push(frame) is True
        with pytest.raises(wire.WireError, match="record cap"):
            ring.push(bytes(4096))
    finally:
        pair.unlink()


def test_ring_torn_write_detected_not_consumed(tmp_path):
    pair = RingPair.create(tmp_path / "r.shm", req_capacity=4096, rep_capacity=4096)
    try:
        assert pair.request.push(b"frame-before-the-crash")
        struct.pack_into("<Q", pair._mm, 64, 1)  # the head seqlock left odd
        with pytest.raises(RingError, match="torn write"):
            pair.request.pop()
    finally:
        pair.unlink()


def test_ring_attach_refuses_foreign_and_truncated(tmp_path):
    foreign = tmp_path / "foreign.shm"
    foreign.write_bytes(b"\x00" * 256)
    with pytest.raises(RingError, match="bad magic"):
        RingPair.attach(foreign)
    tiny = tmp_path / "tiny.shm"
    tiny.write_bytes(b"\x00" * 8)
    with pytest.raises(RingError, match="no orp shm ring"):
        RingPair.attach(tiny)
    pair = RingPair.create(path=tmp_path / "real.shm", req_capacity=4096, rep_capacity=4096)
    try:
        with open(pair.path, "r+b") as f:
            f.truncate(512)
        with pytest.raises(RingError, match="truncated ring"):
            RingPair.attach(pair.path)
    finally:
        pair.unlink()


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_ring_created_by_one_package_attaches_in_the_other(tmp_path, creator):
    make, attach = ((JRingPair.create, RingPair.attach) if creator == "jax"
                    else (RingPair.create, JRingPair.attach))
    made = make(tmp_path / "x.shm", req_capacity=8192, rep_capacity=4096)
    other = attach(tmp_path / "x.shm")
    try:
        assert other.request.capacity == 8192 and other.reply.capacity == 4096
        frames = [bytes([i]) * (23 * i + 1) for i in range(40)]
        for f in frames:  # many laps of the 4096-byte reply ring
            assert made.reply.push(f) and other.reply.pop() == f
            assert other.request.push(f) and made.request.pop() == f
        made.close()
        assert other.closed
    finally:
        other.detach()
        made.unlink()


def test_ring_client_server_end_to_end_bitwise(policy, tmp_path):
    engine = _engine(policy)
    blocks = [_rows(32, seed=80 + i) for i in range(12)]
    with ServeHost(max_live_engines=1, engine_kwargs=CPU) as host:
        host.add_tenant("shm", policy)
        pair = RingPair.create(tmp_path / "r.shm", req_capacity=1 << 18, rep_capacity=1 << 18)
        try:
            with RingServer(host, pair, default_tenant="shm") as server:
                with RingClient(pair.path, window=4, timeout_s=T) as client:
                    assert client.ping(timeout_s=T)
                    futs = [client.submit_block_async("shm", i % 4, b)
                            for i, b in enumerate(blocks)]
                    results = [f.result(timeout=T) for f in futs]
                    assert client.stats["duplicate_replies"] == 0
                    client.pair.detach()
                totals = server.totals()
        finally:
            pair.unlink()
    for i, (blk, res) in enumerate(zip(blocks, results)):
        _bits(res, engine.evaluate(i % 4, blk))
        assert not res.status.any()
    assert totals["submitted_frames"] == len(blocks) and totals["errors"] == 0
    assert totals["rows"] == sum(b.shape[0] for b in blocks)


def test_ring_server_answers_malformed_frames_with_error(policy, tmp_path):
    with ServeHost(max_live_engines=1, engine_kwargs=CPU) as host:
        host.add_tenant("shm", policy)
        pair = RingPair.create(tmp_path / "r.shm", req_capacity=1 << 16, rep_capacity=1 << 16)
        try:
            with RingServer(host, pair, default_tenant="shm") as server:
                with RingClient(pair, window=4, timeout_s=T) as client:
                    assert pair.request.push(b"GARBAGE-NOT-A-FRAME" * 3)
                    assert not client.submit_block("shm", 0, _rows(8, seed=5)).status.any()
                    with pytest.raises(GatewayError, match="unknown tenant"):
                        client.submit_block("nobody", 0, _rows(8, seed=5))
                assert server.totals()["errors"] >= 2
        finally:
            pair.unlink()
