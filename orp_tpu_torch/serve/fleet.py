"""Horizontal serve fleet (counterpart of ``orp_tpu/serve/fleet.py``): N
gateways fanning frames out to M replicas.

One gateway process fronting one ``ServeHost`` serves one box. A fleet is
many gateway processes, many serve replicas, and one consistent view of which
tenant lives where. This module is that routing layer:

- **deterministic tenant→replica routing** — rendezvous (highest-random-
  weight) hashing over a salt-free keyed digest (:func:`route_weight`,
  ``hashlib.blake2b``): every gateway process computes the IDENTICAL
  mapping from the same replica set, with no coordination, no shared
  state and no per-process hash salting (builtin ``hash()`` is salted per
  process, and using it here would silently split the fleet's routing
  view). The digest is the JAX package's, so a mixed fleet routes alike.
  When a replica drops out, ONLY its tenants move (the rendezvous
  property); everyone else's mapping is untouched.
- **health-driven remapping** — :class:`ReplicaHealth` consumes the
  existing scrape-plane signals (the HEALTH wire kind every gateway already
  answers, draining flag included); a replica that stops answering (or
  reports draining) leaves the healthy set and its tenants remap on the
  next table read. No side-channel probe protocol: the health plane the
  fleet routes on is the one the operator already scrapes.
- **forwarding over the delivery substrate** — :class:`FleetHost` wears
  the ``ServeHost`` submit surface (``submit_block`` → one future), so
  the EXISTING :class:`~orp_tpu_torch.serve.gateway.ServeGateway` fronts it
  unchanged: producers keep their v2 sessions, dedup windows, BUSY
  backpressure and drain-and-redirect against the gateway, while each
  block is forwarded to its mapped replica over a per-replica
  :class:`~orp_tpu_torch.serve.client.ResilientGatewayClient` — the
  reconnect-replay machinery IS the fleet's loss model. A transient
  replica blip is absorbed by that client (reconnect + RESUME + replay,
  exactly-once-serve); a replica DEATH exhausts its fast reconnect
  budget, the replica is marked suspect, and the pending blocks re-route
  to the rendezvous successor — no new loss semantics, the same replay
  buffer and dedup window doing the same job one hop deeper.

The routing-table core (``ReplicaSpec``/``RoutingTable``/
``load_topology``/``fleet_snapshot``) is deliberately stdlib-only and
import-light: ``tests/test_torch_fleet.py`` loads THIS FILE standalone in
subprocesses (different ``PYTHONHASHSEED``) to pin that two gateway
processes agree on every mapping, with no ``torch`` import. Everything that
needs the serve plane imports it lazily.

Replicas on one card: two ``ServeHost`` replicas in one process each run their
batchers' worker threads on the current device of the thread that launches,
which is ``cuda:0`` unless set. A replica built for ``cuda:N`` passes
``engine_kwargs={"device": "cuda:N"}``; the engine pins its own launches to
that device, since the current device is set per thread.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import threading
import time

#: deterministic tenant sample every gateway answers the same way — the
#: ``orp doctor --fleet`` routing-agreement probe's common ground
ROUTE_SAMPLE = tuple(f"tenant-{i:02d}" for i in range(16))


class FleetError(RuntimeError):
    """A fleet-level routing/forwarding failure (the message is flag-speak)."""


class NoHealthyReplica(FleetError):
    """Every replica is out of the healthy set — nothing can take the
    tenant. The caller's future fails loudly; nothing is silently queued."""


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One serve replica: a name (the routing identity — STABLE across
    restarts, or its tenants migrate) and the host:port of its
    ``orp serve-gateway`` ingest front."""

    name: str
    addr: str
    port: int

    @property
    def address(self) -> tuple[str, int]:
        return (self.addr, int(self.port))

    @staticmethod
    def parse(name: str, target: str) -> "ReplicaSpec":
        host, _, port = str(target).rpartition(":")
        if not host or not port.isdigit():
            raise FleetError(
                f"replica {name!r} names {target!r}; expected host:port of "
                "its serve-gateway ingest front")
        return ReplicaSpec(str(name), host, int(port))


def route_weight(tenant: str, replica: str) -> int:
    """The rendezvous weight of ``(tenant, replica)``: a salt-free keyed
    digest (blake2b-64), identical in every process on every box. Builtin
    ``hash()`` is per-process salted (PYTHONHASHSEED) and would give every
    gateway its OWN routing table."""
    h = hashlib.blake2b(f"{tenant}|{replica}".encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class RoutingTable:
    """The fleet's tenant→replica mapping: rendezvous hashing over the
    HEALTHY replicas. Pure and deterministic — two gateways holding the
    same ``(replicas, healthy)`` view compute identical mappings with no
    coordination, and a replica leaving the healthy set moves ONLY its own
    tenants (each remaps to its rendezvous runner-up)."""

    def __init__(self, replicas, healthy=None):
        reps = tuple(sorted(replicas, key=lambda r: r.name))
        names = [r.name for r in reps]
        if len(set(names)) != len(names):
            raise FleetError(f"duplicate replica names in {names} — the "
                             "routing identity must be unique")
        self.replicas = reps
        self.healthy = (frozenset(names) if healthy is None
                        else frozenset(healthy) & frozenset(names))
        self._by_name = {r.name: r for r in reps}

    def replica_for(self, tenant: str, exclude=()) -> ReplicaSpec:
        """The replica serving ``tenant``: highest rendezvous weight among
        healthy replicas (ties broken by name — total order, no salt).
        ``exclude``: replica names additionally struck for THIS decision
        (the re-route path's just-observed-dead set, ahead of the health
        monitor catching up)."""
        candidates = [r for r in self.replicas
                      if r.name in self.healthy and r.name not in exclude]
        if not candidates:
            raise NoHealthyReplica(
                f"no healthy replica for tenant {tenant!r} "
                f"(replicas {[r.name for r in self.replicas]}, healthy "
                f"{sorted(self.healthy)}, excluded {sorted(exclude)}) — "
                "start replicas or fix their health probes")
        return max(candidates,
                   key=lambda r: (route_weight(tenant, r.name), r.name))

    def mapping(self, tenants) -> dict[str, str]:
        """``{tenant: replica_name}`` for a tenant sample — what the doctor
        compares across gateway processes."""
        return {t: self.replica_for(t).name for t in tenants}

    def assigned(self, tenants, replica: str) -> list:
        """The subset of ``tenants`` this table maps to ``replica`` — a
        replica's predictive-prefetch working set. Because the assignment
        is pure rendezvous, the replica can compute its OWN set from the
        shared topology view with no coordination; feed it to
        ``ServeHost.prefetch`` (see ``orp_tpu_torch.store.tier
        .prefetch_assigned``) on bring-up and from
        ``ReplicaHealth.on_change``, so a remap warms the newly-landed
        tenants before their rerouted first request arrives."""
        return [t for t in tenants
                if self.replica_for(t).name == str(replica)]

    def version(self) -> str:
        """Fingerprint of the routing view (replica set + healthy set):
        gateways agreeing on the version agree on every mapping."""
        basis = "|".join(f"{r.name}@{r.addr}:{r.port}" for r in self.replicas)
        basis += "||" + ",".join(sorted(self.healthy))
        return hashlib.sha256(basis.encode("utf-8")).hexdigest()[:12]

    def with_health(self, healthy) -> "RoutingTable":
        return RoutingTable(self.replicas, healthy)


def load_topology(path) -> dict:
    """Parse a fleet ``topology.json``::

        {"gateways": ["127.0.0.1:7433", "127.0.0.1:7434"],
         "replicas": {"r0": "127.0.0.1:7500", "r1": "127.0.0.1:7501"}}

    Returns ``{"gateways": [(addr, port), ...], "replicas":
    [ReplicaSpec, ...]}``. Malformations refuse in flag-speak."""
    p = pathlib.Path(path)
    try:
        doc = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise FleetError(f"topology {p}: {e} — expected a JSON object with "
                         '"gateways" and "replicas"') from None
    if not isinstance(doc, dict) or not isinstance(doc.get("replicas"), dict):
        raise FleetError(
            f'topology {p}: needs a "replicas" object mapping name -> '
            '"host:port" (and optionally a "gateways" list)')
    replicas = [ReplicaSpec.parse(n, t)
                for n, t in sorted(doc["replicas"].items())]
    gateways = []
    for g in doc.get("gateways", ()):
        host, _, port = str(g).rpartition(":")
        if not host or not port.isdigit():
            raise FleetError(f"topology {p}: gateway {g!r} is not host:port")
        gateways.append((host, int(port)))
    if not replicas:
        raise FleetError(f"topology {p}: zero replicas — nothing to route to")
    return {"gateways": gateways, "replicas": replicas}


class ReplicaHealth:
    """The fleet's health view, fed by the scrape plane: a poller
    thread sends each replica the HEALTH wire kind (the same probe ``orp
    top``/``orp doctor --metrics`` use) and keeps a healthy set + per-
    replica health age. A replica is unhealthy after ``fail_after``
    consecutive probe failures, or immediately when it reports
    ``draining`` (its own gateway is already redirecting), or when the
    forwarding path calls :meth:`mark_suspect` (a failed forward is a
    health signal the next probe confirms or clears).

    ``on_change(healthy_set)`` fires OUTSIDE the lock whenever the healthy
    set changes — the FleetHost's remap trigger."""

    def __init__(self, replicas, *, poll_s: float = 1.0,
                 timeout_s: float = 2.0, fail_after: int = 2,
                 on_change=None, start: bool = True):
        self.replicas = tuple(sorted(replicas, key=lambda r: r.name))
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.fail_after = max(1, int(fail_after))
        self.on_change = on_change
        self._lock = threading.Lock()
        self._fails = {r.name: 0 for r in self.replicas}
        self._last_ok = {r.name: None for r in self.replicas}
        self._healthy = frozenset(r.name for r in self.replicas)
        self._closed = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._poll_loop, name="orp-fleet-health", daemon=True)
            self._thread.start()

    # -- reads ----------------------------------------------------------------

    def healthy_set(self) -> frozenset:
        with self._lock:
            return self._healthy

    def table(self) -> RoutingTable:
        return RoutingTable(self.replicas, self.healthy_set())

    def ages(self) -> dict[str, float | None]:
        """Seconds since each replica's last successful probe (None =
        never probed ok) — the staleness column the doctor reports."""
        now = time.perf_counter()
        with self._lock:
            return {n: (None if t is None else round(now - t, 3))
                    for n, t in self._last_ok.items()}

    # -- writes ---------------------------------------------------------------

    def mark_suspect(self, name: str) -> None:
        """Passive health: the forwarding path observed this replica dead
        (reconnect budget exhausted). Take it out of the healthy set NOW —
        the active prober re-admits it when it answers again."""
        with self._lock:
            if name not in self._fails:
                return
            self._fails[name] = self.fail_after
        self._obs_count("fleet/replica_suspect", replica=name)
        self._recompute()

    def probe_once(self) -> frozenset:
        """One synchronous probe round of every replica (what the poll
        thread runs on its interval; tests and the doctor call it directly
        so nothing sleeps). Returns the healthy set after the round."""
        from orp_tpu_torch.serve.gateway import GatewayClient

        for r in self.replicas:
            ok = False
            draining = False
            try:
                with GatewayClient(r.addr, r.port,
                                   timeout_s=self.timeout_s) as c:
                    doc = c.health()
                ok = True
                draining = bool(doc.get("draining"))
            except (OSError, ValueError, RuntimeError):
                ok = False  # counted below; the health table IS the emission
            with self._lock:
                if ok and not draining:
                    self._fails[r.name] = 0
                    self._last_ok[r.name] = time.perf_counter()
                elif draining:
                    # its own gateway is already redirecting producers: out
                    # of the table immediately, no failure count needed
                    self._fails[r.name] = self.fail_after
                else:
                    self._fails[r.name] += 1
        self._recompute()
        return self.healthy_set()

    def _recompute(self) -> None:
        with self._lock:
            healthy = frozenset(n for n, f in self._fails.items()
                                if f < self.fail_after)
            changed = healthy != self._healthy
            self._healthy = healthy
        if changed:
            self._obs_count("fleet/health_change")
            self._flight("fleet_health", healthy=sorted(healthy))
            if self.on_change is not None:
                self.on_change(healthy)

    def _poll_loop(self) -> None:
        while not self._closed.wait(self.poll_s):
            try:
                self.probe_once()
            except Exception:  # orp: noqa[ORP009] -- emitted: the probe-crash counter below is the signal; the poller must outlive one bad round
                self._obs_count("fleet/probe_error")

    @staticmethod
    def _obs_count(name: str, n: int = 1, **labels) -> None:
        from orp_tpu_torch.obs import count

        count(name, n, **labels)

    @staticmethod
    def _flight(kind: str, **fields) -> None:
        from orp_tpu_torch.obs import flight

        flight.record(kind, **fields)

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class FleetHost:
    """The router a fleet gateway fronts: wears the ``ServeHost`` submit
    surface (``submit_block``/``stats``/``registry``/``close``) so the
    existing :class:`~orp_tpu_torch.serve.gateway.ServeGateway` speaks the whole
    v2 delivery protocol to producers unchanged, while every admitted
    block is FORWARDED to its mapped replica.

    Forwarding lane: one :class:`~orp_tpu_torch.serve.client.ResilientGateway
    Client` per replica with a FAST reconnect budget (``retry`` — default
    6 attempts, 20ms doubling to 250ms: a fleet re-routes around a dead
    replica in under a second instead of waiting out a 55s supervisor
    budget). A transient blip never surfaces: the client reconnects,
    RESUMEs its session and replays — exactly-once-serve holds one hop
    deeper. A real death exhausts the budget; the block's done-callback
    marks the replica suspect (:class:`ReplicaHealth` confirms on its next
    probe round) and re-routes the SAME block to the rendezvous successor
    (``max_reroutes`` bounds the walk; every hop excludes the replicas
    already observed dead). The producer-facing future resolves exactly
    once, so fleet-level ``duplicate_serves`` stays 0 by construction.
    """

    def __init__(self, replicas, *, registry=None, health=None,
                 retry=None, window: int = 32, timeout_s: float = 30.0,
                 max_reroutes: int = 3, health_poll_s: float = 1.0,
                 health_timeout_s: float = 2.0, health_fail_after: int = 2):
        from orp_tpu_torch.guard.serve import GuardPolicy
        from orp_tpu_torch.obs import state as obs_state
        from orp_tpu_torch.obs.registry import Registry

        self.replicas = tuple(sorted(replicas, key=lambda r: r.name))
        if not self.replicas:
            raise FleetError("FleetHost needs at least one replica")
        st = obs_state()
        self.registry = (registry if registry is not None
                         else st.registry if st is not None else Registry())
        self._own_health = health is None
        self.health = health if health is not None else ReplicaHealth(
            self.replicas, poll_s=health_poll_s,
            timeout_s=health_timeout_s, fail_after=health_fail_after)
        self.retry = retry if retry is not None else GuardPolicy(
            max_retries=6, backoff_ms=20.0, backoff_cap_ms=250.0)
        self.window = int(window)
        self.timeout_s = float(timeout_s)
        self.max_reroutes = int(max_reroutes)
        self._lock = threading.Lock()
        self._clients: dict[str, object] = {}
        self._table: RoutingTable | None = None
        self._pending = {r.name: 0 for r in self.replicas}
        self._rows = {r.name: 0 for r in self.replicas}
        self._closed = False
        # per-replica scrape series interned ONCE here (handles kept): the
        # fleet gateway's /metrics answers routing
        # state before the first frame arrives
        self._healthy_gauge = {
            r.name: self.registry.gauge("fleet/replica_healthy",
                                        {"replica": r.name})
            for r in self.replicas
        }
        self._rows_counter = {
            r.name: self.registry.counter("fleet/forwarded_rows",
                                          {"replica": r.name})
            for r in self.replicas
        }

    # -- routing ---------------------------------------------------------------

    def table(self) -> RoutingTable:
        # called per forwarded block: rebuild the table (and touch the
        # gauges) only when the healthy set actually changed — the
        # rendezvous table is pure in (replicas, healthy)
        healthy = self.health.healthy_set()
        with self._lock:
            cached = self._table
        if cached is not None and cached.healthy == healthy:
            return cached
        t = RoutingTable(self.replicas, healthy)
        for name, g in self._healthy_gauge.items():
            g.set(1.0 if name in t.healthy else 0.0)
        with self._lock:
            self._table = t
        return t

    def route_sample(self, tenants=None) -> dict:
        """The routing view the HEALTH wire kind exports: version, healthy
        set, per-replica health age, and the mapping of a tenant sample —
        what ``orp doctor --fleet`` compares across gateways."""
        table = self.table()
        sample = list(tenants) if tenants else list(ROUTE_SAMPLE)
        try:
            mapping = table.mapping(sample)
        except NoHealthyReplica:
            mapping = {}
        return {
            "version": table.version(),
            "replicas": [r.name for r in table.replicas],
            "healthy": sorted(table.healthy),
            "ages_s": self.health.ages(),
            "map": mapping,
        }

    # -- forwarding ------------------------------------------------------------

    def _client(self, spec: ReplicaSpec):
        """The live forwarding client for ``spec`` — rebuilt when the
        previous one died (budget exhausted) or was closed. Construction
        connects (fast to a live replica, OSError to a dead one — the
        caller treats that exactly like a dead client)."""
        from orp_tpu_torch.serve.client import ResilientGatewayClient

        with self._lock:
            c = self._clients.get(spec.name)
            if c is not None and not c.dead:
                return c
        # connect OUTSIDE the lock (a slow connect
        # must not head-of-line-block other replicas' forwards)
        fresh = ResilientGatewayClient(spec.addr, spec.port,
                                       window=self.window, retry=self.retry,
                                       timeout_s=self.timeout_s)
        with self._lock:
            closed = self._closed
            if not closed:  # raced close(): nothing may own this client now
                cur = self._clients.get(spec.name)
                if cur is None or cur.dead:
                    self._clients[spec.name] = fresh
                    return fresh
        if closed:
            fresh.close()
            raise FleetError("FleetHost is closed")
        # lost the build race to a concurrent forward: use the winner
        fresh.close()
        return cur

    def submit_block(self, tenant: str, date_idx: int, states, prices=None,
                     deadlines=None, *, trace=None):
        """Route one block to ``tenant``'s replica; returns a future
        resolving to its :class:`~orp_tpu_torch.serve.ingest.BlockResult` —
        across replica blips (absorbed by reconnect-replay) and replica
        deaths (re-routed to the rendezvous successor)."""
        from orp_tpu_torch.serve.batcher import SlimFuture

        with self._lock:
            if self._closed:
                raise RuntimeError("FleetHost is closed")
        outer = SlimFuture()
        self._forward(outer, tenant, int(date_idx), states, prices,
                      deadlines, trace, tried=())
        return outer

    def _forward(self, outer, tenant, date_idx, states, prices, deadlines,
                 trace, tried) -> None:
        from orp_tpu_torch.obs import count as obs_count
        from orp_tpu_torch.serve.gateway import GatewayError

        with self._lock:
            if self._closed:
                # the callback-driven re-route path can land here AFTER
                # close() — rebuilding a client now would leak its socket
                # and reader thread past shutdown
                outer.set_exception(FleetError(
                    "FleetHost closed while the block was re-routing — "
                    "it was NOT forwarded; resubmit on the new host"))
                return
        try:
            target = self.table().replica_for(tenant, exclude=tried)
        except NoHealthyReplica as e:
            outer.set_exception(e)
            return
        try:
            client = self._client(target)
            inner = client.submit_block_async(
                tenant, date_idx, states, prices, deadlines, trace=trace)
        except (OSError, RuntimeError, ValueError) as e:
            self._replica_failed(outer, tenant, date_idx, states, prices,
                                 deadlines, trace, tried, target, e)
            return
        with self._lock:
            self._pending[target.name] += 1
        n_rows = getattr(states, "shape", (1,))[0]

        def _done(f, name=target.name, client=client):
            with self._lock:
                self._pending[name] -= 1
            err = f.exception()
            if err is None:
                with self._lock:
                    self._rows[name] += n_rows
                self._rows_counter[name].inc(n_rows)
                outer.set_result(f.result())
                return
            dead = isinstance(err, OSError) or getattr(client, "dead", True)
            if isinstance(err, (GatewayError, OSError)) and dead:
                # the replica DIED under the frame (reconnect budget
                # exhausted / refused): re-route to the rendezvous
                # successor — the block is still in OUR hands, nothing
                # was lost, and the dead replica can never answer twice
                self._replica_failed(outer, tenant, date_idx, states,
                                     prices, deadlines, trace, tried,
                                     target, err)
                return
            # the replica ANSWERED (a structured ERROR frame — unknown
            # tenant, malformed block, a guard verdict): that is the
            # PRODUCER's error, not a health signal — re-routing it would
            # let one poison frame walk the whole fleet out of the
            # healthy set (found live: an unknown tenant marked every
            # replica suspect until NoHealthyReplica)
            outer.set_exception(err)

        inner.add_done_callback(_done)
        obs_count("fleet/forwarded", sink_event=False, replica=target.name)

    def _replica_failed(self, outer, tenant, date_idx, states, prices,
                        deadlines, trace, tried, target, err) -> None:
        from orp_tpu_torch.obs import count as obs_count
        from orp_tpu_torch.obs import flight

        obs_count("fleet/reroute", replica=target.name)
        flight.record("fleet_reroute", replica=target.name, tenant=tenant,
                      why=f"{type(err).__name__}: {err}"[:120])
        self.health.mark_suspect(target.name)
        tried = (*tried, target.name)
        if len(tried) > self.max_reroutes:
            outer.set_exception(FleetError(
                f"block for tenant {tenant!r} failed on {len(tried)} "
                f"replicas ({', '.join(tried)}): {err} — the fleet is "
                "down, not one replica"))
            return
        self._forward(outer, tenant, date_idx, states, prices, deadlines,
                      trace, tried)

    # -- the ServeHost-shaped introspection surface ---------------------------

    def stats(self) -> dict:
        """Per-replica forwarding state in the shape the gateway's health
        document expects (``live``/``pending``/``version`` per row)."""
        table = self.health.table()
        version = table.version()
        with self._lock:
            return {
                r.name: {
                    "live": r.name in table.healthy,
                    "pending": self._pending[r.name],
                    "version": version,
                    "rows": self._rows[r.name],
                    "address": f"{r.addr}:{r.port}",
                }
                for r in self.replicas
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
        if self._own_health:
            self.health.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- fleet dashboard aggregation ----------------------------------------------


def fleet_snapshot(per_gateway: dict) -> dict:
    """Merge per-gateway ``top_snapshot`` digests into one fleet view:
    summed rates and totals, the per-gateway table (p99/queue-age/shed),
    and routing agreement (``routing_consistent`` — every gateway's
    routing version identical). ``per_gateway``: ``{target: {"snap":
    top_snapshot(...), "routing": health_doc["routing"] | None}}``."""
    agg = {"requests": 0.0, "rows": 0.0, "gateway_rows": 0.0, "shed": 0.0,
           "busy": 0.0, "errors": 0.0}
    rates: dict[str, float] = {}
    gateways = {}
    versions = set()
    viewless = []
    for target, info in sorted(per_gateway.items()):
        snap = info["snap"]
        for k in agg:
            agg[k] += snap.get(k) or 0.0
        for k, v in (snap.get("rates") or {}).items():
            rates[k] = rates.get(k, 0.0) + v
        routing = info.get("routing") or {}
        if routing.get("version"):
            versions.add(routing["version"])
        else:
            # a gateway with NO routing view (a plain serving gateway
            # listed as a fleet gateway) is exactly the split-fleet
            # misconfiguration this line exists to expose — it must
            # never read as agreement
            viewless.append(target)
        gateways[target] = {
            "queue_age_p99_ms": snap.get("queue_age_p99_ms"),
            "gateway_rows": snap.get("gateway_rows"),
            "shed": snap.get("shed"),
            "busy": snap.get("busy"),
            "errors": snap.get("errors"),
            "rates": snap.get("rates") or {},
            "routing_version": routing.get("version"),
            "healthy": routing.get("healthy"),
        }
    return {
        **agg,
        "rates": rates,
        "gateways": gateways,
        "routing_versions": sorted(versions),
        "routing_viewless": viewless,
        "routing_consistent": len(versions) == 1 and not viewless,
    }


def render_fleet_top(snap: dict) -> str:
    """The ``orp top --fleet`` screen: fleet-wide rates + the per-gateway
    table + the routing-agreement line."""
    r = snap.get("rates", {})

    def rate(field):
        v = r.get(field + "_per_s")
        return "-" if v is None else f"{v:,.1f}/s"

    lines = [
        f"orp top — fleet ({len(snap.get('gateways') or {})} gateway(s))",
        f"req {rate('requests')}  gw-rows {rate('gateway_rows')}  "
        f"shed {rate('shed')}  busy {rate('busy')}  "
        f"errors {snap.get('errors', 0):,.0f}  routing "
        + ("CONSISTENT " + snap["routing_versions"][0]
           if snap.get("routing_consistent")
           else (f"NO VIEW from {snap.get('routing_viewless')}"
                 if snap.get("routing_viewless")
                 else f"SPLIT {snap.get('routing_versions')}")),
    ]
    gws = snap.get("gateways") or {}
    if gws:
        lines.append(f"{'gateway':<22}{'gw-rows':>12}{'shed':>8}{'busy':>8}"
                     f"{'errors':>8}{'queue p99 ms':>14}{'version':>14}")
        for target in sorted(gws):
            g = gws[target]

            def cell(v, fmt):
                return "-" if v is None else format(v, fmt)

            lines.append(
                f"{target:<22}"
                f"{cell(g.get('gateway_rows'), ',.0f'):>12}"
                f"{cell(g.get('shed'), ',.0f'):>8}"
                f"{cell(g.get('busy'), ',.0f'):>8}"
                f"{cell(g.get('errors'), ',.0f'):>8}"
                f"{cell(g.get('queue_age_p99_ms'), '.3f'):>14}"
                f"{(g.get('routing_version') or '-'):>14}")
    return "\n".join(lines)
