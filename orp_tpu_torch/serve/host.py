"""Multi-tenant serving host: many policy bundles, one process, one budget
(counterpart of ``orp_tpu/serve/host.py``).

A serve fleet packs many small policies (per desk, per product, per cohort)
into each process and shares the card between them. This module is that
packing layer on top of the continuous batcher:

- **tenants** - each a policy (bundle directory or in-memory
  ``PolicyBundle``/``PipelineResult``) served by its own
  :class:`~orp_tpu_torch.serve.batcher.MicroBatcher` + ``HedgeEngine``, with
  its own optional :class:`~orp_tpu_torch.guard.GuardPolicy`.
- **LRU engine cap** - at most ``max_live_engines`` tenants keep a live
  engine and batcher. Submitting to a cold tenant activates it and, over
  the cap, evicts the least-recently-used one: its batcher drains (guard
  sheds still apply during the drain), its engine is dropped, and the
  tenant is demoted to WARM (``store/tier.py``): its deserialized policy and
  its params on the card (``serve/engine.ResidentParams``, the mixed-date
  kernel's packed params included) are retained, so the next submit builds
  an engine with no kernel build and no host-to-device copy
  (``serve/tenant_evict``, ``serve/tenant_activate{tier}``).
- **quotas / backpressure** - ``max_pending`` per tenant bounds its
  in-flight requests (rows on the block lane); past it, submits are shed
  immediately with a structured :class:`~orp_tpu_torch.guard.Rejection`
  ``reason="quota"`` (``guard/shed{reason="quota", tenant=...}``).
- **SLO burn rate** - per-tenant served-latency objectives evaluated off
  the registry histograms the metrics facade publishes
  (``serve_request_latency_seconds{tenant=...}``): ``burn_rate =
  violation_fraction / error_budget``.
- **model health** (``obs/quality.py``) - a tenant whose bundle carries a
  baked training-feature sketch gets a per-tenant
  :class:`~orp_tpu_torch.obs.quality.DriftMonitor` fed once per admitted
  block. :meth:`ServeHost.reload_tenant` swaps a bundle behind a canary:
  bitwise probe rows by default, the QUANTITATIVE gate (``quality_band=``,
  the paired-RQMC hedge error on the pinned validation set) for a retrained
  policy or a precision tier; every verdict appends to the hash-linked
  promotions chain (``obs.chain_append``).

The canary's bitwise pin holds on the card because both engines evaluate the
same probe rows at the same bucket (the same launch shapes), the candidate
from the caller's thread, the incumbent from the same; the incumbent's
batcher keeps serving from its worker thread meanwhile.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings

import numpy as np

from orp_tpu_torch.guard import inject as _inject
from orp_tpu_torch.guard.serve import GuardPolicy, Rejection
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight
from orp_tpu_torch.obs import observe as obs_observe
from orp_tpu_torch.obs import state as obs_state
from orp_tpu_torch.obs.registry import Registry
from orp_tpu_torch.serve.batcher import MicroBatcher, SlimFuture
from orp_tpu_torch.serve.engine import HedgeEngine
from orp_tpu_torch.serve.metrics import LATENCY_HISTOGRAM, ServingMetrics
from orp_tpu_torch.store.tier import TierManager


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """A served-latency objective with an error budget.

    ``latency_slo_ms`` — the per-request latency objective (submit to
    resolved, device-complete — the ``ServingMetrics`` clock).
    ``error_budget``  — the tolerated fraction of requests over the
    objective (SRE convention: 0.01 = 99% of requests in SLO).
    """

    latency_slo_ms: float
    error_budget: float = 0.01

    def __post_init__(self):
        if self.latency_slo_ms <= 0:
            raise ValueError(
                f"latency_slo_ms={self.latency_slo_ms} must be > 0")
        if not 0.0 < self.error_budget <= 1.0:
            raise ValueError(
                f"error_budget={self.error_budget} must be in (0, 1]")


def burn_rate(histogram, slo: SloPolicy) -> float:
    """Error-budget consumption ratio of a latency histogram (seconds)
    against ``slo``: observed violation fraction / budget. 1.0 = burning
    exactly at budget; > 1 = the objective will be missed over the window."""
    return histogram.fraction_over(slo.latency_slo_ms / 1e3) / slo.error_budget


class CanaryRejected(RuntimeError):
    """A hot bundle reload failed its canary gate: the candidate engine did
    not reproduce the serving tenant's pinned probe rows, went non-finite,
    or regressed past the hedge-error quality band on the pinned validation
    set. The tenant was NOT touched — it keeps serving the old bundle's
    bits; the reject is the rollback."""


#: tenants already warned about a finiteness-only promotion path
#: (``require_same_bits=False`` with no ``quality_band``) — warn ONCE per
#: tenant per process; the ``guard/canary_unguarded`` counter fires every
#: time
_UNGUARDED_WARNED: set = set()


class _Tenant:
    """One hosted policy: retained source + (while live) engine/batcher."""

    __slots__ = ("name", "source", "policy", "max_pending", "slo",
                 "engine", "batcher", "metrics", "pending", "activations",
                 "last_used", "build_lock", "in_submit", "version",
                 "drift", "drift_band", "warm", "resident", "precision")

    def __init__(self, name, source, policy, max_pending, slo, drift_band,
                 precision=None):
        self.name = name
        self.source = source          # bundle dir (str/Path) or policy object
        self.warm = None              # warm tier: the DESERIALIZED policy,
        # retained across evictions (tier.py bounds how many tenants keep it)
        self.resident = None          # ... and its params on the card
        # (serve/engine.ResidentParams), reused by the next engine build
        self.policy = policy
        self.max_pending = max_pending
        self.slo = slo
        self.engine = None
        self.batcher = None
        self.metrics = None
        self.pending = 0              # futures submitted and not yet resolved
        self.activations = 0
        self.last_used = 0.0
        self.in_submit = 0            # submits between claim and enqueue —
        # eviction never unlinks a tenant mid-submit (host-lock guarded)
        self.version = 1              # bumped by every canary-passed reload
        # model-health drift monitor (obs/quality.py), built at first
        # activation when the policy carries a baked feature sketch; like
        # metrics it SURVIVES eviction — the sketch describes the tenant's
        # traffic, not one engine incarnation
        self.drift = None
        self.drift_band = drift_band
        # serving precision tier (serve/precision.py): None = the host
        # engine_kwargs' default (f32). Survives eviction — a tenant
        # promoted to bf16 through the quality band re-activates at bf16
        self.precision = precision
        # serializes THIS tenant's engine build without the host lock: a
        # cold start (bundle load + engine construction + the params' copy
        # to the card) must never head-of-line-block other tenants' submits
        self.build_lock = threading.Lock()


class ServeHost:
    """Serve many policies from one process under an engine-memory cap.

    ``max_live_engines`` — LRU cap on simultaneously-live engines and
    batchers (a worker thread each).
    ``registry``         — metrics registry the per-tenant ``ServingMetrics``
    façades intern into (labelled ``tenant=<name>``); defaults to the
    active obs session's registry, else a private one. ``slo_report``
    reads the same histograms back — one spine, no side bookkeeping.
    ``engine_kwargs`` / ``batcher_kwargs`` apply to every tenant's engine /
    batcher (per-tenant overrides via ``add_tenant``).
    """

    def __init__(self, *, max_live_engines: int = 4,
                 registry: Registry | None = None,
                 engine_kwargs: dict | None = None,
                 batcher_kwargs: dict | None = None,
                 promotion_chain=None,
                 tiers: TierManager | None = None):
        if max_live_engines < 1:
            raise ValueError(
                f"max_live_engines={max_live_engines} must be >= 1")
        self.max_live_engines = int(max_live_engines)
        # hot/warm/cold tier bookkeeping (store/tier.py): eviction demotes
        # hot->warm (the deserialized policy and its device params are
        # retained for a copy-free rebuild) instead of dropping everything;
        # pass a configured TierManager to bound warm retention differently
        self.tiers = tiers if tiers is not None else TierManager()
        # the promotions manifest chain (obs/manifest.py) reload_tenant
        # appends its verdicts to; None = resolve per reload from the active
        # telemetry session's export dir (still None -> no chain, verdicts
        # observable via counters/flight only)
        self.promotion_chain = promotion_chain
        st = obs_state()
        self.registry = (registry if registry is not None
                         else st.registry if st is not None else Registry())
        self.engine_kwargs = dict(engine_kwargs or {})
        self.batcher_kwargs = dict(batcher_kwargs or {})
        self._lock = threading.RLock()
        # rides the host lock: reload's atomic swap waits on it for a
        # tenant's in-flight submit claims to clear (notified by submit's
        # release path when a tenant's count hits zero)
        self._swap_cv = threading.Condition(self._lock)
        # pending counts live under their OWN lock: future done-callbacks
        # fire on the batcher worker thread, and an eviction drains that
        # worker while holding the host lock — a callback that needed the
        # host lock would stall the very drain waiting on it
        self._pending_lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        self._closed = False

    # -- tenant lifecycle ----------------------------------------------------

    def add_tenant(self, name: str, source, *,
                   policy: GuardPolicy | None = None,
                   max_pending: int | None = None,
                   slo: SloPolicy | None = None,
                   drift_band: float | None = None,
                   precision: str | None = None) -> None:
        """Register a tenant. ``source`` is a bundle directory (loaded
        lazily on first use, reloaded after an eviction) or an in-memory
        policy (``PolicyBundle`` / trained ``PipelineResult`` — retained,
        only the engine is rebuilt). Registration is cheap: no engine is
        built until the first submit. ``drift_band`` overrides the default
        feature-drift trip band (``obs.quality.DEFAULT_DRIFT_BAND``) for a
        policy whose bundle bakes a feature sketch; monitoring is skipped
        entirely for policies without one. ``precision`` pins the tenant's
        serving tier (serve/precision.py; None = the engine default, f32)
        — registering a tenant straight onto a non-f32 tier is the
        operator's call; the guarded route is registering at f32 and
        promoting through ``reload_tenant``'s quality band."""
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be >= 1")
        if drift_band is not None and drift_band <= 0:
            raise ValueError(f"drift_band={drift_band} must be > 0")
        with self._lock:
            if self._closed:
                raise RuntimeError("ServeHost is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = _Tenant(name, source, policy, max_pending,
                                          slo, drift_band, precision)

    def prefetch(self, names) -> list:
        """Predictively warm tenants WITHOUT building engines: each cold
        path/store source is resolved into its deserialized policy and
        retained on the warm tier, so the tenant's first request pays an
        engine build (a warm activation), not a cold directory load.
        Already-live and already-warm tenants are skipped; unknown names
        are ignored (the routing table may know tenants this host was
        never given). The fleet's routing-assignment hook
        (``orp_tpu_torch.store.tier.prefetch_assigned``) drives this; it is also
        directly callable with an expected working set. Returns the names
        actually warmed."""
        warmed = []
        for name in names:
            with self._lock:
                if self._closed:
                    break
                t = self._tenants.get(name)
                if t is None or t.batcher is not None or t.warm is not None:
                    continue
            with t.build_lock:
                with self._lock:
                    if t.batcher is not None or t.warm is not None:
                        continue
                source = t.source
                if (isinstance(source, (str, bytes))
                        or hasattr(source, "__fspath__")):
                    from orp_tpu_torch.serve.bundle import load_bundle

                    source = load_bundle(source)
                resident = self._resident_for(t, source)
                with self._lock:
                    if t.batcher is not None:
                        continue  # an activation won the race; already hot
                    t.warm = source
                    t.resident = resident
                for cold_name in self.tiers.note_warm(name):
                    with self._lock:
                        other = self._tenants.get(cold_name)
                        if other is not None and other.engine is None:
                            other.warm = other.resident = None
                obs_count("store/prefetch", tenant=name)
            warmed.append(name)
        return warmed

    def _resident_for(self, t, policy):
        """The tenant's params on its engine device at its tier, as an engine
        built now would hold them (a prefetch's warm retention)."""
        from orp_tpu_torch.serve.engine import ResidentParams
        from orp_tpu_torch.serve.precision import normalize_precision
        from orp_tpu_torch.utils.device import resolve_device

        kw = self._engine_kwargs_for(t)
        tier = normalize_precision(kw.get("precision", "f32")).tier
        return ResidentParams(policy.backward, policy.model, tier,
                              resolve_device(kw.get("device")))

    def _engine_kwargs_for(self, t) -> dict:
        """Host-wide engine kwargs plus the tenant's pinned serving tier
        (``serve/precision.py``). ``t.precision is None`` means the host
        default — usually f32 — so the dict is returned untouched and an
        old-style host behaves bit-for-bit as before."""
        if t.precision is None:
            return self.engine_kwargs
        return {**self.engine_kwargs, "precision": t.precision}

    def _activate(self, name: str):
        """Touch ``name`` in the LRU, building its engine/batcher if cold.
        Returns ``(tenant, batcher, evicted_batchers)``. Called WITHOUT the
        host lock held: the build (bundle load + engine construction + the
        params' copy to the card) runs under
        the tenant's OWN lock so other tenants' submits never queue behind
        one tenant's cold start. Over-cap victims are UNLINKED under the
        host lock but their batchers are returned for the caller to drain
        outside every lock (a drain runs client done-callbacks, and a
        callback may re-enter the host)."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            t.last_used = time.perf_counter()
            if t.batcher is not None:
                # sweep HERE too, not only after a build: a build-time
                # sweep that found every candidate mid-submit would
                # otherwise leave the cap exceeded forever
                return t, t.batcher, self._sweep_locked(t)
        evicted = []
        with t.build_lock:
            with self._lock:
                batcher = t.batcher
            if batcher is None:
                t_build = time.perf_counter()
                # tier ladder: a retained deserialized policy (warm) skips
                # the directory load entirely, and its retained device
                # params skip the copy to the card: a warm re-activation
                # builds no kernel and copies no params.
                # An in-memory source (PolicyBundle passed to add_tenant)
                # is warm by construction; only a path source without a
                # retained policy pays the cold load. Snapshot under the
                # host lock: _unlink clears other tenants' warm refs under
                # it, and build_lock alone does not exclude that writer.
                with self._lock:
                    source = t.warm
                    resident = t.resident
                tier = "warm"
                if source is None:
                    source = t.source
                    if (isinstance(source, (str, bytes))
                            or hasattr(source, "__fspath__")):
                        from orp_tpu_torch.serve.bundle import load_bundle

                        tier = "cold"
                        source = load_bundle(source)
                engine = HedgeEngine(source, resident=resident,
                                     **self._engine_kwargs_for(t))
                metrics = ServingMetrics(registry=self.registry,
                                         labels={"tenant": t.name})
                drift = t.drift
                if drift is None:
                    drift = self._build_drift(t, source)
                batcher = MicroBatcher(engine, metrics=metrics,
                                       policy=t.policy, **self.batcher_kwargs)
                with self._lock:
                    if self._closed:
                        # a close() raced the build: never install a live
                        # worker on a closed host
                        batcher.close()
                        raise RuntimeError("ServeHost is closed")
                    t.engine = engine
                    t.metrics = metrics
                    t.drift = drift
                    t.batcher = batcher
                    t.warm = source
                    t.resident = engine.resident
                    t.activations += 1
                    evicted = self._sweep_locked(t)
                self.tiers.note_hot(t.name)
                obs_count("serve/tenant_activate", tenant=t.name, tier=tier)
                obs_observe("serve/activation_seconds",
                            time.perf_counter() - t_build, tier=tier)
        return t, batcher, evicted

    def _build_drift(self, t: _Tenant, policy):
        """The one definition of a tenant's drift monitor: built from the
        policy's baked feature sketch (None without one — monitoring is
        skipped, never faked), banded by the tenant's ``drift_band``
        override, publishing into the host registry the scrape plane
        serves. Shared by cold activation and hot reload so the two paths
        can never configure monitors differently."""
        sketch = getattr(policy, "feature_sketch", None)
        if sketch is None:
            return None
        from orp_tpu_torch.obs.quality import DEFAULT_DRIFT_BAND, DriftMonitor

        return DriftMonitor(
            sketch,
            band=(t.drift_band if t.drift_band is not None
                  else DEFAULT_DRIFT_BAND),
            registry=self.registry, tenant=t.name)

    def _sweep_locked(self, current: _Tenant) -> list:
        """Unlink LRU tenants until the live-engine count is back at the
        cap; returns their batchers for an out-of-lock drain. Caller holds
        the host lock. Never unlinks ``current`` or a tenant mid-submit
        (an in-flight claim would enqueue on the closed batcher) — if
        every candidate is busy the cap is exceeded transiently (a soft
        cap beats a raced RuntimeError) and the next activation sweeps
        again."""
        evicted = []
        live = [x for x in self._tenants.values() if x.batcher is not None]
        while len(live) > self.max_live_engines:
            idle = [x for x in live if x is not current and x.in_submit == 0]
            if not idle:
                break
            victim = min(idle, key=lambda x: x.last_used)
            evicted.append(self._unlink(victim))
            live.remove(victim)
        return evicted

    def _unlink(self, t: _Tenant):
        """Detach ``t``'s serving state under the host lock (new submits
        now rebuild) and hand its batcher back for an out-of-lock drain:
        the queue finishes with guard sheds still applying — a deadline
        that expires during the drain is still a structured Rejection —
        then the engine is released (its policy and device params stay warm).
        The tenant stays registered."""
        batcher = t.batcher
        t.batcher = None
        t.engine = None
        # t.metrics stays: the façade interns shared-registry series, so a
        # reactivation accumulates into the same instruments and stats()
        # keeps reporting what an evicted tenant served
        # hot -> WARM, not cold: t.warm keeps the deserialized policy and
        # t.resident its device params, so re-activation is an engine
        # rebuild with no copy, not a directory re-read. Past the tier
        # manager's warm cap the
        # longest-idle warm tenants genuinely go cold — their retained
        # policies are released here
        if t.warm is not None:
            for cold_name in self.tiers.note_warm(t.name):
                other = self._tenants.get(cold_name)
                if other is not None and other.engine is None:
                    other.warm = other.resident = None
        else:
            self.tiers.note_cold(t.name)
        obs_count("serve/tenant_evict", tenant=t.name,
                  tier=self.tiers.tier_of(t.name))
        return batcher

    # -- request path --------------------------------------------------------

    def _claim_batcher(self, name: str):
        """Activate ``name`` and CLAIM its live batcher: ``(tenant,
        batcher)`` with ``in_submit`` already incremented (the token that
        makes the batcher un-evictable); the caller MUST release via
        :meth:`_release_claim` once its enqueue is done.

        Claim loop: between activation and the claim a concurrent
        activation may LRU-evict this tenant (its batcher closes); a failed
        claim just re-activates. Bounded: a freshly-activated tenant loses
        the race only to an eviction that slipped between the two locks.
        Evicted victims drain HERE, outside every lock (the drain resolves
        futures, and a done-callback may re-enter the host)."""
        for _ in range(16):
            with self._lock:
                if self._closed:
                    raise RuntimeError("ServeHost is closed")
            t, batcher, evicted = self._activate(name)
            with self._lock:
                claimed = t.batcher is batcher and batcher is not None
                if claimed:
                    t.in_submit += 1
            for victim in evicted:
                victim.close()
            if claimed:
                return t, batcher
        # pragma: no cover - needs pathological eviction churn
        raise RuntimeError(
            f"tenant {name!r}: could not claim a live batcher "
            "(eviction churn; raise max_live_engines)")

    def _release_claim(self, t: _Tenant) -> None:
        with self._lock:
            t.in_submit -= 1
            if t.in_submit == 0:
                # a reload swap may be parked on this count (notify on
                # the shared host lock: nanoseconds with no waiters)
                self._swap_cv.notify_all()

    def submit(self, tenant: str, date_idx: int, states, prices=None, *,
               deadline_s: float | None = None):
        """Route one request to ``tenant``'s batcher; returns its future
        (``(phi, psi, value)``, or a :class:`Rejection` — the tenant's own
        guard sheds plus the host's ``reason="quota"``)."""
        t, batcher = self._claim_batcher(tenant)
        try:
            with self._pending_lock:
                over = (t.max_pending is not None
                        and t.pending >= t.max_pending)
                if not over:
                    t.pending += 1
            if over:
                # over quota: shed NOW, at zero queue age — the point of a
                # quota is that the request never consumes batcher capacity
                obs_count("guard/shed", reason="quota", tenant=t.name)
                fut = SlimFuture()
                fut.set_result(Rejection(reason="quota", queued_s=0.0,
                                         deadline_s=deadline_s))
                return fut
            try:
                fut = batcher.submit(date_idx, states, prices,
                                     deadline_s=deadline_s)
            except BaseException:
                self._request_done(t)  # the slot was reserved, never used
                raise
            fut.add_done_callback(lambda _f, _t=t: self._request_done(_t))
            return fut
        finally:
            self._release_claim(t)

    def submit_block(self, tenant: str, date_idx: int, states, prices=None,
                     deadlines=None, *, trace=None):
        """Columnar ingest lane through the host: one
        :meth:`~orp_tpu_torch.serve.batcher.MicroBatcher.submit_block` per block,
        ONE future, quota counted in ROWS against the tenant's
        ``max_pending`` budget. Rows past the remaining budget are shed as
        a TAIL SLICE — status :data:`~orp_tpu_torch.serve.ingest.SHED_QUOTA` in
        the returned :class:`~orp_tpu_torch.serve.ingest.BlockResult`, zero queue
        age, never a per-row ``Rejection`` — and only the head rows consume
        batcher capacity. (The per-request lane counts the same budget in
        requests; a mixed tenant's ``pending`` is requests + block rows.)
        ``trace`` is the optional distributed-trace context, passed through
        to the batcher untouched (a quota-split block's admitted head
        carries it; the merged result keeps its server timing)."""
        from orp_tpu_torch.serve.ingest import (SHED_QUOTA, all_shed_result,
                                          merge_tail_shed)

        feats = np.atleast_2d(np.ascontiguousarray(states))
        n = feats.shape[0]
        pr = (np.atleast_2d(np.ascontiguousarray(prices))
              if prices is not None else None)
        t, batcher = self._claim_batcher(tenant)
        try:
            with self._pending_lock:
                keep = (n if t.max_pending is None
                        else max(0, min(n, t.max_pending - t.pending)))
                t.pending += keep
            n_quota = n - keep
            if n_quota:
                obs_count("guard/shed", n_quota, reason="quota",
                          tenant=t.name, lane="block")
            if keep and t.drift is not None:
                # model-health sketch: ONE vectorized fold of the admitted
                # head per block (never per row). FAIL-OPEN: a
                # monitor error must never break the submit path (the
                # pending quota above is already reserved, and serving
                # outranks observing)
                try:
                    t.drift.update(feats[:keep])
                except Exception:  # counted: monitoring is advisory, never takes down the ingest lane
                    obs_count("quality/drift_monitor_error", tenant=t.name)
            if keep == 0:
                fut = SlimFuture()
                fut.set_result(all_shed_result(
                    n, SHED_QUOTA, has_value=pr is not None,
                    dtype=feats.dtype if feats.dtype.kind == "f"
                    else np.float32))
                return fut
            dl = deadlines
            if dl is not None and np.ndim(dl) == 1:
                dl = np.asarray(dl)[:keep]  # the admitted head's budgets
            try:
                inner = batcher.submit_block(
                    date_idx, feats[:keep],
                    None if pr is None else pr[:keep], dl, trace=trace)
            except BaseException:
                self._rows_done(t, keep)  # reserved rows, never enqueued
                raise
            if n_quota == 0:
                inner.add_done_callback(
                    lambda _f, _t=t, _k=keep: self._rows_done(_t, _k))
                return inner
            # partial admission: the caller's future must still describe
            # ALL n rows — append the quota-shed tail to the head's result
            outer = SlimFuture()

            def _forward(f, _t=t, _k=keep, _tail=n_quota):
                self._rows_done(_t, _k)
                exc = f.exception()
                if exc is not None:
                    outer.set_exception(exc)
                else:
                    outer.set_result(
                        merge_tail_shed(f.result(), _tail, SHED_QUOTA))

            inner.add_done_callback(_forward)
            return outer
        finally:
            self._release_claim(t)

    def _request_done(self, t: _Tenant) -> None:
        with self._pending_lock:
            t.pending -= 1

    def _rows_done(self, t: _Tenant, k: int) -> None:
        with self._pending_lock:
            t.pending -= k

    # -- hot reload ----------------------------------------------------------

    def reload_tenant(self, name: str, source=None, *, canary_rows: int = 8,
                      require_same_bits: bool = True,
                      quality_band: float | None = None,
                      validation=None,
                      precision: str | None = None) -> dict:
        """Versioned hot bundle swap with a canary gate; the tenant never
        stops serving.

        ``source`` — the candidate bundle dir / in-memory policy (None =
        reload the tenant's CURRENT source: the artifact-refresh shape,
        e.g. a re-export). The candidate engine is
        built OFF-TRAFFIC and must reproduce the serving engine's pinned
        probe rows — ``canary_rows`` deterministic feature rows at the
        first and last rebalance dates, BITWISE (the serve forward is
        deterministic per policy, so any flipped bit is a wrong candidate:
        corrupted params, foreign bundle, broken artifact) — before it
        takes traffic. A candidate that fails raises
        :class:`CanaryRejected` and emits ``guard/canary_reject``; the
        tenant keeps serving the old bundle's bits untouched (the reject IS
        the rollback — nothing was swapped).

        ``require_same_bits=False`` relaxes the bitwise pin — the knob for
        rolling a genuinely RETRAINED policy, where different bits are the
        point. Alone it leaves only the finiteness check, which accepts ANY
        finite policy however wrong its hedges — so doing it without a
        ``quality_band`` warns once per tenant and emits
        ``guard/canary_unguarded`` (the silently-relaxed gate is now
        observable).

        ``quality_band`` — the QUANTITATIVE acceptance gate: candidate and
        incumbent each replay the pinned validation scenario set
        (``validation=`` or the candidate bundle's baked
        ``ValidationSpec``) OFF-TRAFFIC through
        :func:`orp_tpu.obs.quality.evaluate_quality` — same scrambles for
        both, so the comparison is paired and Monte-Carlo noise cancels —
        and a candidate whose aggregate hedge error regresses more than
        ``quality_band`` (relative: 0.05 = +5%) is rejected
        (``guard/canary_reject{stage="quality"}``) with the incumbent's
        bits untouched. This is the gate a retrained policy must pass:
        different bits allowed, worse hedging not.

        Every verdict — promote and reject — appends to the promotions
        manifest chain (``obs.chain_append``; ``promotion_chain`` ctor arg,
        else the active telemetry session's bundle dir), so the serving
        history is an auditable hash-linked ledger.

        ``precision`` — promote the tenant to a serving tier
        (``serve/precision.py``: "f32" | "bf16" | "int8"; None = keep the
        tenant's current tier). A tier change produces DIFFERENT bits by
        construction, so it is refused under ``require_same_bits=True``:
        the supported route is ``require_same_bits=False`` with a
        ``quality_band``, which replays the pinned validation set on the
        f32-equivalent INCUMBENT versus the reduced-precision candidate —
        paired scrambles, so the measured regression is the tier's
        quantisation error, not Monte-Carlo noise. On promotion the tier
        is pinned on the tenant and survives eviction/re-activation.

        On a pass: the new batcher is installed atomically (the swap waits
        for in-flight submit claims, so no request lands on a dead
        batcher), the old one drains OUTSIDE every lock — queued requests
        still resolve through the old engine, shed policies still apply —
        and the tenant's version bumps (``serve/bundle_swap``).
        """
        if quality_band is not None and quality_band < 0:
            raise ValueError(f"quality_band={quality_band} must be >= 0 "
                             "(0 = no regression tolerated at all)")
        if validation is not None and quality_band is None:
            # the caller clearly wants the quality gate — dropping their
            # validation set silently and promoting on finiteness alone is
            # exactly the surprise this gate exists to remove
            raise ValueError(
                "validation= was passed without quality_band= — the "
                "validation set is only consumed by the quality gate; pass "
                "quality_band=<max relative hedge-error regression> to arm "
                "it")
        if precision is not None:
            from orp_tpu_torch.serve.precision import normalize_precision

            normalize_precision(precision)  # unknown tier: fail before work
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
        if not require_same_bits and quality_band is None:
            # the finiteness-only promotion path: legal (a retrain may have
            # no validation set yet) but no longer SILENT — the gate that
            # accepts any finite policy is itself an observable event
            obs_count("guard/canary_unguarded", tenant=name)
            flight.record("canary_unguarded", tenant=name)
            if name not in _UNGUARDED_WARNED:
                _UNGUARDED_WARNED.add(name)
                warnings.warn(
                    f"reload_tenant({name!r}, require_same_bits=False) "
                    "without a quality_band: the canary gate is relaxed to "
                    "FINITENESS ONLY — any finite candidate passes, however "
                    "wrong its hedge ratios. Pass quality_band= (the "
                    "hedge-error regression gate over the bundle's pinned "
                    "validation set) for retrained policies",
                    stacklevel=2,
                )
        # the OLD engine's bits are the canary pin: activate if cold, then
        # CLAIM the tenant (in_submit, the same token a submit holds) so a
        # concurrent activation's LRU sweep cannot evict it — and null
        # t.engine — between the activation and the probe evaluations.
        # Bounded like submit's claim loop: the only way to lose is an
        # eviction slipping between the two locks.
        for _ in range(16):
            t, batcher_live, evicted = self._activate(name)
            with self._lock:
                claimed = t.batcher is batcher_live and t.engine is not None
                if claimed:
                    t.in_submit += 1
                    old_engine = t.engine
            for victim in evicted:
                victim.close()  # outside every lock, as always
            if claimed:
                break
        else:  # pragma: no cover - needs pathological eviction churn
            raise RuntimeError(
                f"tenant {name!r}: could not pin a live engine for the "
                "canary (eviction churn; raise max_live_engines)")
        try:
            nf = old_engine.model.n_features
            # deterministic probe rows near the training normalisation;
            # first and last dates catch a torn per-date params axis at
            # both ends
            probe = (1.0 + 0.05 * np.random.default_rng(7)
                     .standard_normal((int(canary_rows), nf))
                     ).astype(np.float32)
            dates = sorted({0, old_engine.n_dates - 1})
            pinned = [old_engine.evaluate(d, probe) for d in dates]
        finally:
            # release BEFORE the candidate build + swap: the swap below
            # waits for in_submit to clear, and holding our own claim
            # across it would deadlock on ourselves
            with self._lock:
                t.in_submit -= 1
                if t.in_submit == 0:
                    self._swap_cv.notify_all()
        if (precision is not None and require_same_bits
                and precision != old_engine.precision.tier):
            raise ValueError(
                f"tenant {name!r}: precision={precision!r} changes the "
                f"serving tier (incumbent {old_engine.precision.tier!r}) — "
                "different bits by construction, so the bitwise canary can "
                "never pass. Promote tiers with require_same_bits=False and "
                "a quality_band (the paired hedge-error gate)")
        # load + build the candidate OUTSIDE every host lock (a reload must
        # never head-of-line-block serving)
        new_source = t.source if source is None else source
        policy = new_source
        if (isinstance(policy, (str, bytes))
                or hasattr(policy, "__fspath__")):
            from orp_tpu_torch.serve.bundle import load_bundle

            try:
                policy = load_bundle(policy)
            except (ValueError, OSError) as e:
                self._canary_reject(
                    name, f"candidate bundle failed to load ({e})",
                    stage="load", cause=e)
        quality = None
        spec = None
        if quality_band is not None:
            spec = validation if validation is not None else getattr(
                policy, "validation", None)
            if spec is None:
                raise ValueError(
                    f"tenant {name!r}: quality_band={quality_band} needs a "
                    "pinned validation set — pass validation="
                    "ValidationSpec(...) or re-export the candidate bundle "
                    "with the current code (`export_bundle` bakes one)")
        inj = _inject.active()
        if inj is not None:
            # chaos harness (guard/inject.py): bundle corruption mid-reload
            # — the bytes passed every on-disk digest, the in-memory object
            # is wrong; the canary below is the only gate left
            policy = inj.corrupt_policy(policy)
        cand_kwargs = self._engine_kwargs_for(t)
        if precision is not None:
            cand_kwargs = {**cand_kwargs, "precision": precision}
        with t.build_lock:  # the per-tenant build serializer; nothing drains or serves under it
            engine = HedgeEngine(policy, **cand_kwargs)
            for d, (pphi, ppsi, _pv) in zip(dates, pinned):
                phi, psi, _v = engine.evaluate(d, probe)
                if not (np.isfinite(phi).all() and np.isfinite(psi).all()):
                    self._canary_reject(name, f"non-finite outputs at date "
                                              f"{d}", stage="finiteness")
                if require_same_bits and not (
                        np.array_equal(phi, pphi)
                        and np.array_equal(psi, ppsi)):
                    self._canary_reject(
                        name, f"probe bits diverged at date {d} "
                              "(corrupted or foreign candidate)")
        if quality_band is not None:
            from orp_tpu_torch.obs.quality import evaluate_quality

            # OUTSIDE the build lock: the full RQMC replays take seconds,
            # and a concurrent cold re-activation of this tenant serializes
            # on build_lock — only engine construction belongs under it.
            # Both replays run AFTER the cheap gates (load, finiteness,
            # bits) so a candidate they already reject never bills the
            # expensive evaluation. The incumbent publishes its gauges into
            # the live registry (it IS the serving policy); the candidate's
            # go to a THROWAWAY registry — a possibly-rejected candidate's
            # numbers must never land in the live scrape as the tenant's
            # serving series (the chain/exception carry them for audit).
            # The spec usually comes from the CANDIDATE, so a retrain that
            # changed the rebalance grid or feature count fails at the
            # incumbent's evaluation — a failed promotion, recorded like
            # every other verdict
            try:
                inc_rec = evaluate_quality(engine=old_engine, spec=spec,
                                           registry=self.registry,
                                           tenant=name)
            except (ValueError, RuntimeError) as e:
                self._canary_reject(
                    name, "the candidate's pinned validation set does not "
                          f"fit the serving incumbent ({e})",
                    stage="quality", cause=e)
            try:
                cand_rec = evaluate_quality(engine=engine, spec=spec,
                                            registry=Registry())
            except (ValueError, RuntimeError) as e:
                # spec mismatch OR a runtime failure of the candidate's own
                # dispatch (the doctor probe catches the same pair): either
                # way a failed promotion, recorded like every other verdict
                self._canary_reject(
                    name, f"candidate cannot run the pinned validation set "
                          f"({e})", stage="quality", cause=e)
            inc_err = inc_rec["hedge_error"]["mean"]
            cand_err = cand_rec["hedge_error"]["mean"]
            regression = (cand_err - inc_err) / max(inc_err, 1e-12)
            quality = {
                "band": float(quality_band),
                "validation_fingerprint": spec.fingerprint(),
                "incumbent": inc_rec["hedge_error"],
                "candidate": cand_rec["hedge_error"],
                "regression": round(float(regression), 6),
            }
            if regression > quality_band:
                self._canary_reject(
                    name,
                    f"hedge-error regression {regression:+.2%} exceeds "
                    f"the quality band {quality_band:+.2%} (incumbent "
                    f"{inc_err:.6g} -> candidate {cand_err:.6g} ± "
                    f"{cand_rec['hedge_error']['ci95']:.2g} on the "
                    "pinned validation set)",
                    stage="quality", quality=quality)
        # snapshot the live metrics façade under the host lock — _activate
        # installs it under self._lock, and this code runs outside it
        with self._lock:
            metrics = t.metrics
        batcher = MicroBatcher(engine, metrics=metrics,
                               policy=t.policy, **self.batcher_kwargs)
        # a promoted candidate's baked sketch is the NEW drift baseline (a
        # retrain's training distribution is the reference its serving
        # traffic should be compared against); a sketch-less candidate
        # keeps the old monitor — stale beats blind
        new_drift = self._build_drift(t, policy)
        stalled = False
        evicted2: list = []
        with self._lock:
            if self._closed:
                closed = True
            else:
                closed = False
                # atomic swap: wait out in-flight submit claims so none
                # lands on the batcher being retired (bounded — a claim
                # spans two lock acquisitions, not a request lifetime)
                deadline = time.perf_counter() + 5.0
                while t.in_submit and time.perf_counter() < deadline:
                    self._swap_cv.wait(timeout=0.05)
                if t.in_submit:
                    # a claim outlived the whole wait (pathological stall):
                    # swapping anyway would retire a batcher that claim is
                    # about to enqueue on — refuse LOUDLY and keep serving
                    # the old bundle; the reload is retryable
                    stalled = True
                else:
                    old_batcher = t.batcher
                    t.batcher = batcher
                    t.engine = engine
                    t.source = new_source
                    t.resident = engine.resident
                    t.warm = policy  # the retained warm policy must track
                    # the swap — a later warm re-activation serves the NEW
                    # bundle's bits, never a stale pre-swap policy
                    if precision is not None:
                        # tier pin survives eviction: a warm re-activation
                        # rebuilds at the PROMOTED tier, not the default
                        t.precision = precision
                    if new_drift is not None:
                        t.drift = new_drift
                    t.version += 1
                    version = t.version
                    # the tenant may have been EVICTED between the canary
                    # and this swap — installing counts as an activation,
                    # so the cap sweep runs like one
                    evicted2 = self._sweep_locked(t)
        if closed or stalled:
            batcher.close()
            if closed:
                raise RuntimeError("ServeHost is closed")
            obs_count("guard/reload_stalled", tenant=name)
            raise RuntimeError(
                f"tenant {name!r}: an in-flight submit claim outlived the "
                "5s swap window; reload aborted (the tenant keeps serving "
                "the previous bundle — retry the reload)")
        obs_count("serve/bundle_swap", tenant=name)
        if quality is not None:
            # the live quality gauges must describe the SERVING policy:
            # re-publish the promoted candidate's record over the retired
            # incumbent's numbers
            from orp_tpu_torch.obs.quality import publish_quality

            publish_quality(cand_rec, self.registry, tenant=name)
        self._chain_verdict(name, action="promote", version=version,
                            require_same_bits=bool(require_same_bits),
                            source=str(new_source),
                            precision=engine.precision.tier,
                            **({"quality": quality} if quality else {}))
        for victim in (*evicted2, *(() if old_batcher is None
                                    else (old_batcher,))):
            # drain OUTSIDE every lock: the old queue resolves through the
            # old engine (guard sheds still apply), done-callbacks may
            # re-enter the host
            victim.close()
        out = {"tenant": name, "version": version, "swapped": True,
               "canary_rows": int(canary_rows), "canary_dates": dates,
               "require_same_bits": bool(require_same_bits),
               "precision": engine.precision.tier}
        if quality is not None:
            out["quality"] = quality
        return out

    def _chain_path(self):
        """Resolve where promotion verdicts chain to: the ctor arg, else the
        active telemetry session's bundle dir, else nowhere (None)."""
        if self.promotion_chain is not None:
            return self.promotion_chain
        st = obs_state()
        if st is not None and getattr(st, "export_dir", None) is not None:
            import pathlib

            from orp_tpu_torch.obs.manifest import CHAIN_FILE

            return pathlib.Path(st.export_dir) / CHAIN_FILE
        return None

    def _chain_verdict(self, name: str, **record) -> None:
        """Append one promotion verdict to the manifest chain (no-op when
        no chain is configured and no telemetry session exports). A chain
        WRITE failure must never change a reload's outcome — the promote
        path runs after the swap already took traffic, and a reject must
        surface as CanaryRejected, not as the audit log's OSError — so it
        degrades to a warning + counter instead of raising."""
        path = self._chain_path()
        if path is None:
            return
        from orp_tpu_torch.obs.manifest import chain_append

        try:
            chain_append(path, {"tenant": name, **record})
        except OSError as e:
            obs_count("quality/chain_error", tenant=name)
            warnings.warn(
                f"promotions chain {path}: append failed ({e}) — the "
                f"{record.get('action', 'verdict')} itself is unaffected, "
                "but the audit ledger is missing this entry",
                stacklevel=3,
            )

    def _canary_reject(self, name: str, why: str, *, stage: str = "bits",
                       quality: dict | None = None, cause=None):
        """The ONE reject path every canary stage (load, bits, finiteness,
        quality) routes through: counter + flight record + chain verdict +
        warning + ``CanaryRejected`` (chained from ``cause`` when the
        reject wraps an underlying exception)."""
        obs_count("guard/canary_reject", tenant=name, stage=stage)
        flight.record("canary_reject", tenant=name, stage=stage, why=why)
        self._chain_verdict(name, action="reject", stage=stage, why=why,
                            **({"quality": quality} if quality else {}))
        warnings.warn(
            f"hot reload of tenant {name!r} REJECTED by the canary gate "
            f"({why}); the tenant keeps serving the previous bundle",
            stacklevel=3,
        )
        raise CanaryRejected(
            f"tenant {name!r}: {why}; serving is untouched") from cause

    def evaluate(self, tenant: str, date_idx: int, states, prices=None):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(tenant, date_idx, states, prices).result()

    # -- introspection -------------------------------------------------------

    def tenant_source(self, name: str):
        """The tenant's CURRENT bundle source (directory path or in-memory
        policy) — what a control plane warm-starts a retrain from
        (the pilot plane). Tracks promotions: after ``reload_tenant``
        this is the promoted candidate's source."""
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            return self._tenants[name].source

    def stats(self) -> dict:
        """Per-tenant serving state: live/pending/activations plus the
        metrics summary of everything served so far."""
        with self._lock:
            # pending counters are _pending_lock state (the submit path
            # updates them without the host lock): snapshot them under
            # their own lock so a mid-increment read cannot tear.
            # Canonical order: _lock -> _pending_lock (ARCHITECTURE.md).
            with self._pending_lock:
                pending = {t.name: t.pending
                           for t in self._tenants.values()}
            return {
                t.name: {
                    "live": t.engine is not None,
                    "tier": self.tiers.tier_of(t.name),
                    "pending": pending[t.name],
                    "activations": t.activations,
                    "max_pending": t.max_pending,
                    "version": t.version,
                    **({"summary": t.metrics.summary()}
                       if t.metrics is not None else {}),
                    **({"drift": t.drift.scores()}
                       if t.drift is not None else {}),
                }
                for t in self._tenants.values()
            }

    def slo_report(self, default: SloPolicy | None = None) -> dict:
        """Per-tenant SLO burn rates off the registry latency histograms
        (``serve_request_latency_seconds{tenant=...}``). A tenant uses its
        own ``slo`` from ``add_tenant``, else ``default``; tenants with
        neither are skipped. ``burning`` flags rates > 1 — the budget is
        being consumed faster than it accrues."""
        out = {}
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            slo = t.slo if t.slo is not None else default
            if slo is None:
                continue
            # an operator read path: interns an existing per-tenant series
            hist = self.registry.histogram(LATENCY_HISTOGRAM,  # orp: noqa[ORP015] -- slo_report is an operator read path: this interns an EXISTING per-tenant series (a dict lookup), not hot-path churn
                                           {"tenant": t.name})
            rate = burn_rate(hist, slo)
            out[t.name] = {
                "latency_slo_ms": slo.latency_slo_ms,
                "error_budget": slo.error_budget,
                "violation_fraction": round(
                    hist.fraction_over(slo.latency_slo_ms / 1e3), 6),
                "burn_rate": round(rate, 4),
                "burning": rate > 1.0,
                # the same bounded window the fraction is computed over —
                # NOT the lifetime count (hist.count): the pair must
                # describe one window or violation estimates built from
                # them are fiction
                "window_requests": int(hist.snapshot().size),
                "lifetime_requests": int(hist.count),
            }
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drain every live tenant's batcher and release all engines."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = [t.batcher for t in self._tenants.values()
                        if t.batcher is not None]
            for t in self._tenants.values():
                t.batcher = None
                t.engine = None
        for b in batchers:
            # outside the lock: the drain runs client done-callbacks
            b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
