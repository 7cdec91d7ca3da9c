"""Serving health, first part: the stuck-dispatch watchdog (counterpart of
``orp_tpu/serve/health.py``'s :class:`DispatchWatchdog`).

Every handled serve fault raises (transient dispatch errors, injected
faults). A wedged launch raises nothing: the result copy simply never
returns, the resolve stage stops resolving, and every queued request ages out
behind it. :class:`DispatchWatchdog` bounds the wait: a batch that exceeds
``GuardPolicy.hard_wall_ms`` is FORCE-FAILED with
:class:`~orp_tpu_torch.guard.WatchdogTrip` (``guard/watchdog_trip``), the
trip feeds the engine's circuit breaker (``HedgeEngine.watchdog_trip``), and
the batcher's bounded block-time retry re-dispatches the rows. The waiter
thread that was blocked is ABANDONED: a CUDA launch cannot be cancelled, so
"force-fail" honestly means "stop waiting, leak the waiter", which is also why
the watchdog is opt-in.

Second part: :func:`doctor_report`, the one-shot self-check (the JAX
package's ``orp doctor``), with its fleet battery :func:`_fleet_checks` —
the same check names, order and flag-speak, each reading the port's own
source (the function's docstring lists which).
"""

from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as _FutureTimeoutError

from orp_tpu_torch.guard.serve import WatchdogTrip
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight


class _BlockWorker:
    """One daemon thread running blocking reads on the watchdog's behalf.

    The resolve stage hands it ``fn`` (a device block) and waits on the
    returned future with the hard-wall timeout; an abandoned worker (its
    current ``fn`` hung) finishes or leaks with the hang — either way it
    never touches a live watchdog again."""

    __slots__ = ("_q", "thread", "dead")

    def __init__(self):
        import queue

        self._q = queue.SimpleQueue()
        self.dead = False
        self.thread = threading.Thread(
            target=self._run, name="orp-serve-watchdog", daemon=True)
        self.thread.start()

    def submit(self, fn):
        from orp_tpu_torch.serve.batcher import SlimFuture

        fut = SlimFuture()
        self._q.put((fn, fut))
        return fut

    def abandon(self):
        self.dead = True
        self._q.put(None)  # wakes an idle worker; a hung one exits on return

    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self.dead:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — delivered through the future
                fut.set_exception(e)
            if self.dead:
                return


class DispatchWatchdog:
    """Bound the resolve-stage block on an in-flight batch by a hard wall.

    ``block(fn, tag)`` runs ``fn()`` (the pending batch's blocking result
    read) on a helper thread and waits at most ``hard_wall_ms``. Inside the
    wall it is transparent — the result or exception propagates unchanged,
    and ``on_ok(tag)`` resets any hang streak. Past the wall it force-fails:
    emits ``guard/watchdog_trip``, feeds ``on_trip(tag)`` (the engine's
    circuit-breaker hook, ``HedgeEngine.watchdog_trip``), abandons the stuck
    helper and
    raises :class:`WatchdogTrip` (a ``TransientDispatchError``: the
    batcher's block-time retry policy applies).

    One watchdog serves one batcher — the resolve stage is sequential, so
    a single helper thread is enough until a trip orphans it.
    """

    def __init__(self, hard_wall_ms: float, *, on_trip=None, on_ok=None):
        if hard_wall_ms <= 0:
            raise ValueError(f"hard_wall_ms={hard_wall_ms} must be > 0")
        self.hard_wall_s = float(hard_wall_ms) / 1e3
        self.on_trip = on_trip
        self.on_ok = on_ok
        self.trips = 0
        self._lock = threading.Lock()
        self._worker: _BlockWorker | None = None

    def block(self, fn, tag=None):
        with self._lock:
            w = self._worker
            if w is None or w.dead:
                w = _BlockWorker()
                self._worker = w
        fut = w.submit(fn)
        try:
            out = fut.result(timeout=self.hard_wall_s)
        except _FutureTimeoutError:
            with self._lock:
                self.trips += 1
                if self._worker is w:
                    self._worker = None
            w.abandon()
            obs_count("guard/watchdog_trip", key=str(tag))
            flight.record("watchdog_trip", tag=str(tag),
                          hard_wall_ms=self.hard_wall_s * 1e3,
                          trips=self.trips)
            if self.on_trip is not None:
                self.on_trip(tag)
            raise WatchdogTrip(
                f"in-flight batch (tag={tag}) exceeded the "
                f"{self.hard_wall_s * 1e3:.0f}ms dispatch hard wall; "
                "force-failed (the stuck waiter is abandoned)"
            ) from None
        if self.on_ok is not None:
            self.on_ok(tag)
        return out

    def close(self):
        with self._lock:
            w, self._worker = self._worker, None
        if w is not None:
            w.abandon()


# -- doctor_report (the JAX package's ``orp doctor``) -----------------------


def _check(checks: list, name: str, ok: bool, detail: str,
           fix: str | None = None) -> bool:
    checks.append({"check": name, "ok": bool(ok), "detail": detail,
                   **({"fix": fix} if fix and not ok else {})})
    return bool(ok)


def _dir_writable(d) -> tuple[bool, str]:
    import os
    import pathlib
    import tempfile

    p = pathlib.Path(d)
    try:
        p.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=p, prefix=".orp_doctor_") as f:
            f.write(b"ok")
        return True, f"{p} is writable"
    except OSError as e:
        return False, f"{p}: {os.strerror(e.errno) if e.errno else e}"


def doctor_report(bundle_dir=None, *, mesh=None, cache_dir=None,
                  telemetry_dir=None, gateway=None, metrics=None,
                  quality=None, perf=None, fleet=None, store=None,
                  pilot=None, gateway_timeout_s: float = 5.0,
                  device=None) -> dict:
    """One-shot environment/bundle self-check — the first thing to run on a
    broken pod. Returns ``{"ok": bool, "checks": [...]}`` where each check
    row carries ``check``/``ok``/``detail`` and, on failure, a ``fix`` in
    flag-speak (the CLI flag or command that repairs it).

    The check names, their order and their flag-speak are the JAX
    package's; the checks that read JAX there read the port's sources here:
    ``devices`` (``torch.cuda`` and ``topology_fingerprint``),
    ``compile_cache`` (the kernel-build cache, ``aot.cache``), ``bundle_aot``
    (``aot.bundle_exec.aot_status``), ``perf_profiler`` (``torch.profiler``),
    ``perf_peaks`` (``obs.perf.PEAK_TABLE`` against
    ``torch.cuda.get_device_name()``), ``pilot_*`` (the port's journal) and
    ``lint_concurrency`` (the port's analyzer over ``orp_tpu_torch/``).

    ``bundle_dir``  — optionally verify a policy bundle: format/fingerprint/
    policy-step digest (a full ``load_bundle``) plus its AOT topology
    coverage for THIS process's topology (``mesh`` — None = single device).
    ``cache_dir``   — kernel-build cache dir to probe (default: the
    ``enable_persistent_cache`` resolution: env ``ORP_TORCH_CACHE_DIR``,
    else the repo's ``build/orp_tpu_torch``).
    ``telemetry_dir`` — optionally probe the obs sink target for
    ``--telemetry DIR`` runs.
    ``gateway``     — optionally probe a running ingest gateway
    (``"host:port"``): one TCP connect + ``orp-ingest`` PING/PONG round
    trip, the liveness check for a ``orp serve-gateway`` front.
    ``metrics``     — optionally probe the LIVE scrape of a gateway
    (``"host:port"``, the METRICS wire kind): the exposition must parse
    and carry the core serve series (request/latency, queue age, sheds) —
    a gateway that serves traffic but cannot be observed is a failing
    check, fixed in flag-speak.
    ``quality``     — optionally probe a bundle's MODEL-HEALTH plumbing
    (``orp doctor --quality DIR``): the bundle must carry the baked
    per-feature baseline sketch + pinned validation-set fingerprint
    (``orp export`` bakes both), and a shrunken hedge-quality estimate
    (``obs.quality.evaluate_quality``) must produce a parseable
    ``orp-quality-v1`` record with a nonzero RQMC confidence interval —
    the preflight for serve-time drift monitoring and the
    ``reload_tenant(quality_band=...)`` canary gate.
    ``perf``        — optionally probe the PERFORMANCE-observatory
    plumbing (``orp doctor --perf [LEDGER]``): ``torch.profiler`` importable
    with a writable trace-dir target (the ``orp profile --trace-dir``
    preflight), the ``orp-perf-v1`` ledger parseable AND appendable (a
    torn tail is tolerated, anything else is corruption), and the roofline
    peak table covering THIS process's ``device_kind`` — an uncovered kind
    still rooflines against the measured-matmul fallback, but the check
    says so in flag-speak because a fabricated-feeling fraction-of-peak is
    exactly what an operator should not discover mid-incident.
    ``fleet``        — probe a whole serve fleet from its ``topology.json``
    (``orp doctor --fleet topology.json``): PING every replica and every
    fleet gateway, read each gateway's routing view (the HEALTH wire
    kind's ``routing`` section — version, healthy set, per-replica health
    age, tenant-sample mapping) and verify ROUTING AGREEMENT: every
    gateway must map the same tenant sample to the same replicas under
    the same table version (disagreement means per-process salt crept
    into the hash — the ORP018 failure — or the gateways see different
    replica sets). Per-replica health ages are reported as the maximum
    staleness any gateway observes.
    ``store``       — probe a content-addressed bundle store
    (``orp doctor --store ROOT``): the catalog must parse, the CAS blob
    directory must be writable, and the catalog closure must be free of
    DANGLING references (a manifest pointing at bytes the CAS no longer
    holds means tenants that cannot activate — the failing row says which
    command re-publishes); orphan blobs are reported as reclaimable via
    ``orp store gc``, never as failures.
    ``pilot``       — probe a closed-loop pilot's plumbing from its
    ``orp-pilot-v1`` journal (``orp doctor --pilot JOURNAL``): the journal
    must parse (a torn tail is tolerated, anything else is corruption) and
    be appendable (``orp pilot retrain`` files requests into it), the last
    cycle's verdict must be PRESENT on its hash-linked promotions chain
    with every link verifying (a promoted/rejected cycle that left no
    chain verdict is an unauditable deploy), and the trigger sources named
    by the latest journaled config must be reachable — ``events_dir``
    readable, ``prices_path`` carrying at least ``calib_window`` rows — so
    a pilot that would silently never fire again is a failing row, not a
    mystery.
    ``gateway_timeout_s`` bounds every probe's connect AND every recv — a
    dead-but-ACCEPTING endpoint (the listener is up, nothing answers)
    becomes a failing check row within this budget, never an indefinite
    block.
    ``device``       — where the quality probe's engine runs (None = the
    card, as every entry point of the port).
    """
    checks: list[dict] = []
    # 1) devices + topology fingerprint: everything downstream keys on this
    try:
        import torch

        from orp_tpu_torch.parallel.mesh import topology_fingerprint

        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        visible = max(n_cards, 1)  # a CPU process is one device
        kind = torch.cuda.get_device_name(0) if n_cards else "cpu"
        n_want = None if mesh in (None, 0) else int(mesh)
        ok = n_want is None or n_want <= visible
        # fingerprint the topology actually buildable HERE: an oversized
        # mesh is its own (flag-speak) failure, not a backend crash
        topo = topology_fingerprint()
        if ok and n_want not in (None, 1):
            topo = f"{topo.rsplit('-n', 1)[0]}-n{n_want}"
        _check(checks, "devices", ok,
               f"{visible} x {kind} ({'gpu' if n_cards else 'cpu'}); "
               f"topology {topo}",
               fix=(f"mesh {n_want} exceeds the {visible} visible "
                    "devices — shrink the mesh or fix device visibility "
                    "(CUDA_VISIBLE_DEVICES / the driver)" if not ok else None))
    except Exception as e:  # orp: noqa[ORP009] -- the report IS the emission: the probe failure becomes a failing check row
        _check(checks, "devices", False, f"{type(e).__name__}: {e}",
               fix="no CUDA runtime came up — check the driver and "
                   "CUDA_VISIBLE_DEVICES before anything else")
        topo = None
    # 2) the kernel-build cache: unwritable -> every cold start pays the
    # nvcc bill again (warm_fused_walk / AOT installs are no-ops)
    from orp_tpu_torch.aot.cache import resolve_cache_dir

    cdir = resolve_cache_dir(cache_dir)
    if cdir is None:
        _check(checks, "compile_cache", True,
               "disabled by ORP_TESTS_NO_COMPILE_CACHE (kill-switch)")
    else:
        ok, detail = _dir_writable(cdir)
        _check(checks, "compile_cache", ok, detail,
               fix="point ORP_TORCH_CACHE_DIR (or "
                   "aot.enable_persistent_cache(DIR)) at a writable directory")
    # 3) the bundle: format gate, fingerprint, policy-step integrity digest
    if bundle_dir is not None:
        from orp_tpu_torch.serve.bundle import load_bundle

        bundle = None
        try:
            bundle = load_bundle(bundle_dir)
            _check(checks, "bundle", True,
                   f"{bundle_dir}: {bundle.n_dates} dates, "
                   f"fingerprint {(bundle.fingerprint or 'none')[:12]}…")
        except (ValueError, OSError) as e:
            _check(checks, "bundle", False, str(e),
                   fix="re-export with `orp export --out DIR` (plus --aot "
                       "for serialized executables)")
        # 4) AOT coverage for THIS topology (only meaningful on a loadable
        # bundle; a jit fallback is safe but pays cold compiles)
        if bundle is not None:
            from orp_tpu_torch.aot.bundle_exec import aot_status

            st = aot_status(bundle_dir, mesh=None if mesh in (None, 0, 1) else mesh)
            if not st["present"]:
                _check(checks, "bundle_aot", True,
                       "no AOT artifacts (eager serving; cold starts build)")
            else:
                _check(checks, "bundle_aot", st["ok"],
                       st["detail"],
                       fix="re-export the executables for this topology: "
                           "`orp export --aot --aot-mesh "
                           f"{1 if mesh in (None, 0) else int(mesh)}`")
    # 5) model-health plumbing: baseline sketch + validation fingerprint
    # baked, quality record parseable with an honest (nonzero) CI
    if quality is not None:
        from orp_tpu_torch.obs.quality import (evaluate_quality,
                                               validate_quality_record)
        from orp_tpu_torch.serve.bundle import load_bundle

        _refix = ("re-export with the current code: `orp export --out DIR` "
                  "bakes the per-feature baseline sketch and the pinned "
                  "validation set the drift monitor and the "
                  "quality_band canary gate need")
        try:
            qb = load_bundle(quality)
        except (ValueError, OSError) as e:
            _check(checks, "quality", False, f"{quality}: {e}", fix=_refix)
        else:
            if qb.feature_sketch is None or qb.validation is None:
                missing = [w for w, v in (("baseline sketch",
                                           qb.feature_sketch),
                                          ("validation set", qb.validation))
                           if v is None]
                _check(checks, "quality", False,
                       f"{quality}: bundle bakes no {' or '.join(missing)} "
                       "(pre-quality export)", fix=_refix)
            else:
                try:
                    rec = evaluate_quality(
                        qb, n_paths=min(qb.validation.n_paths, 256),
                        replicates=2, device=device)
                except (ValueError, RuntimeError) as e:
                    _check(checks, "quality", False,
                           f"{quality}: quality estimate failed ({e})",
                           fix=_refix)
                else:
                    problems = validate_quality_record(rec)
                    he = rec.get("hedge_error", {})
                    if not problems and not he.get("ci95", 0.0) > 0.0:
                        problems = ["ci95 is zero — replicates collapsed "
                                    "(identical scrambles?)"]
                    base = qb.hedge_error_baseline
                    _check(checks, "quality", not problems,
                           (f"{quality}: hedge_error {he.get('mean', 0):.5g}"
                            f" ± {he.get('ci95', 0):.2g} (RQMC, "
                            f"{rec.get('replicates')} replicates)"
                            + (f"; training baseline {base:.5g}"
                               if base is not None else "")
                            + f"; validation "
                              f"{qb.validation.fingerprint()[:48]}…"
                            if not problems else
                            f"{quality}: quality record invalid: "
                            f"{problems}"),
                           fix=_refix)
    # 6) obs sink target
    if telemetry_dir is not None:
        ok, detail = _dir_writable(telemetry_dir)
        _check(checks, "telemetry_sink", ok, detail,
               fix="--telemetry DIR must name a writable directory "
                   "(events.jsonl streams live)")
    # 7) ingest gateway liveness: connect + PING/PONG over orp-ingest-v1
    if gateway is not None:
        from orp_tpu_torch.serve.gateway import GatewayClient

        addr, _, port = str(gateway).rpartition(":")
        try:
            with GatewayClient(addr or "127.0.0.1", int(port),
                               timeout_s=float(gateway_timeout_s)) as client:
                ok = client.ping()
            _check(checks, "gateway", ok,
                   f"{gateway}: PING/PONG {'ok' if ok else 'FAILED'}",
                   fix="the endpoint answered but not in orp-ingest — "
                       "is something else listening on that port?")
        # RuntimeError covers GatewayError (connection dropped mid-reply:
        # wrong service, or a gateway mid-drain); socket.timeout (an
        # OSError) covers the dead-but-accepting endpoint, surfaced within
        # gateway_timeout_s — the probe's whole job is to turn ANY of these
        # into a failing check row, never a traceback or an open-ended wait
        except (OSError, ValueError, RuntimeError) as e:
            _check(checks, "gateway", False,
                   f"{gateway}: {type(e).__name__}: {e}"
                   if not str(e) else f"{gateway}: {e}",
                   fix="start the front with `orp serve-gateway --bundle "
                       "DIR --port N` (or fix the host:port); a connect "
                       "that hangs past the timeout is a dead-but-accepting "
                       "endpoint — restart it")
    # 8) live metrics scrape: the exposition must parse AND carry the core
    # serve series — an unobservable gateway fails its fleet (no health
    # signal to drive REDIRECTs on), even while it serves
    if metrics is not None:
        from orp_tpu_torch.serve.gateway import GatewayClient
        from orp_tpu_torch.serve.scrape import parse_prometheus

        core = ("serve_gateway_rows", "serve_queue_age_seconds",
                "guard_shed")
        addr, _, port = str(metrics).rpartition(":")
        try:
            with GatewayClient(addr or "127.0.0.1", int(port),
                               timeout_s=float(gateway_timeout_s)) as client:
                text = client.metrics()
                # the HEALTH probe rides along and EXPLICITLY requests the
                # serving process's flight-recorder dump (when armed) — a
                # doctor visit leaves the black box on disk; plain health
                # probes (orp top) never write
                health = client.health(dump_flight=True)
            series = parse_prometheus(text)
            missing = [n for n in core if n not in series]
            flight_note = (
                f"; flight ring {health.get('flight_recorded', 0)} event(s)"
                + (f" dumped to {health['flight_dump']}"
                   if health.get("flight_dump") else ""))
            _check(checks, "metrics", not missing,
                   (f"{metrics}: {len(series)} series, core present"
                    f"{flight_note}"
                    if not missing else
                    f"{metrics}: exposition parsed but lacks core serve "
                    f"series {missing}"),
                   fix="the endpoint answers METRICS frames but not with "
                       "the serve exposition — upgrade the gateway (`orp "
                       "serve-gateway` from this build pre-interns the "
                       "core series)")
        except (OSError, ValueError, RuntimeError) as e:
            _check(checks, "metrics", False,
                   f"{metrics}: {type(e).__name__}: {e}"
                   if not str(e) else f"{metrics}: {e}",
                   fix="no live scrape at that address — probe the ingest "
                       "port of a running `orp serve-gateway` (the METRICS "
                       "wire kind shares it), or fix host:port")
    # 9) the fleet: every replica + gateway answers, and every gateway
    # agrees on the routing table (the fleet's founding invariant)
    if fleet is not None:
        _fleet_checks(checks, fleet, timeout_s=float(gateway_timeout_s))
    # 10) performance observatory: profiler + trace dir, ledger, peak table
    if perf is not None:
        import tempfile

        from orp_tpu_torch.obs import perf as perf_mod

        import pathlib as _pathlib

        try:
            import torch.profiler as _profiler

            ok = hasattr(_profiler, "profile")
            w_ok, w_detail = _dir_writable(
                _pathlib.Path(tempfile.gettempdir()) / "orp_profile_probe")
            _check(checks, "perf_profiler", ok and w_ok,
                   ("torch.profiler.profile available; trace target "
                    f"{w_detail}") if ok else
                   "this torch build exposes no torch.profiler.profile",
                   fix=("profile without a trace dir (the span breakdown "
                        "still works), or install a torch build with the "
                        "profiler for perfetto captures" if not ok else
                        "point the profile's trace_dir at a writable "
                        "directory"))
        except Exception as e:  # orp: noqa[ORP009] -- the report IS the emission: the probe failure becomes a failing check row
            _check(checks, "perf_profiler", False,
                   f"{type(e).__name__}: {e}",
                   fix="torch.profiler failed to import — fix the torch "
                       "install before profiling anything")
        ledger_path = (perf if isinstance(perf, str)
                       else perf_mod.PERF_LEDGER_FILE)
        try:
            records, problems = perf_mod.read_ledger(ledger_path)
            invalid = sum(bool(perf_mod.validate_perf_record(r))
                          for r in records)
            lp = _pathlib.Path(ledger_path)
            if lp.exists():
                # appendable probe WITHOUT a side effect: open-for-append
                # on the existing file (never creates an empty ledger)
                with open(lp, "a"):
                    pass
                app = "appendable"
            else:
                ok_dir, dir_detail = _dir_writable(lp.parent
                                                   if str(lp.parent) else ".")
                if not ok_dir:
                    raise OSError(f"parent not writable ({dir_detail})")
                app = "absent (first run seeds it); parent writable"
            ok = invalid == 0
            _check(checks, "perf_ledger", ok,
                   f"{ledger_path}: {len(records)} record(s), {app}"
                   + (f", {len(problems)} torn-tail line(s) tolerated"
                      if problems else "")
                   + (f"; {invalid} INVALID record(s)" if invalid else ""),
                   fix="the ledger holds records that fail the orp-perf-v1 "
                       "schema — move it aside and reseed with `orp "
                       "serve-bench --ledger PATH` / `orp profile`")
        except (OSError, ValueError) as e:
            _check(checks, "perf_ledger", False, f"{ledger_path}: {e}",
                   fix="move the corrupt ledger aside; the next `orp "
                       "profile` / `orp serve-bench --ledger PATH` run "
                       "reseeds it")
        try:
            import torch

            kind = (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "cpu")
            peak, source = perf_mod.peak_for(kind)
            _check(checks, "perf_peaks", source == "table",
                   (f"PEAK_TABLE covers {kind!r} "
                    f"({peak['flops_per_s'] / 1e12:.1f} TFLOP/s f32 ceiling)"
                    if source == "table" else
                    f"{kind!r} not in PEAK_TABLE — roofline fractions fall "
                    f"back to the measured-matmul peak "
                    f"({peak['flops_per_s'] / 1e9:.1f} GFLOP/s)"),
                   fix=f"add a PEAK_TABLE entry for {kind!r} in "
                       "orp_tpu_torch/obs/perf.py (published FLOP/s + HBM "
                       "bytes/s) — until then frac_peak_* is against the "
                       "measured-matmul fallback and bytes/s fractions are "
                       "absent")
        except Exception as e:  # orp: noqa[ORP009] -- the report IS the emission: the probe failure becomes a failing check row
            _check(checks, "perf_peaks", False, f"{type(e).__name__}: {e}",
                   fix="no CUDA runtime came up — fix the driver first")
    # 11) the bundle store: catalog parseable, CAS writable, closure clean
    if store is not None:
        from orp_tpu_torch.store.catalog import open_store

        try:
            st = open_store(store)
            stats = st.stats()
        except (OSError, ValueError, KeyError) as e:
            _check(checks, "store_catalog", False, f"{store}: {e}",
                   fix="the catalog does not parse as orp-catalog-v1 — "
                       "move it aside and re-publish the tenants with "
                       "`orp store put --root ROOT --bundle DIR "
                       "--tenants NAME[,…]`")
        else:
            _check(checks, "store_catalog", True,
                   f"{store}: {stats['tenants']} tenant(s), "
                   f"{stats['manifests']} manifest(s), {stats['blobs']} "
                   f"blob(s) ({stats['blob_bytes']} bytes), dedup ratio "
                   f"{stats['dedup_ratio']}")
            ok, detail = _dir_writable(st.cas.blobs_dir)
            _check(checks, "store_cas", ok, detail,
                   fix="the CAS blob directory must be writable for "
                       "`orp store put` / export publishing to land")
            # dangling refs FAIL (tenants that cannot activate); orphan
            # blobs are just bytes awaiting gc — ok, with the reclaim note
            orphan_note = (
                f"; {stats['orphan_blobs']} orphan blob(s) "
                f"({stats['orphan_bytes']} bytes) reclaimable via "
                "`orp store gc`" if stats["orphan_blobs"] else "")
            _check(checks, "store_refs", stats["dangling_refs"] == 0,
                   (f"catalog closure clean{orphan_note}"
                    if stats["dangling_refs"] == 0 else
                    f"{stats['dangling_refs']} DANGLING blob reference(s) "
                    "— the catalog points at bytes the CAS no longer "
                    "holds; those tenants cannot activate"),
                   fix="re-publish the affected tenants with `orp store "
                       "put` (the missing blobs re-land content-addressed)")
    # 12) the pilot loop: journal parseable + appendable, the last cycle's
    # verdict chain-linked, and every configured trigger source reachable
    if pilot is not None:
        import pathlib as _pathlib

        from orp_tpu_torch.pilot import journal as _pj

        jp = _pathlib.Path(pilot)
        records: list[dict] = []
        try:
            records, problems = _pj.read_journal(jp)
            if jp.exists():
                # appendable probe WITHOUT a side effect (perf-ledger
                # discipline): open-for-append, never create
                with open(jp, "a"):
                    pass
                app = "appendable"
            else:
                ok_dir, dir_detail = _dir_writable(
                    jp.parent if str(jp.parent) else ".")
                if not ok_dir:
                    raise OSError(f"parent not writable ({dir_detail})")
                app = "absent (the first cycle seeds it); parent writable"
            _check(checks, "pilot_journal", True,
                   f"{jp}: {len(records)} record(s), {app}"
                   + (f", {len(problems)} torn-tail line(s) tolerated"
                      if problems else ""))
        except (OSError, ValueError) as e:
            _check(checks, "pilot_journal", False, f"{jp}: {e}",
                   fix="the journal was edited or its directory is not "
                       "writable — move the corrupt file aside; the next "
                       "cycle (or `orp pilot retrain --journal PATH`) "
                       "reseeds it")
        cid, recs = _pj.last_cycle(records)
        if cid is None:
            _check(checks, "pilot_cycle", True,
                   "no cycles journaled yet (the loop has not fired)")
        else:
            state = recs[-1].get("state")
            want = {"promoted": "promote", "rejected": "reject"}.get(state)
            chain = recs[-1].get("chain")
            if state not in _pj.TERMINAL_STATES:
                _check(checks, "pilot_cycle", True,
                       f"cycle {cid} parked at {state!r} — resumable "
                       "(PilotController.resume() continues it from the "
                       "journal)")
            elif want is None:
                _check(checks, "pilot_cycle", True,
                       f"cycle {cid} failed: "
                       f"{recs[-1].get('error', 'journaled error')} — the "
                       "next accepted trigger starts a fresh cycle")
            elif not chain:
                _check(checks, "pilot_cycle", False,
                       f"cycle {cid} {state} with NO promotions chain "
                       "configured — the verdict is unauditable",
                       fix="construct the ServeHost with "
                           "promotion_chain=PATH (or run under "
                           "--telemetry) so every pilot verdict lands "
                           "hash-linked")
            else:
                from orp_tpu_torch.obs.manifest import chain_verify, read_chain

                try:
                    cv = chain_verify(chain)
                    actions = [r.get("action") for r in read_chain(chain)]
                    ok = bool(cv["ok"]) and want in actions
                    _check(checks, "pilot_cycle", ok,
                           f"cycle {cid} {state}; chain {chain}: "
                           f"{cv['length']} verdict(s), "
                           + ("links verified" if cv["ok"] else
                              f"BROKEN ({'; '.join(cv['problems'][:2])})")
                           + ("" if want in actions else
                              f"; no {want!r} verdict on the chain"),
                           fix="the chain and the journal disagree about "
                               "the last cycle — verify with `orp report`/"
                               "chain_verify, move the edited chain aside, "
                               "and let the next reload reseed it")
                except OSError as e:
                    _check(checks, "pilot_cycle", False,
                           f"cycle {cid} {state}; chain {chain}: {e}",
                           fix="the journaled chain path is unreadable — "
                               "restore it or re-point the host's "
                               "promotion_chain")
        conf = _pj.latest_config(records)
        if conf is None:
            _check(checks, "pilot_triggers", True,
                   "no config journaled yet — manual requests "
                   "(`orp pilot retrain --journal PATH`) are the only "
                   "reachable source until a controller runs")
        else:
            notes: list[str] = []
            fails: list[str] = []
            fixes: list[str] = []
            ed = conf.get("events_dir")
            if ed:
                if _pathlib.Path(ed).is_dir():
                    notes.append(f"events_dir {ed} readable")
                else:
                    fails.append(f"events_dir {ed} is not a readable "
                                 "directory (drift trips unreachable)")
                    fixes.append("point PilotConfig.events_dir at the "
                                 "flight-recorder dump dir (RECORDER."
                                 "arm(DIR))")
            pp = conf.get("prices_path")
            if pp:
                need = conf.get("calib_window") or 0
                try:
                    with open(pp) as f:
                        rows = sum(1 for ln in f if ln.strip())
                    if rows >= need:
                        notes.append(f"prices_path {pp}: {rows} row(s) "
                                     f">= calib_window {need}")
                    else:
                        fails.append(f"prices_path {pp}: {rows} row(s) < "
                                     f"calib_window {need} — calibration "
                                     "triggers can never fire")
                        fixes.append("widen the feed or lower "
                                     "PilotConfig.calib_window")
                except OSError as e:
                    fails.append(f"prices_path {pp}: {e}")
                    fixes.append("restore the market feed file or re-point "
                                 "PilotConfig.prices_path")
            if not ed and not pp:
                notes.append("config names no events_dir/prices_path — "
                             "drift and calibration polls are fed "
                             "in-process; manual requests reachable")
            _check(checks, "pilot_triggers", not fails,
                   "; ".join(fails + notes) or "nothing configured",
                   fix="; ".join(fixes) if fixes else None)
    # always-on: the project-wide lock-discipline pass (pure AST over the
    # installed orp_tpu_torch package — no device). A finding here means a
    # deployed build whose serve/store planes carry a known race or
    # deadlock shape; the fleet drill should not be how it is discovered.
    try:
        from orp_tpu_torch.lint.concurrency import analyze_paths, build_analyzer
        from orp_tpu_torch.lint.engine import DEFAULT_LINT_ROOT

        conc = analyze_paths([DEFAULT_LINT_ROOT])
        stats = build_analyzer([DEFAULT_LINT_ROOT]).stats()
        _check(checks, "lint_concurrency", not conc,
               (f"{stats['classes']} classes / {stats['locks']} locks / "
                f"{stats['edges']} order edges indexed; "
                + (f"{len(conc)} unsuppressed finding(s): "
                   + "; ".join(f.render() for f in conc[:3])
                   if conc else "no unsuppressed findings")),
               fix="run `python -m orp_tpu_torch.lint --concurrency` and fix "
                   "(or reasoned-noqa) every ORP020/ORP021/ORP022 finding"
                   if conc else None)
    except Exception as e:  # orp: noqa[ORP009] -- the report IS the emission: the probe failure becomes a failing check row the CLI prints
        _check(checks, "lint_concurrency", False,
               f"{type(e).__name__}: {e}",
               fix="the concurrency analyzer crashed on this install — "
                   "run `python -m orp_tpu_torch.lint --concurrency` for the "
                   "traceback")
    return {"ok": all(c["ok"] for c in checks), "checks": checks}


def _fleet_checks(checks: list, topology, *, timeout_s: float) -> None:
    """The ``--fleet`` probe battery: replica liveness, gateway liveness,
    routing-table agreement across gateways, per-replica health age."""
    from orp_tpu_torch.serve.fleet import ROUTE_SAMPLE, FleetError, load_topology
    from orp_tpu_torch.serve.gateway import GatewayClient

    try:
        topo = load_topology(topology)
    except FleetError as e:
        _check(checks, "fleet_topology", False, str(e),
               fix='write topology.json as {"gateways": ["host:port", …], '
                   '"replicas": {"name": "host:port", …}}')
        return
    _check(checks, "fleet_topology", True,
           f"{topology}: {len(topo['replicas'])} replica(s), "
           f"{len(topo['gateways'])} gateway(s)")
    # every replica: one PING + health round trip through its own gateway
    for r in topo["replicas"]:
        try:
            with GatewayClient(r.addr, r.port, timeout_s=timeout_s) as c:
                ok = c.ping()
                doc = c.health()
            draining = bool(doc.get("draining"))
            _check(checks, f"replica:{r.name}", ok and not draining,
                   f"{r.addr}:{r.port}: PING "
                   f"{'ok' if ok else 'FAILED'}"
                   + ("; DRAINING (its tenants are remapping)"
                      if draining else ""),
                   fix=f"restart the replica's serve-gateway on "
                       f"{r.addr}:{r.port} (its tenants rendezvous onto "
                       "the survivors meanwhile)")
        except (OSError, ValueError, RuntimeError) as e:
            _check(checks, f"replica:{r.name}", False,
                   f"{r.addr}:{r.port}: {type(e).__name__}: {e}",
                   fix=f"restart the replica's serve-gateway on "
                       f"{r.addr}:{r.port} (its tenants rendezvous onto "
                       "the survivors meanwhile)")
    # every gateway: liveness + its ROUTING VIEW over a fixed tenant sample
    views = {}
    for addr, port in topo["gateways"]:
        target = f"{addr}:{port}"
        try:
            with GatewayClient(addr, port, timeout_s=timeout_s) as c:
                ok = c.ping()
                doc = c.health(route=list(ROUTE_SAMPLE))
            routing = doc.get("routing")
            if routing is None:
                _check(checks, f"gateway:{target}", False,
                       f"{target}: answers but exports no routing view",
                       fix="this is a plain serving gateway, not a fleet "
                           "router — start it with `orp serve-gateway "
                           "--fleet topology.json`")
                continue
            views[target] = routing
            unhealthy = [n for n in routing.get("replicas", ())
                         if n not in (routing.get("healthy") or ())]
            _check(checks, f"gateway:{target}", ok,
                   f"{target}: routing {routing.get('version')}, "
                   f"{len(routing.get('healthy') or ())}/"
                   f"{len(routing.get('replicas') or ())} replicas "
                   "healthy"
                   + (f" (unhealthy: {unhealthy})" if unhealthy else ""),
                   fix=f"restart the fleet gateway on {target}")
        except (OSError, ValueError, RuntimeError) as e:
            _check(checks, f"gateway:{target}", False,
                   f"{target}: {type(e).__name__}: {e}",
                   fix=f"start the fleet gateway: `orp serve-gateway "
                       f"--fleet {topology} --port {port}`")
    # routing agreement: same sample -> same replica from EVERY gateway
    if len(views) >= 1:
        versions = {v.get("version") for v in views.values()}
        maps = [v.get("map") or {} for v in views.values()]
        agree = len(versions) == 1 and all(m == maps[0] for m in maps[1:])
        # worst case wins deterministically: None (never probed ok) beats
        # any numeric age, larger beats smaller — order-independent
        ages = {}
        for v in views.values():
            for name, age in (v.get("ages_s") or {}).items():
                if name in ages and (ages[name] is None or age is None):
                    ages[name] = None
                elif name not in ages or age > ages[name]:
                    ages[name] = age
        _check(checks, "fleet_routing", agree,
               (f"{len(views)} gateway(s) agree: version "
                f"{next(iter(versions))}, {len(maps[0])} sampled tenants "
                f"map identically; health ages (max) {ages}"
                if agree else
                f"gateways DISAGREE: versions {sorted(versions)} — same "
                "tenant sample maps differently across gateways"),
               fix="the rendezvous table diverged: make sure every "
                   "gateway runs the same topology.json and the same "
                   "build (per-process salt in routing code is the "
                   "ORP018 lint failure)")
