"""Device-time attribution: split host-blocked walls into queue vs device (counterpart of the attribution core of ``orp_tpu/obs/devprof.py``).

A span's wall conflates three bills: the Python and launch work before the
wait, the time a launch sat QUEUED behind earlier work on the card's
(serial) stream, and the card EXECUTING it. This module is the flag-gated
profiling mode that separates them:

- :func:`enable` / :func:`profiling` switch attribution on process-wide;
  disabled is the default and costs one module-global load and an ``is
  None`` test a site (the ``obs.spans`` discipline);
- :class:`DevProf` is a serial-device completion chain. Each launch stamps
  its submit instant; at completion the device window is ``[max(t_dispatch,
  previous_completion), t_done]``: on a serial device a launch cannot start
  before its predecessor completes, so ``device_s = t_done - start`` and
  ``queue_s = start - t_dispatch`` partition the dispatch-to-done wall
  exactly (``queue_s + device_s == t_done - t_dispatch``). Per-bucket device
  and queue seconds land in ``serve/device_seconds{bucket}`` and
  ``serve/queue_wait_seconds{bucket}`` on the active session's registry and
  in the DevProf's own bounded windows (:meth:`DevProf.bucket_stats`,
  readable with no session);
- a rolling device-utilization gauge (``serve/device_utilization``): busy
  device seconds over the trailing horizon;
- the obs :class:`~orp_tpu_torch.obs.spans.Span` consults :func:`active`
  at its wait: with attribution on, every span event also carries
  ``host_s`` (span open to the wait: Python and launches) and ``device_s``
  (the waited tail), summing to ``dur_s`` exactly. The fused walk is one
  span, so it splits as a whole.

On the card ``serve/engine.PendingEval.result`` waits for the device before
it copies the rows back, so the completion instant is the device's, not the
copy's.

- :func:`profile_north_star` / :func:`profile_serve` / :func:`profile_run`:
  the ``orp profile`` workloads. Each stage runs ONCE under a per-stage
  ``aot.CompileTimeMonitor`` (the port's compile bill: ``nvcc`` runs and
  CUDA-graph captures, where the reference reads XLA's compile events) and
  device attribution, so compile vs execute and host vs device split in one
  run, with the FLOP ledger (``utils/flops.py``) and the roofline join
  (``obs/perf.py``) per stage. The north star's ``sim`` stage is K1
  (``qmc/fused_gbm.gbm_log_fused``) on the card. ``trace_dir`` wraps the run
  in ``torch.profiler`` with CPU and CUDA activities (the obs spans are
  ``record_function`` regions under it) and writes a Chrome trace there; on
  a machine where CUPTI records no device activity it raises.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

#: samples retained per bucket window — enough for a bench phase's medians,
#: bounded so an always-on server never grows
_WINDOW = 4096


class DevProf:
    """Serial-device completion-chaining attribution (see module docstring).

    Thread-safe: the batcher's resolve stage and direct ``evaluate`` callers
    may complete dispatches concurrently; the chain advances under one lock.
    """

    def __init__(self, *, horizon_s: float = 30.0):
        self.horizon_s = float(horizon_s)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_complete = self._t0
        # rolling (completion_instant, device_s) window for the util gauge,
        # with the busy sum maintained INCREMENTALLY: the per-completion
        # bill must stay O(1), not O(window)
        self._busy: collections.deque = collections.deque(maxlen=_WINDOW)
        self._busy_sum = 0.0
        # completion instant of the last sample the CAP (not the horizon)
        # evicted: the retained window then only represents time after it,
        # and utilization must shrink its denominator to match — dividing
        # a 4096-sample window by the full horizon under sustained load
        # would underreport a busy device by the drop ratio
        self._cap_evicted_t: float | None = None
        # per-bucket bounded device/queue second windows, session-independent
        self._device: dict[str, collections.deque] = {}
        self._queue: dict[str, collections.deque] = {}
        self.completions = 0
        # cached session-registry instrument handles, keyed by bucket and
        # invalidated when the obs session changes: registry interning
        # (sorted label tuples under the registry lock) per completion
        # would dominate the per-dispatch bill
        self._instr_state = None
        self._instr: dict[str, tuple] = {}

    def complete(self, t_dispatch: float, t_block_start: float,
                 *, bucket=None) -> tuple[float, float]:
        """One dispatch finished NOW: attribute its wall. Returns
        ``(queue_s, device_s)`` with ``queue_s + device_s == now -
        t_dispatch`` exactly (the serial-device partition). ``t_block_start``
        is recorded for honesty (the host-blocked portion is ``now -
        t_block_start``) but the attribution keys on the dispatch instant —
        the device was working whether or not the host was watching."""
        t_done = time.perf_counter()
        key = str(bucket)
        with self._lock:
            start = min(max(t_dispatch, self._last_complete), t_done)
            device_s = t_done - start
            queue_s = start - t_dispatch
            self._last_complete = t_done
            self.completions += 1
            if len(self._busy) == self._busy.maxlen:
                # about to roll off the CAP: remember its instant so the
                # utilization denominator covers only the retained span
                self._cap_evicted_t = self._busy[0][0]
                self._busy_sum -= self._busy[0][1]
            self._busy.append((t_done, device_s))
            self._busy_sum += device_s
            cutoff = t_done - self.horizon_s
            while self._busy and self._busy[0][0] < cutoff:
                self._busy_sum -= self._busy.popleft()[1]
            dq = self._device.get(key)
            if dq is None:
                dq = self._device[key] = collections.deque(maxlen=_WINDOW)
                self._queue[key] = collections.deque(maxlen=_WINDOW)
            dq.append(device_s)
            self._queue[key].append(queue_s)
        # session mirror: registry-only histograms (no sink event per
        # dispatch) + the live utilization gauge, through handles cached per
        # (session, bucket)
        from orp_tpu_torch.obs.spans import state

        st = state()
        if st is not None:
            if st is not self._instr_state:
                self._instr_state = st
                self._instr = {}
            handles = self._instr.get(key)
            if handles is None:
                labels = {"bucket": key}
                handles = self._instr[key] = (
                    st.registry.histogram("serve/device_seconds", labels),
                    st.registry.histogram("serve/queue_wait_seconds",
                                          labels),
                    st.registry.gauge("serve/device_utilization"),
                )
            handles[0].observe(device_s)
            handles[1].observe(queue_s)
            # decimated: the gauge is a dashboard series, not a ledger —
            # every 16th completion (and the first) keeps it fresh without
            # putting the utilization fold on every dispatch
            if self.completions % 16 == 1:
                handles[2].set(round(self.utilization(), 6))
        return queue_s, device_s

    def utilization(self) -> float:
        """Busy device seconds over the trailing horizon (0..~1; >1 is
        impossible by construction — the chain serializes windows)."""
        now = time.perf_counter()
        with self._lock:
            cutoff = now - self.horizon_s
            while self._busy and self._busy[0][0] < cutoff:
                self._busy_sum -= self._busy.popleft()[1]
            busy = max(self._busy_sum, 0.0)
            elapsed = min(self.horizon_s, now - self._t0)
            if (self._cap_evicted_t is not None
                    and self._cap_evicted_t >= cutoff):
                # the sample cap truncated the window inside the horizon:
                # the retained completions only describe [evicted, now]
                elapsed = min(elapsed, now - self._cap_evicted_t)
        return busy / elapsed if elapsed > 0 else 0.0

    def bucket_stats(self) -> dict:
        """Per-bucket attribution summary from the bounded windows:
        ``{bucket: {count, device_s_median, device_s_total, queue_s_median}}``
        — readable with NO telemetry session."""
        import numpy as np

        out = {}
        with self._lock:
            items = [(k, list(v), list(self._queue[k]))
                     for k, v in self._device.items()]
        for key, dev, que in items:
            if not dev:
                continue
            q25, q75 = np.percentile(dev, [25.0, 75.0])
            out[key] = {
                "count": len(dev),
                "device_s_median": float(np.median(dev)),
                # the window's spread beside its median
                "device_s_iqr": float(q75 - q25),
                "device_s_total": float(np.sum(dev)),
                "queue_s_median": float(np.median(que)),
            }
        return out


_STATE: DevProf | None = None


def enable(*, horizon_s: float = 30.0) -> DevProf:
    """Switch device-time attribution on process-wide."""
    global _STATE
    _STATE = DevProf(horizon_s=horizon_s)
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def active() -> DevProf | None:
    """The live attribution state, or None — the disabled path is one
    module-global load + ``is None`` test (the spans discipline)."""
    return _STATE


@contextlib.contextmanager
def profiling(*, horizon_s: float = 30.0):
    """``enable``/``disable`` as a scope; yields the :class:`DevProf`.
    Restores any previously-installed state on exit (benches nest)."""
    global _STATE
    prev = _STATE
    prof = DevProf(horizon_s=horizon_s)
    _STATE = prof
    try:
        yield prof
    finally:
        _STATE = prev


# -- the `orp profile` workloads ----------------------------------------------


def _stage(stages: dict, name: str, fn, *, flops: float | None = None,
           extra: dict | None = None):
    """Run ``fn`` once as stage ``name``: wall, compile seconds (``nvcc`` and
    graph captures), execute wall, host/device split, and with ``flops`` the
    roofline on the first basis of the ladder execute wall, device wait, total
    wall that keeps the fraction of peak <= 1. Returns ``fn``'s result."""
    from orp_tpu_torch.aot import CompileTimeMonitor
    from orp_tpu_torch.obs import perf as _perf
    from orp_tpu_torch.obs.spans import span
    from orp_tpu_torch.utils.profiling import block_until_ready

    with CompileTimeMonitor() as mon:
        with span(f"profile/{name}") as sp:
            t0 = time.perf_counter()
            out = sp.set_result(fn())
            t_pre = time.perf_counter()
        block_until_ready(f"profile/{name}", out)
        t_done = time.perf_counter()
    wall = t_done - t0
    exec_raw = max(wall - mon.seconds, 0.0)
    device_raw = t_done - t_pre
    entry = {"wall_s": round(wall, 3), "compile_s": round(mon.seconds, 3),
             "execute_wall_s": round(exec_raw, 3), "host_s": round(t_pre - t0, 3),
             "device_wait_s": round(device_raw, 3)}
    if flops:
        candidates = []
        if exec_raw > 1e-6:
            candidates.append(("execute_wall", exec_raw))
        if device_raw > 1e-6:
            candidates.append(("device_wait", device_raw))
        candidates.append(("total_wall_including_compile", wall))
        for basis, basis_s in candidates:
            rl = _perf.roofline(flops, None, basis_s)
            frac = rl.get("frac_peak_flops")
            if frac is None or frac <= 1.0:
                break
        entry["flops"] = int(flops)
        entry["roofline"] = {"basis": basis, **rl}
    if extra:
        entry.update(extra)
    stages[name] = entry
    return out


def _platform(dev) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def profile_north_star(n_log2: int = 20, *, quick: bool = False, device=None) -> dict:
    """Stage-level breakdown of the north-star hedge: sim (K1) -> prep -> fused
    Adam walk -> fused GN walk, each stage ONE run with its compile seconds,
    host/device split and FLOP ledger + roofline. ``quick`` shrinks to a smoke
    shape (2^10 paths, 4 dates, tiny budgets): the same stages and fields."""
    import dataclasses

    import torch

    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig
    from orp_tpu_torch.api.pipelines import _backward_cfg
    from orp_tpu_torch.models.mlp import HedgeMLP
    from orp_tpu_torch.qmc.fused_gbm import gbm_log_fused
    from orp_tpu_torch.sde import TimeGrid, bond_curve, payoffs
    from orp_tpu_torch.train.backward import backward_induction
    from orp_tpu_torch.utils import flops as F
    from orp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if quick:
        n_log2 = min(n_log2, 10)
    n_paths = 1 << n_log2
    euro = EuropeanConfig(constrain_self_financing=False)
    if quick:
        sim = SimConfig(n_paths=n_paths, T=1.0, dt=1 / 52, rebalance_every=13)
        train = TrainConfig(dual_mode="mse_only", epochs_first=8, epochs_warm=4,
                            batch_size=max(n_paths // 4, 64))
        gn_first, gn_warm = 4, 2
    else:
        sim = SimConfig(n_paths=n_paths, T=1.0, dt=1 / 364, rebalance_every=7)
        train = TrainConfig(dual_mode="mse_only", epochs_first=120, epochs_warm=30,
                            batch_size=max(n_paths // 64, 512))
        gn_first, gn_warm = 60, 30
    stages: dict = {}
    grid = TimeGrid(sim.T, sim.n_steps)

    s = _stage(stages, "sim", lambda: gbm_log_fused(
        n_paths, sim.n_steps, s0=euro.s0, drift=euro.r, sigma=euro.sigma, dt=grid.dt,
        seed=sim.seed_fund, store_every=sim.rebalance_every, device=dev),
        flops=F.sim_flops(n_paths, sim.n_steps))

    def prep():
        coarse = grid.reduced(sim.rebalance_every)
        b = bond_curve(coarse, euro.r, torch.float32, dev)
        payoff = payoffs.european(s[:, -1], euro.strike, euro.option_type)
        sn = s / euro.s0
        bn = (b / euro.s0).to(torch.float32)
        terminal = payoff / euro.s0
        return sn[:, :, None], sn, bn, terminal, float(torch.mean(payoff)) / euro.s0

    features, sn, bn, terminal, e_payoff_n = _stage(stages, "prep", prep)
    n_dates = sn.shape[1] - 1
    model = HedgeMLP(n_features=1, constrain_self_financing=False)
    args = (model, features, sn, bn, terminal)
    adam_cfg = dataclasses.replace(_backward_cfg(train), fused=True, shuffle="blocks")
    _stage(stages, "adam_walk",
           lambda: backward_induction(*args, adam_cfg, bias_init=(e_payoff_n, 0.0)).values,
           flops=F.adam_walk_flops(n_paths, n_dates, train.epochs_first, train.epochs_warm))
    gn_cfg = dataclasses.replace(adam_cfg, optimizer="gauss_newton", gn_iters_first=gn_first,
                                 gn_iters_warm=gn_warm)
    _stage(stages, "gn_walk",
           lambda: backward_induction(*args, gn_cfg, bias_init=(e_payoff_n, 0.0)).values,
           flops=F.gn_walk_flops(n_paths, n_dates, gn_first, gn_warm))
    return {"workload": "north_star", "n_paths": n_paths, "n_dates": int(n_dates),
            "quick": bool(quick), "platform": _platform(dev), "stages": stages}


def profile_serve(bundle, *, quick: bool = False, n_requests: int = 200,
                  batch_sizes=(1, 7, 64, 1000), device=None) -> dict:
    """Device-time breakdown of a serve schedule over ``bundle`` (a directory
    or a loaded policy; an AOT bundle serves its buckets from graphs): the
    request mix under attribution, the per-bucket queue/device table, the
    utilization, and the roofline of the headline bucket's analytic cost
    (``HedgeEngine.program_cost``) against its median device seconds."""
    import numpy as np

    from orp_tpu_torch.obs import perf as _perf
    from orp_tpu_torch.serve.engine import HedgeEngine

    policy = bundle
    if isinstance(bundle, str):
        from orp_tpu_torch.serve.bundle import load_bundle

        policy = load_bundle(bundle)
    if quick:
        n_requests = min(n_requests, 24)
        batch_sizes = tuple(b for b in batch_sizes if b <= 64) or (1, 8)
    engine = HedgeEngine(policy, device=device)
    rng = np.random.default_rng(0)
    nf = engine.model.n_features
    engine.prewarm(batch_sizes)
    with profiling() as prof:
        for i in range(n_requests):
            n = batch_sizes[i % len(batch_sizes)]
            feats = (1.0 + 0.1 * rng.standard_normal((n, nf))).astype(np.float32)
            engine.evaluate(i % engine.n_dates, feats)
        stats = prof.bucket_stats()
        util = prof.utilization()
    headline = engine.bucket_for(max(batch_sizes))
    roofline = None
    try:
        cost = engine.program_cost(max(batch_sizes))
        med = stats.get(str(headline), {}).get("device_s_median")
        if med and cost.get("flops"):
            roofline = {"bucket": headline, **cost, "device_s_median": round(med, 6),
                        **_perf.roofline(cost["flops"], cost.get("bytes_accessed"), med,
                                         precision=engine.precision.tier)}
    except Exception as e:  # orp: noqa[ORP009] -- the degradation is recorded in the record's roofline field
        roofline = {"error": f"{type(e).__name__}: {e}"}
    return {"workload": "serve", "n_requests": int(n_requests),
            "batch_sizes": list(batch_sizes), "quick": bool(quick),
            "policy": _perf.policy_digest(policy), "platform": _platform(engine.device),
            "device_utilization": round(util, 4),
            "buckets": {k: {f: round(v, 6) if isinstance(v, float) else v
                            for f, v in st.items()} for k, st in stats.items()},
            "roofline": roofline, "aot_buckets": engine.cache_info()["aot_buckets"]}


def profile_run(*, workload: str = "north-star", bundle=None, n_log2: int = 20,
                quick: bool = False, trace_dir=None, device=None) -> dict:
    """The ``orp profile`` driver: the selected workload under device
    attribution (and ``torch.profiler`` with CPU and CUDA activities when
    ``trace_dir`` is given: a Chrome trace ``trace.json`` lands there, the obs
    spans naming its regions), the record emitted through obs and returned.
    A card whose profiler records no device activity (CUPTI refused) raises."""
    import pathlib

    import torch

    from orp_tpu_torch.obs import spans as _spans
    from orp_tpu_torch.obs.spans import emit_record

    prof_ctx = contextlib.nullcontext()
    on_card = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    if trace_dir is not None:
        pathlib.Path(trace_dir).mkdir(parents=True, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof_ctx = torch.profiler.profile(activities=acts)
    with contextlib.ExitStack() as stack:
        if not _spans.enabled():
            # without a session span() is the no-op: run under a registry-backed
            # one so the spans name the profiler's regions and block
            stack.enter_context(_spans.active())
        stack.enter_context(profiling())
        tp = stack.enter_context(prof_ctx)
        if workload == "serve":
            if bundle is None:
                raise ValueError("profile workload 'serve' needs bundle= (a bundle directory "
                                 "or a loaded policy)")
            out = profile_serve(bundle, quick=quick, device=device)
        else:
            out = profile_north_star(n_log2, quick=quick, device=device)
    if trace_dir is not None:
        path = pathlib.Path(trace_dir) / "trace.json"
        tp.export_chrome_trace(str(path))
        if on_card:
            dev_us = sum(getattr(e, "device_time_total", 0.0) or 0.0 for e in tp.key_averages())
            if dev_us <= 0:
                raise RuntimeError(
                    f"profile_run(trace_dir={trace_dir!r}): torch.profiler recorded no device "
                    "activity on this card (CUPTI tracing refused on this machine) — drop "
                    "trace_dir to profile with the stage table's CUDA-synchronized walls alone")
        out["trace_dir"] = str(trace_dir)
    emit_record("profile", out)
    return out
