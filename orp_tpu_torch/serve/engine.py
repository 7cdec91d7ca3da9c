"""Batched policy evaluation with power-of-two buckets (counterpart of ``orp_tpu/serve/engine.py``).

``HedgeEngine(policy).evaluate(date_idx, states[, prices])`` pads a request up
to its power-of-two bucket, evaluates it and slices the padding off. The
per-date forward is the model's in plain PyTorch (the JAX package computes it
outside Pallas too) with the training walk's combines
(``megakernel.serve_outputs``, in f32 bitwise ``_date_outputs_core``), so a
served ``(phi, psi, value)`` is the ``european_oos`` ledger column on the
same inputs.
``evaluate_mixed_async(dates, states[, prices])`` takes one date per ROW and
runs the whole block through the mixed-date kernel (``serve/megakernel.py``).

``HedgeEngine(policy, precision=tier)`` serves at one of the tiers of
``serve/precision.py``: ``f32`` (the default, the historical bits), ``bf16``
(host f32 rows become bf16 on the device; the bf16 forward, and on the card
the bf16 kernel) or ``int8`` (int8 weights dequantized to f32 before the f32
forward). Outputs are f32 in every tier.

``HedgeEngine(policy, mesh=)`` serves over a paths mesh (``parallel/mesh.py``),
as the JAX package's batch-sharded engine: the bucket is rounded up to a
multiple of the mesh size (``pad_to_mesh``), each rank runs the per-date
forward on its contiguous shard of the padded rows, and the shards are
gathered, so every rank returns the whole ``(phi, psi, value)``. A mesh engine
keeps the per-date path (``evaluate_mixed_async`` refuses, as in the JAX
package). Where one rank takes the traffic (a batcher, a degradation
manager), the others mirror it through a :class:`MeshChannel`: rank 0's engine
broadcasts each dispatch, and :func:`follow` makes the same call on each other
rank. With an AOT set the rank replays its shard's bucket graph and gathers
outside it (a ``gloo`` collective cannot be captured). The per-date forward
runs in row tiles of :data:`ROW_TILE` rows (the last one padded), so every
product it makes has the same shape whatever the request or the shard:
cuBLAS picks its kernel by shape, and a 262,144-row
shard of a 1,048,576-row bucket otherwise rounds differently from the whole
on an H100 (``tools/torch_mesh_probe.py``), which would part the sharded
engine from the whole one.
Telemetry (``obs/``) as in the JAX package: ``serve/pad``, ``serve/dispatch``
and ``serve/unpad`` are spans under a session and ``utils/profiling.trace``
regions without one (named regions in a ``torch.profiler`` capture, free
outside one); the counters ``serve/bucket_hits`` (registry only),
``serve/bucket_misses{bucket}`` (an event), ``serve/rows``,
``serve/pad_waste_rows`` and, on the mixed path,
``serve/megakernel_dispatches``; under ``obs.devprof`` attribution each
:class:`PendingEval` carries its launch instant and :meth:`PendingEval.result`
waits for the device before it copies the rows back, so the queue / device
split ends at the device's completion.
Guard hooks (``guard/inject.py``, each a no-op without an installed plan): the
``serve/dispatch`` fault site fires in :meth:`HedgeEngine.evaluate_async` and
:meth:`HedgeEngine.evaluate_mixed_async` before the launch, ``serve/execute``
in :meth:`PendingEval.result` before the copy; the counters move only after a
dispatch succeeded, so a retried transient fault counts once. The
stuck-dispatch watchdog's trips count on a :class:`CircuitBreaker`
(:meth:`HedgeEngine.watchdog_trip`). The engine's device params live in a
:class:`ResidentParams` that another engine of the same policy, tier and
device may share (``resident=``): the warm tier of ``serve/host.py`` rebuilds
an engine with no host-to-device copy and no kernel build.
AOT bundles (``aot/bundle_exec.py``): a policy loaded from a bundle that ships
an AOT set (``policy.aot_dir``) has its libraries installed into the build
cache and one CUDA graph captured per shipped bucket when the first engine
of its :class:`ResidentParams` is built (``use_aot=True``, the default;
``use_aot=False`` keeps today's engine exactly); engines sharing the resident
params replay the same graphs, so a warm re-activation captures nothing.
A request in such a bucket copies its padded rows and date into the graph's
static buffers and replays it (its ``serve/dispatch`` span says ``aot: True``,
and it passes the ``serve/aot_dispatch`` fault site); the replay is bitwise
the eager forward. A failed replay serves that request eagerly, and
``aot_failure_threshold`` failures of a bucket in a row (or as many
``watchdog_trip`` hangs) demote it to the eager path for good
(``guard/circuit_open``), as the JAX package's circuit breaker does.
Buckets bound the set of shapes a request can take, which keeps the kernel's
launch shapes and the caching allocator's block sizes to a small fixed set.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import numpy as np
import torch

from orp_tpu_torch.guard import inject as _inject
from orp_tpu_torch.guard.serve import CircuitBreaker, DeviceLostError
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import devprof as _devprof
from orp_tpu_torch.obs import enabled as obs_enabled
from orp_tpu_torch.obs import span as obs_span
from orp_tpu_torch.parallel.mesh import (as_mesh, broadcast_from_first, mesh_device, mesh_rank,
                                         mesh_size, pad_to_mesh, path_gather, shard_rows)
from orp_tpu_torch.serve.megakernel import (
    _eval_core_mixed,
    check_head_shape,
    pack_head_params,
    serve_outputs,
)
from orp_tpu_torch.serve.precision import (
    dequantize_params,
    eval_model,
    gather_date,
    normalize_precision,
    prepare_params,
)
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.precision import full_f32
from orp_tpu_torch.utils.profiling import block_until_ready, trace


def span(name, attrs=None):
    """A telemetry span when a session is active, a ``utils/profiling.trace``
    region otherwise."""
    return obs_span(name, attrs) if obs_enabled() else trace(name)


def _eval_core(model, p1_all, p2_all, date_idx: int, feats, prices, cost_of_capital, *,
               dual_mode, holdings_combine, precision="f32"):
    """One bucket-shaped evaluation at one date: gather the date's params, run
    the model's head under each param set and the walk's combines
    (``megakernel.serve_outputs``: ``_date_outputs_core``'s arithmetic with
    ``prices_t1 = 0``, target 0).

    ``precision`` is the tier (``serve/precision.py``): ``int8`` dequantizes
    the gathered weights to f32 before the f32 forward, ``bf16`` runs the bf16
    model on bf16 rows; outputs are f32 either way. ``date_idx`` is an int, or
    a 0-d device tensor (a captured graph's date)."""
    p1, p2 = gather_date(p1_all, date_idx), gather_date(p2_all, date_idx)
    if precision == "int8":
        p1, p2 = dequantize_params(p1), dequantize_params(p2)
    m = eval_model(model, precision)
    feats = feats.to(m.dtype)
    raw1 = m.head(p1, feats)
    raw2 = raw1 if dual_mode == "mse_only" else m.head(p2, feats)
    return serve_outputs(m, raw1, raw2, prices, cost_of_capital, dual_mode=dual_mode,
                         holdings_combine=holdings_combine)


#: rows of one per-date forward: a request or shard is evaluated in tiles of
#: this many rows, the last one padded, so each product has this shape
ROW_TILE = 1 << 16


def _eval_tiled(model, p1_all, p2_all, date_idx: int, feats, prices, cost_of_capital, **kw):
    """:func:`_eval_core` over row tiles of :data:`ROW_TILE` (the last padded
    with zero rows), the outputs cut back to the given rows."""
    n = feats.shape[0]
    pad = -n % ROW_TILE
    if pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        prices = torch.nn.functional.pad(prices, (0, 0, 0, pad))
    tiles = [_eval_core(model, p1_all, p2_all, date_idx, feats[s:s + ROW_TILE],
                        prices[s:s + ROW_TILE], cost_of_capital, **kw)
             for s in range(0, n + pad, ROW_TILE)]
    return tuple(torch.cat(cols)[:n] for cols in zip(*tiles))


def next_bucket(n: int, *, min_bucket: int = 8) -> int:
    """Smallest power of two >= n, floored at ``min_bucket``."""
    if n < 1:
        raise ValueError(f"batch of {n} rows never dispatches — empty requests "
                         "short-circuit before bucketing")
    return max(min_bucket, 1 << (n - 1).bit_length())


#: the messages of a :class:`MeshChannel`: a dispatch to mirror, a device loss
#: (its header carries the survivors), and the end of the front's traffic
DISPATCH, LOSS, STOP = 1, 2, 3


class MeshChannel:
    """The ordered channel from rank 0 of a mesh engine to the other ranks.

    A mesh engine is SPMD by hand: every rank must make the same engine calls
    in the same order, or two ranks' gathers meet at different sizes (``gloo``
    aborts) or at different requests (the answer mixes them). A
    ``MicroBatcher`` coalesces by timing, so the batchers of two ranks cut one
    stream into different buckets. The channel makes rank 0 the front: its
    engine (``engine.front = channel``) broadcasts each dispatch (the date, the
    rows, the states and prices) just before its forward, and the other ranks
    run :func:`follow`, which makes the same call. The lock holds a dispatch's
    broadcast and gather together, and the front's other messages (a loss, the
    stop) take it too, so nothing interleaves on the group. A ``retired``
    channel (its mesh was rebuilt) refuses dispatches with ``DeviceLostError``.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.is_front = mesh_rank(mesh) == 0
        self.lock = threading.RLock()
        self.retired = False

    def send(self, op: int, ints=(), payload=None) -> None:
        """Rank 0: one message (``op``, a few ints, an optional float tensor)."""
        with self.lock:
            broadcast_from_first(self.mesh, [op, *ints], payload)

    def recv(self):
        """Any other rank: rank 0's next message, ``(op, ints, payload)``."""
        ints, payload = broadcast_from_first(self.mesh)
        return ints[0], ints[1:], payload


def follow(engine, channel: MeshChannel):
    """A follower rank's half of :class:`MeshChannel`: make every dispatch rank
    0 broadcasts on this rank's ``engine`` (its shard's forward and the
    gather), until another message arrives; return that one as ``(op, ints)``."""
    while True:
        # a broadcast on the mesh's group, bounded by the group's timeout
        op, ints, payload = channel.recv()  # orp: noqa[ORP014] -- a collective, not a socket
        if op != DISPATCH:
            return op, ints
        date, n, f, k = ints
        rows = payload.numpy()
        engine.evaluate_async(date, rows[:n * f].reshape(n, f),
                              rows[n * f:].reshape(n, k) if k else None)


class PendingEval:
    """A launched evaluation: the device owns it until :meth:`result` copies
    the rows back to the host and slices the padding off. ``prof`` and
    ``t_dispatch``: the live ``obs.devprof`` state and the launch instant,
    stamped by the engine when attribution is on (None when off)."""

    __slots__ = ("_phi", "_psi", "_v", "_n", "_has_prices", "bucket", "_prof", "_t_dispatch")

    def __init__(self, phi, psi, v, n: int, has_prices: bool, bucket: int, prof=None,
                 t_dispatch: float = 0.0):
        self._phi, self._psi, self._v = phi, psi, v
        self._n = int(n)
        self._has_prices = has_prices
        self.bucket = int(bucket)
        self._prof = prof
        self._t_dispatch = t_dispatch

    def result(self):
        """``(phi, psi, value)`` host arrays of the requested rows (``value``
        None when the request carried no prices). Waits for the device: under
        telemetry or attribution it waits first, stamps the completion
        (``serve/device_seconds{bucket}``), then copies and unpads under
        ``serve/unpad``; otherwise the copy itself waits, as it always has."""
        n = self._n
        inj = _inject.active()
        if inj is not None:
            # the block-time fault site: a hung launch is a delay here past
            # GuardPolicy.hard_wall_ms, a transient surfacing at completion a fail
            inj.fire("serve/execute", bucket=self.bucket)
        prof = self._prof
        if prof is not None or obs_enabled():
            t_block = time.perf_counter()
            block_until_ready("serve/unpad", (self._phi, self._psi, self._v))
            if prof is not None:
                # serial-device attribution: this launch's wall splits into
                # queue vs device seconds and feeds the utilization gauge
                prof.complete(self._t_dispatch, t_block, bucket=self.bucket)
        with span("serve/unpad"):
            phi = self._phi[:n].cpu().numpy()
            psi = self._psi[:n].cpu().numpy()
            value = self._v[:n].cpu().numpy() if self._has_prices else None
        return phi, psi, value


class ResidentParams:
    """A policy's params as one engine serves them: the tier's per-date params
    on ``device`` (``p1``, ``p2``) and, once a mixed-date batch needed them,
    the mixed-date kernel's dequantized and packed params (``mixed``), and
    the AOT sets loaded for them (``aot``: ``{(aot_dir, policy fingerprint, mesh size):
    {bucket: AotExecutable}}``, the graphs captured on these params at this
    tier; a set that fell back to the eager path is not kept).
    Engines built with ``resident=`` share them: no host-to-device copy, no
    repacking, no graph capture."""

    __slots__ = ("tier", "device", "p1", "p2", "mixed", "aot")

    def __init__(self, backward, model, tier: str, device: torch.device):
        self.tier, self.device = tier, device
        self.p1 = prepare_params(backward.params1_by_date, tier, model_dtype=model.dtype,
                                 device=device)
        p2 = prepare_params(backward.params2_by_date, tier, model_dtype=model.dtype,
                            device=device)
        self.p2 = self.p1 if p2 is None else p2
        self.mixed = None
        self.aot: dict = {}


class HedgeEngine:
    """Evaluate a hedge policy (a ``PolicyBundle`` or a result carrying its
    model) for arbitrary request sizes on one device.

    ``hits``/``misses`` count bucket reuse: a miss is the first request that
    lands in a bucket. ``precision`` is the serving tier (``"f32"``, ``"bf16"``,
    ``"int8"`` or a ``PrecisionPolicy``). ``mesh``: serve over a paths mesh
    (module docstring); every rank of the mesh makes the same calls.
    ``resident``: a :class:`ResidentParams` of this policy to serve from
    (used when its tier and device are this engine's, else built anew);
    ``engine.resident`` is the engine's own. ``use_aot`` and
    ``aot_failure_threshold``: the AOT set of the policy's bundle (module
    docstring)."""

    def __init__(self, policy, *, min_bucket: int = 8, max_bucket: int = 1 << 20,
                 use_aot: bool = True, aot_failure_threshold: int = 3, device=None,
                 precision="f32", mesh=None, resident=None):
        model = getattr(policy, "model", None)
        if model is None:
            raise ValueError("policy carries no model — pass a PolicyBundle")
        bw = policy.backward
        if bw.params1_by_date is None:
            raise ValueError("policy has no per-date params to serve")
        self.mesh = as_mesh(mesh, device)
        self.device = mesh_device(self.mesh) if self.mesh is not None else resolve_device(device)
        # rank 0's channel to the mirroring ranks of its mesh (MeshChannel), or None
        self.front = None
        full_f32()
        self.model = model
        self.dual_mode = policy.dual_mode
        self.holdings_combine = policy.holdings_combine
        self.cost_of_capital = float(policy.cost_of_capital)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        # the tier's params, on the device once; every request indexes into them
        self.precision = normalize_precision(precision)
        tier = self.precision.tier
        if resident is None or resident.tier != tier or resident.device != self.device:
            resident = ResidentParams(bw, model, tier, self.device)
        self.resident = resident
        self._p1, self._p2 = resident.p1, resident.p2
        self.n_dates = int(self._p1["b0"].shape[0])
        # price legs per row: risky legs then bond
        self.n_instruments = 2 if model.constrain_self_financing else model.n_outputs
        # host rows are padded in the model's dtype and cast to the tier's on the device
        self._np_dt = np.dtype(str(model.dtype).removeprefix("torch."))
        self._mixed = None  # the mixed-date kernel's params (``resident.mixed``), on first use
        self.hits = 0
        self.misses = 0
        self.aot_hits = 0
        self._buckets: set[int] = set()
        self._mixed_buckets: set[int] = set()
        # AOT failures and the watchdog's hang streaks demote a bucket to the eager path
        self._breaker = CircuitBreaker(aot_failure_threshold, what="aot_bucket")
        self._aot: dict = {}
        aot_dir = getattr(policy, "aot_dir", None)
        if use_aot and aot_dir is not None:
            fingerprint = getattr(policy, "fingerprint", None)
            key = (str(aot_dir), fingerprint, mesh_size(self.mesh))
            aot = resident.aot.get(key)
            if aot is None:
                from orp_tpu_torch.aot.bundle_exec import load_aot

                aot = load_aot(aot_dir, policy_fingerprint=fingerprint, mesh=self.mesh,
                               precision=tier, engine=self) or {}
                if aot:  # a fallback is not kept: the next engine checks (and warns) again
                    resident.aot[key] = aot
            # this engine's own view: a demotion leaves the shared set whole
            self._aot = dict(aot)
        # the build and capture baseline of cache_info's nvcc_runs / graph_captures
        self._builds0 = dict(cuda_build.BUILD_STATS)

    def bucket_for(self, n_rows: int) -> int:
        """The padded size requests of ``n_rows`` dispatch at: the next power of
        two (floored at ``min_bucket``), then up to a multiple of the mesh size
        so every shard is equal."""
        b = pad_to_mesh(next_bucket(n_rows, min_bucket=self.min_bucket), self.mesh)
        if b > self.max_bucket:
            raise ValueError(f"batch of {n_rows} rows exceeds max_bucket={self.max_bucket}; "
                             "split the request (or raise max_bucket)")
        return b

    def _check_rows(self, states, prices):
        states = np.asarray(states)
        if states.ndim == 1:
            states = states[None, :]
        n, f = states.shape
        if f != self.model.n_features:
            raise ValueError(f"states have {f} features; this policy was trained on "
                             f"{self.model.n_features}")
        if prices is not None:
            prices = np.asarray(prices)
            if prices.ndim == 1:
                prices = prices[None, :]
            if prices.shape != (n, self.n_instruments):
                raise ValueError(f"prices shape {prices.shape} != {(n, self.n_instruments)} "
                                 "(risky legs then bond, one row per state)")
        return states, prices, n

    def _pad(self, states, prices, n: int, b: int):
        """The request padded to ``b`` rows, on the device: all of them, or
        under a mesh this rank's contiguous shard."""
        feats = np.zeros((b, states.shape[1]), self._np_dt)
        feats[:n] = states
        pr = np.zeros((b, self.n_instruments), self._np_dt)
        if prices is not None:
            pr[:n] = prices
        rows = shard_rows(b, self.mesh, "bucket")
        return (torch.from_numpy(feats[rows]).to(self.device),
                torch.from_numpy(pr[rows]).to(self.device))

    def _gather(self, phi, psi, v):
        """Every rank's shard of the outputs, in row order, on every rank (one
        ``all_reduce`` of the packed columns); the outputs as they are without
        a mesh."""
        if self.mesh is None:
            return phi, psi, v
        rows = phi.shape[0]
        packed = torch.cat([phi.reshape(rows, -1), psi[:, None], v[:, None]], dim=1)
        full = path_gather(packed, self.mesh)
        return (full[:, :-2].reshape(-1, *phi.shape[1:]), full[:, -2], full[:, -1])

    def _count(self, seen: set, b: int, n: int, *, mixed: bool = False,
               aot: bool = False) -> None:
        """The bucket's hit or miss and the request's counters: per-request
        ones registry-only, the rare miss (once a bucket) an event. The first
        touch of an AOT bucket is a hit (``serve/bucket_aot_warm``): its graph
        came with the bundle."""
        if b in seen:
            self.hits += 1
            obs_count("serve/bucket_hits", sink_event=False)
        elif aot:
            self.hits += 1
            seen.add(b)
            obs_count("serve/bucket_aot_warm", bucket=str(b))
        else:
            self.misses += 1
            seen.add(b)
            obs_count("serve/bucket_misses", bucket=str(b), **({"mixed": "1"} if mixed else {}))
        obs_count("serve/rows", n, sink_event=False)
        if mixed:
            obs_count("serve/megakernel_dispatches", sink_event=False)
        if b > n:
            obs_count("serve/pad_waste_rows", b - n, sink_event=False)

    @staticmethod
    def _pending(phi, psi, v, n: int, has_prices: bool, b: int) -> PendingEval:
        """The launched evaluation, with the launch instant under attribution."""
        prof = _devprof.active()
        if prof is None:
            return PendingEval(phi, psi, v, n, has_prices, b)
        return PendingEval(phi, psi, v, n, has_prices, b, prof, time.perf_counter())

    @staticmethod
    def _empty(has_prices: bool) -> PendingEval:
        z = torch.zeros(0, dtype=torch.float32)
        return PendingEval(z, z, z, 0, has_prices, 0)

    def evaluate(self, date_idx: int, states, prices=None):
        """``(phi, psi, value)`` host arrays for ``states (n, n_features)`` at
        rebalance date ``date_idx`` (negative counts from the end)."""
        return self.evaluate_async(date_idx, states, prices).result()

    def evaluate_async(self, date_idx: int, states, prices=None) -> PendingEval:
        """Validate, pad and launch without waiting for the device."""
        states, prices, n = self._check_rows(states, prices)
        idx = int(date_idx)
        if not -self.n_dates <= idx < self.n_dates:
            raise IndexError(f"date_idx {date_idx} out of range for {self.n_dates} dates")
        idx %= self.n_dates
        if n == 0:
            return self._empty(prices is not None)
        b = self.bucket_for(n)
        with span("serve/pad"):
            feats, pr = self._pad(states, prices, n, b)
        inj = _inject.active()
        aot_ex = self._aot.get(b)
        with span("serve/dispatch", attrs={"bucket": b, "aot": aot_ex is not None}):
            if inj is not None:
                # may sleep and/or raise a TransientDispatchError, which the
                # batcher's retry-with-backoff policy handles
                inj.fire("serve/dispatch", bucket=b)
            with self._lockstep(idx, states, prices):
                if aot_ex is not None:
                    local = self._dispatch_aot(aot_ex, b, idx, feats, pr, inj)
                else:
                    local = self._eager_eval(idx, feats, pr)
                phi, psi, v = self._gather(*local)
        self._count(self._buckets, b, n, aot=aot_ex is not None)
        return self._pending(phi, psi, v, n, prices is not None, b)

    @contextlib.contextmanager
    def _lockstep(self, idx: int, states, prices):
        """On the front of a mirrored mesh (``front`` a :class:`MeshChannel`),
        broadcast this dispatch to the other ranks and hold the channel until
        the gather is done; a no-op otherwise. It runs after validation and the
        dispatch fault site, so a request refused or failed there never reaches
        the other ranks, who would wait in its gather."""
        chan = self.front
        if chan is None:
            yield
            return
        with chan.lock:
            if chan.retired:
                raise DeviceLostError(
                    "the mesh this engine served was rebuilt after a device loss; the "
                    "request replays on the rebuilt engine")
            n, f = states.shape
            k = 0 if prices is None else prices.shape[1]
            rows = [states.reshape(-1)] + ([] if prices is None else [prices.reshape(-1)])
            chan.send(DISPATCH, (idx, n, f, k),
                      torch.from_numpy(np.concatenate(rows).astype(np.float64)))
            yield

    def _eager_eval(self, idx: int, feats, pr):
        """The always-correct eager path: the tiled forward of this rank's rows,
        op by op (the caller gathers a mesh's shards)."""
        return _eval_tiled(
            self.model, self._p1, self._p2, idx, feats, pr, self.cost_of_capital,
            dual_mode=self.dual_mode, holdings_combine=self.holdings_combine,
            precision=self.precision.tier)

    def _dispatch_aot(self, aot_ex, b: int, idx: int, feats, pr, inj):
        """Replay bucket ``b``'s graph of this rank's rows (the caller gathers a
        mesh's shards, outside the graph); any failure serves this request
        eagerly (the same forward, the same bits) and feeds the circuit
        breaker, which after ``aot_failure_threshold`` failures in a row
        demotes the bucket to the eager path for the process's lifetime
        (``guard/circuit_open``)."""
        try:
            if inj is not None:
                inj.fire("serve/aot_dispatch", bucket=b)
            out = aot_ex.call(idx, feats, pr)
        except Exception as e:  # noqa: BLE001 — counted, breakered, served eagerly
            obs_count("guard/aot_exec_failure", bucket=str(b))
            if self._breaker.record_failure(b):
                self._aot.pop(b, None)
                warnings.warn(f"AOT graph for bucket {b} failed {self._breaker.threshold} "
                              f"consecutive times ({type(e).__name__}: {e}); circuit opened — "
                              "bucket demoted to the eager path for this process", stacklevel=3)
            return self._eager_eval(idx, feats, pr)
        self.aot_hits += 1
        self._breaker.record_success(b)
        return out

    def evaluate_mixed_async(self, dates, states, prices=None) -> PendingEval:
        """One date index per ROW; the whole block runs through the mixed-date
        kernel in one launch per param set (two for dual policies). A mesh
        engine refuses: it keeps the per-date path, as in the JAX package."""
        if self.mesh is not None:
            raise ValueError(
                "mixed-date megakernel serves single-device engines; "
                "mesh engines keep the per-date bucketed path")
        states, prices, n = self._check_rows(states, prices)
        dates = np.asarray(dates).reshape(-1)
        if dates.shape[0] != n:
            raise ValueError(f"dates has {dates.shape[0]} entries for {n} rows "
                             "(one rebalance-date index per row)")
        if n and not ((-self.n_dates <= dates) & (dates < self.n_dates)).all():
            raise IndexError(f"date indices out of range for {self.n_dates} dates")
        if n == 0:
            return self._empty(prices is not None)
        dates = (dates.astype(np.int64) % self.n_dates).astype(np.int32)
        b = self.bucket_for(n)
        with span("serve/pad"):
            feats, pr = self._pad(states, prices, n, b)
            dcol = np.zeros(b, np.int32)
            dcol[:n] = dates  # padded rows use date 0 and are sliced off
            dcol = torch.from_numpy(dcol).to(self.device)
        inj = _inject.active()
        with span("serve/dispatch", attrs={"bucket": b, "mixed": True}):
            if inj is not None:
                inj.fire("serve/dispatch", bucket=b, mixed=True)
            p1, p2, packed1, packed2 = self._mixed_params()
            phi, psi, v = _eval_core_mixed(
                self.model, p1, p2, dcol, feats, pr, self.cost_of_capital,
                dual_mode=self.dual_mode, holdings_combine=self.holdings_combine,
                precision=self.precision.tier, packed1=packed1, packed2=packed2)
        self._count(self._mixed_buckets, b, n, mixed=True)
        return self._pending(phi, psi, v, n, prices is not None, b)

    def _mixed_params(self):
        """``(p1, p2, packed1, packed2)`` for the mixed-date kernel, built once.

        int8 weights are dequantized here, once: the same elementwise ``q *
        scale`` as per request, so the same bits (``_eval_core_mixed``'s own
        dequantization then passes them through). On the card the params are
        also packed in the tier's dtype (``packed`` None on the CPU)."""
        if self._mixed is not None:
            return self._mixed
        res = self.resident
        if res.mixed is None:
            p1, p2 = self._p1, self._p2
            if self.precision.tier == "int8":
                p1 = dequantize_params(p1)
                p2 = p1 if self._p2 is self._p1 else dequantize_params(p2)
            packed1 = packed2 = None
            if self.device.type == "cuda":
                m = eval_model(self.model, self.precision.tier)
                check_head_shape(m, self.n_dates, m.dtype)
                packed1 = pack_head_params(m, p1)
                packed2 = packed1 if p2 is p1 else pack_head_params(m, p2)
            res.mixed = (p1, p2, packed1, packed2)
        self._mixed = res.mixed
        return self._mixed

    def watchdog_trip(self, bucket) -> None:
        """The stuck-dispatch watchdog (``serve/health.py``) force-failed a
        hung batch in ``bucket``: count it (``guard/aot_exec_failure{kind=
        "hang"}``) on the engine's circuit breaker under its own streak key
        ``hang:<bucket>`` (a hang surfaces after a successful dispatch, so a
        dispatch success must not reset it); after ``aot_failure_threshold``
        hangs in a row the circuit opens (``guard/circuit_open``) and an AOT
        bucket is demoted to the eager path, as in the JAX package (an eager
        bucket has nothing to demote)."""
        obs_count("guard/aot_exec_failure", bucket=str(bucket), kind="hang")
        if self._breaker.record_failure(f"hang:{bucket}"):
            self._aot.pop(bucket, None)
            warnings.warn(f"bucket {bucket} exceeded the dispatch hard wall "
                          f"{self._breaker.threshold} consecutive times; circuit opened — "
                          "bucket demoted to the eager path for this process", stacklevel=3)

    def watchdog_ok(self, bucket) -> None:
        """The watchdog saw ``bucket``'s batch complete inside the wall: break
        its hang streak (flakes never accumulate into an open circuit)."""
        self._breaker.record_success(f"hang:{bucket}")

    def prewarm(self, sizes) -> dict:
        """Evaluate one request in the bucket of each of ``sizes`` (deduplicated
        by bucket, at the requested row count), so no live request of those
        sizes is a bucket's first touch. Returns :meth:`cache_info`."""
        by_bucket = {}
        for n in sizes:
            by_bucket.setdefault(self.bucket_for(int(n)), int(n))
        for _, n in sorted(by_bucket.items()):
            self.evaluate(0, np.ones((n, self.model.n_features), self._np_dt))
        return self.cache_info()

    def cache_info(self) -> dict:
        """Bucket counters, the AOT set's (``aot_buckets`` still served by
        graphs, ``aot_hits``, ``aot_circuit_open``), and the port's
        counterparts of the JAX package's ``xla_compiles``: ``nvcc_runs`` and
        ``graph_captures``, the ``nvcc`` runs and CUDA-graph captures of this
        process since the engine was built (``cuda_build.BUILD_STATS`` is
        process-wide, so another engine's traffic in between counts too)."""
        now = cuda_build.BUILD_STATS
        return {"hits": self.hits, "misses": self.misses,
                "precision": self.precision.tier,
                "mesh_devices": mesh_size(self.mesh),
                "buckets": sorted(self._buckets),
                "mixed_buckets": sorted(self._mixed_buckets),
                "aot_buckets": sorted(self._aot),
                "aot_hits": self.aot_hits,
                "aot_circuit_open": self._breaker.open_keys,
                "nvcc_runs": now["nvcc"] - self._builds0["nvcc"],
                "graph_captures": now["captures"] - self._builds0["captures"]}

    def program_cost(self, n_rows: int) -> dict:
        """The analytic FLOPs and bytes of the bucket serving ``n_rows``-row
        requests (``aot/compile.cost_summary``: one forward per param set),
        the numerator of the roofline join (``obs/perf.py``)."""
        from orp_tpu_torch.aot.compile import cost_summary

        b = self.bucket_for(n_rows)
        return {"bucket": b, **cost_summary(
            self.model, b, n_heads=1 if self.dual_mode == "mse_only" else 2,
            precision=self.precision.tier)}
