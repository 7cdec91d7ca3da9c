"""Continuous batching: keep the device busy while requests keep arriving
(counterpart of ``orp_tpu/serve/batcher.py``).

One device launch per one-row request lets launch overhead dominate. This
module is the continuous-batching dispatch loop instead, riding the card's
asynchronous launches (a launch returns before the work is done):

- **admit**    - drain everything pending into the largest batch that fits
  (``max_batch`` rows), grouped so rows that can share a dispatch ride one;
  requests that aged past their deadline are shed here, never dispatched.
- **dispatch** - launch the batch WITHOUT waiting
  (``HedgeEngine.evaluate_async``): the card's stream owns it now.
- **overlap**  - while that batch runs, loop straight back to admit:
  requests that arrived in the meantime form the next batch, which is
  launched too (double-buffered: up to ``max_inflight`` batches queued on
  the stream, so the card never waits on Python).
- **resolve**  - wait for the OLDEST in-flight batch (its result copy), slice
  each request's rows back out, and resolve every future in bulk OUTSIDE the
  lock (a done-callback that re-enters the batcher must never deadlock on
  the held Condition).

One worker thread dispatches and resolves, so every launch and every wait
of a batcher sits on that thread's current stream (the default stream unless
the caller's engine says otherwise), in launch order.

Correctness contract: every request gets exactly the rows it submitted, in
the order it submitted them, bitwise-equal to a solo ``engine.evaluate`` of
the same rows (the per-date forward runs in fixed row tiles and the
mixed-date kernel computes each row on its own, so no result depends on the
bucket it rode in) - the batcher changes latency/throughput, never results.
A failed dispatch propagates the exception to every future in that group
(not to unrelated groups).

Resilience (``orp_tpu_torch/guard``, opt-in via a :class:`GuardPolicy`):

- every request's QUEUE AGE lands in ``serve/queue_age_seconds{outcome}``;
- per-request DEADLINES: a request whose queue age passes its deadline is
  shed with a structured :class:`Rejection` through its future
  (``guard/shed{reason="deadline"}``), never served late;
- ADMISSION CONTROL: past ``queue_watermark`` pending ROWS, the
  earliest-deadline (then oldest) request is shed at submit time
  (``guard/shed{reason="watermark"}``); an over-watermark block sheds its
  own TAIL rows as a slice instead;
- RETRIES of a dispatch that raised :class:`TransientDispatchError`, with
  bounded exponential backoff (``guard/retry``); the backoff waits on an
  Event the close path sets, not ``time.sleep``, so it is interruptible;
- the stuck-dispatch WATCHDOG (``GuardPolicy.hard_wall_ms``,
  ``serve/health.py``).

Without a policy none of this runs; the per-request obs calls are the
usual disabled-mode no-ops.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
# distinct from builtin TimeoutError on Python <= 3.10, an alias after —
# raising THIS keeps every `except concurrent.futures.TimeoutError` a
# stdlib-Future client already wrote working against SlimFuture
from concurrent.futures import TimeoutError as _FutureTimeoutError

import numpy as np

from orp_tpu_torch.guard.serve import GuardPolicy, Rejection, TransientDispatchError
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight
from orp_tpu_torch.obs import observe as obs_observe
from orp_tpu_torch.obs import span
from orp_tpu_torch.serve.ingest import (SHED_DEADLINE, SHED_WATERMARK, Block,
                                  as_deadline_column)
from orp_tpu_torch.serve.metrics import ServingMetrics

_PENDING, _DONE, _FAILED = 0, 1, 2


class SlimFuture:
    """The per-request future, slimmed to what a serve tier needs.

    ``concurrent.futures.Future`` costs ~6µs to CONSTRUCT (a fresh
    Condition — two lock allocations — per instance) and ~1µs to resolve;
    at 10^5 requests/s that alone is more than half the Python budget.
    This class carries the used subset of the contract — ``result([
    timeout])``, ``exception()``, ``done()``, ``add_done_callback``,
    ``set_result``/``set_exception``, ``set_running_or_notify_cancel``
    (always True: a submitted request is never cancellable, its rows may
    already ride an in-flight dispatch) — over one CLASS-LEVEL lock and a
    lazily-allocated per-waiter Event, so the common open-loop shape
    (submit a stream, gather at the end, most futures already resolved)
    pays ~0.3µs per request.

    The shared lock is held only for state handoff (never while running
    callbacks or waiting), so resolutions on the dispatch-loop thread and
    waits on client threads contend for nanoseconds, not milliseconds.
    """

    __slots__ = ("_state", "_value", "_event", "_cbs")
    _lock = threading.Lock()  # class-level: state handoff only

    def __init__(self):
        self._state = _PENDING
        self._value = None
        self._event = None
        self._cbs = None

    def _resolve(self, state, value) -> None:
        with SlimFuture._lock:
            if self._state != _PENDING:
                raise RuntimeError("future already resolved")
            self._value = value
            self._state = state
            ev = self._event
            cbs = self._cbs
            self._cbs = None
        if ev is not None:
            ev.set()
        if cbs:
            for cb in cbs:
                cb(self)

    def set_result(self, value) -> None:
        self._resolve(_DONE, value)

    def set_exception(self, exc: BaseException) -> None:
        self._resolve(_FAILED, exc)

    def set_running_or_notify_cancel(self) -> bool:
        return True

    def done(self) -> bool:
        return self._state != _PENDING

    def add_done_callback(self, fn) -> None:
        run_now = False
        with SlimFuture._lock:
            if self._state != _PENDING:
                run_now = True
            elif self._cbs is None:
                self._cbs = [fn]
            else:
                self._cbs.append(fn)
        if run_now:
            fn(self)

    def _wait(self, timeout) -> None:
        with SlimFuture._lock:
            if self._state != _PENDING:
                return
            if self._event is None:
                self._event = threading.Event()
            ev = self._event
        if not ev.wait(timeout):
            raise _FutureTimeoutError("request not resolved within timeout")

    def result(self, timeout: float | None = None):
        if self._state == _PENDING:
            self._wait(timeout)
        if self._state == _FAILED:
            raise self._value
        return self._value

    def exception(self, timeout: float | None = None):
        if self._state == _PENDING:
            self._wait(timeout)
        return self._value if self._state == _FAILED else None


class _Request:
    __slots__ = ("date_idx", "features", "prices", "future", "submitted_at",
                 "deadline", "rows")

    def __init__(self, date_idx: int, features, prices, future: SlimFuture,
                 submitted_at: float, deadline: float | None):
        self.date_idx = date_idx
        self.features = features      # (rows, n_features)
        self.prices = prices          # (rows, k) or None
        self.future = future
        self.submitted_at = submitted_at
        self.deadline = deadline      # absolute perf_counter instant; None = never
        self.rows = features.shape[0]  # hoisted off the admit hot loop


@dataclasses.dataclass
class _Group:
    """One executable-sharing slice of an admitted batch: the requests whose
    concatenated rows ride one engine dispatch, plus that dispatch's outcome
    (a ``PendingEval``-shaped handle, or the exception that must be
    delivered to every future in the group at resolve time). The
    concatenated inputs are kept until resolution so a transient failure
    that only surfaces at BLOCK time can be re-dispatched under the same
    retry policy a dispatch-time failure gets."""

    reqs: list
    has_prices: bool
    rows: int
    date_idx: int = 0
    feats: object = None
    prices: object = None
    pending: object = None        # engine handle with .result()
    error: Exception | None = None
    # mixed-date lane (megakernel): per-row int32 date column when the
    # group spans dates — the block-time retry must re-dispatch through
    # the same fused path, so the column is kept alongside feats/prices
    dates: object = None
    # columnar lane: a LONE Block rides its OWN group (its rows are already
    # one contiguous device-shaped batch — zero concatenates clean-path) and
    # resolves through its single future with the per-row status column
    block: Block | None = None
    # cross-connection coalescing: SEVERAL blocks sharing an executable key
    # (same date, width, prices-presence) merge into ONE device dispatch —
    # many small connections of one tenant fill one launch (each tenant
    # owns its batcher, so the merge is per-tenant by construction) —
    # with per-origin live-row counts so each connection's reply columns
    # slice back out bitwise what its own dispatch would have served
    blocks: list | None = None
    block_lives: list | None = None


def _shed_order(req: _Request) -> tuple:
    """Watermark victim selection: earliest deadline first (the request
    most likely to expire unserved anyway), oldest submission as the
    tie-break / no-deadline fallback."""
    return (req.deadline if req.deadline is not None else float("inf"),
            req.submitted_at)


class MicroBatcher:
    """Async continuous-batching front of a ``HedgeEngine``.

    ``max_batch`` caps coalesced rows per dispatch; ``max_wait_us`` caps how
    long the first request of a batch waits for company WHEN THE DEVICE IS
    IDLE — once a batch is in flight, its execution time is the coalescing
    window (requests arriving meanwhile ride the next dispatch for free).
    ``max_inflight`` bounds how many dispatched batches may be queued on
    the device at once (2 = classic double buffering: one executing, one
    queued, the host free to admit a third).

    ``policy`` (optional :class:`~orp_tpu_torch.guard.GuardPolicy`) switches on
    deadlines, watermark shedding and transient-dispatch retries — see the
    module docstring. With a deadline in force, a future may resolve to a
    :class:`~orp_tpu_torch.guard.Rejection` instead of ``(phi, psi, value)``;
    check ``guard.is_rejection(result)`` before unpacking.

    ``ragged=True`` (optionally with a shared ``planner``) turns on
    pad-waste-aware dispatch planning (:mod:`orp_tpu_torch.serve.ragged`);
    ``mixed_dates=True`` fuses requests at different rebalance dates into
    one megakernel dispatch (:mod:`orp_tpu_torch.serve.megakernel`); with
    ``coalesce_blocks`` it fuses admitted blocks at different dates the same
    way (the gateway's single-row frames from many connections), while blocks
    that share one date keep the bitwise per-date path. Both are opt-in:
    default-off keeps the per-date always-merge dispatch shape existing tests
    and benches pin.

    The worker thread pins its current CUDA device to the engine's (the
    current device is per thread), so engines on ``cuda:N`` launch there.
    """

    def __init__(self, engine, *, max_batch: int = 1024,
                 max_wait_us: float = 200.0,
                 metrics: ServingMetrics | None = None,
                 policy: GuardPolicy | None = None,
                 max_inflight: int = 2,
                 min_fill: int | None = None,
                 coalesce_blocks: bool = True,
                 ragged: bool = False,
                 planner=None,
                 mixed_dates: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_inflight < 1:
            raise ValueError(f"max_inflight={max_inflight} must be >= 1")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.max_inflight = int(max_inflight)
        # busy-device admission threshold: while a batch is in flight,
        # don't dispatch another until this many requests are pending —
        # resolving the in-flight batch first lets arrivals accumulate into
        # a fuller bucket (each dispatch has a fixed launch cost; under
        # sustained load eager tiny batches burn it per handful of rows).
        # Never delays an idle device: with nothing in flight the
        # max_wait_us window is the only batching wait.
        self.min_fill = (max(1, self.max_batch // 8) if min_fill is None
                         else int(min_fill))
        # cross-connection block coalescing: admitted blocks sharing one
        # executable key (date, width, prices-presence) concatenate into ONE
        # device dispatch — many small connections of one tenant fill one
        # launch instead of paying one per connection (each tenant owns its
        # batcher, so the merge is per-tenant by construction). Per-origin
        # row-slice bookkeeping makes each block's reply bitwise what its
        # own dispatch serves (the forward is per-row); `False` keeps the
        # one-block-one-dispatch shape (the A/B the fleet bench pins bits
        # against).
        self.coalesce_blocks = bool(coalesce_blocks)
        # ragged batching (serve/ragged.py), opt-in: a pad-waste-aware
        # BucketPlanner partitions coalesced blocks into dispatch groups
        # (merge vs keep-separate) and shatters an over-padded batch into
        # exact-bucket chunks when its cost model says the extra launches
        # undercut the padding. `False` keeps the always-merge pow2 shape
        # (the A/B the ragged bench phase pins against). Pass `planner`
        # to share a profile-fed instance; `ragged=True` alone builds a
        # proxy-cost default.
        self.planner = planner
        if ragged and self.planner is None:
            from orp_tpu_torch.serve.ragged import BucketPlanner

            self.planner = BucketPlanner()
        # mixed-date lane (serve/megakernel.py), opt-in: per-request
        # admission stops keying groups on date_idx — rows at DIFFERENT
        # rebalance dates concatenate into one fused megakernel dispatch
        # (engine.evaluate_mixed_async) instead of one launch per date.
        # Default False: the per-date grouping is the shape the existing
        # dispatch-count pins are written against,
        # and the fused path needs a single-device engine.
        self.mixed_dates = bool(mixed_dates)
        self.metrics = metrics
        self.policy = policy
        # stuck-dispatch watchdog (serve/health.py), opt-in via the policy's
        # hard_wall_ms: bounds the resolve-stage block and feeds the
        # engine's circuit breaker on a trip; absent -> zero cost
        self._watchdog = None
        if policy is not None and policy.hard_wall_ms is not None:
            from orp_tpu_torch.serve.health import DispatchWatchdog

            self._watchdog = DispatchWatchdog(
                policy.hard_wall_ms,
                on_trip=getattr(engine, "watchdog_trip", None),
                on_ok=getattr(engine, "watchdog_ok", None),
            )
        # one condition guards the deque + closed flag: submit needs to shed
        # arbitrary queued requests under the watermark policy, which a
        # SimpleQueue cannot express
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        # row count of everything queued (requests AND blocks): the columnar
        # lane's watermark unit — shedding whole blocks by request count
        # would make a 1024-row block as cheap as a 1-row request
        self._pending_rows = 0
        self._closed = False
        # set at close(): wakes a retry backoff immediately instead of
        # letting the dispatch loop finish a nap nobody is waiting for
        self._interrupt = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="orp-serve-batcher", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, date_idx: int, states, prices=None, *,
               deadline_s: float | None = None) -> SlimFuture:
        """Enqueue one request; the future resolves to ``(phi, psi, value)``
        for exactly these rows (``value`` None when ``prices`` is None) —
        or to a :class:`Rejection` when a guard policy shed it.

        ``deadline_s``: queue-age budget for THIS request (seconds from
        now), overriding the policy default. Ignored without a policy.
        """
        # promote scalars/rows to (rows, width) HERE: the worker indexes
        # .shape[0]/.shape[1] before any try block, so a lower-rank array
        # reaching it would kill the thread (and every pending future)
        feats = np.atleast_2d(np.asarray(states))
        pr = None if prices is None else np.atleast_2d(np.asarray(prices))
        fut = SlimFuture()
        now = time.perf_counter()
        budget = deadline_s
        if budget is None and self.policy is not None:
            budget = (None if self.policy.deadline_ms is None
                      else self.policy.deadline_ms / 1e3)
        req = _Request(int(date_idx), feats, pr, fut, now,
                       None if (budget is None or self.policy is None)
                       else now + budget)
        shed: list[_Request] = []
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append(req)
            self._pending_rows += req.rows
            wm = None if self.policy is None else self.policy.queue_watermark
            # the watermark is ROW-counted on both lanes (one unit, one
            # meaning — a 1024-row block is 1024 rows of backlog, not one
            # entry): keep the queued rows at the watermark by shedding the
            # earliest-deadline request (possibly the one just submitted) —
            # a structured decision, not an error. Queued BLOCKS are not
            # victims: the columnar lane sheds by tail-slice at its own
            # admission edge (submit_block), never by growing a per-row
            # Rejection out of a queued column
            while wm is not None and self._pending_rows > wm:
                victim = min(
                    (r for r in self._pending if not isinstance(r, Block)),
                    key=_shed_order, default=None)
                if victim is None:
                    break
                self._pending.remove(victim)
                self._pending_rows -= victim.rows
                shed.append(victim)
            if len(self._pending) == 1:
                # notify only on the empty->nonempty edge: a worker in its
                # coalescing window picks up company at the window end
                # anyway, and per-submit notifies are measurable at 10^5/s
                self._cv.notify()
        for victim in shed:
            # resolved OUTSIDE the lock: set_result runs the future's
            # done-callbacks synchronously, and a callback that re-enters
            # the batcher (submit-on-reject is a natural client shape)
            # would deadlock on the held Condition
            self._shed(victim, "watermark")
        return fut

    def submit_block(self, date_idx: int, states, prices=None,
                     deadlines=None, *, trace=None) -> SlimFuture:
        """Columnar ingest lane: admit N rows for ONE date under one lock
        pass with ONE future for the whole block. The future resolves to a
        :class:`~orp_tpu_torch.serve.ingest.BlockResult` — contiguous ``phi``/
        ``psi``/``value`` columns plus a per-row ``status`` column — whose
        served rows are BITWISE what N per-request ``submit`` calls of the
        same rows return (the forward is per-row; only the Python admission
        cost changes).

        ``states``: ``(n, n_features)`` feature rows (C-contiguous is the
        zero-copy path). ``prices``: optional ``(n, k)``. ``deadlines``:
        per-row queue-age budgets in seconds — an ``(n,)`` column, a scalar
        for every row, or None for the policy default. Like the per-request
        lane, deadlines/watermark only act under a :class:`GuardPolicy`;
        guard decisions come back through the STATUS column (deadline
        expiry = one mask compare at admit; watermark = the tail rows past
        the row-counted watermark shed as a slice at submit), never as
        per-row ``Rejection`` objects.

        ``trace``: an optional ``(trace_id, parent_span)`` distributed-trace
        context (``obs.new_trace()`` / a decoded frame's stamp). A traced
        block's admit/dispatch/device instants become ``trace/queue`` /
        ``trace/dispatch`` / ``trace/resolve`` span events under that
        trace_id, and its :class:`~orp_tpu_torch.serve.ingest.BlockResult` carries
        the ``(queue_age_s, dispatch_s)`` server-timing pair. ``None`` (the
        default) costs one ``is not None`` test per block — the zero-cost
        discipline, block-amortized.
        """
        feats = np.atleast_2d(np.ascontiguousarray(states))
        n = feats.shape[0]
        if n < 1 or feats.ndim != 2:
            raise ValueError(
                f"block of shape {np.shape(states)}: submit_block takes a "
                "non-empty (rows, n_features) feature matrix")
        pr = None
        if prices is not None:
            pr = np.atleast_2d(np.ascontiguousarray(prices))
            if pr.shape[0] != n:
                raise ValueError(
                    f"prices column has {pr.shape[0]} rows, features {n} — "
                    "a block is one row set")
        now = time.perf_counter()
        dl = None
        if self.policy is not None:
            default = (None if self.policy.deadline_ms is None
                       else self.policy.deadline_ms / 1e3)
            dl = as_deadline_column(deadlines, n, now, default)
        blk = Block(int(date_idx), feats, pr, SlimFuture(), now, dl,
                    trace=trace)
        n_wm = 0
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            wm = None if self.policy is None else self.policy.queue_watermark
            if wm is not None and self._pending_rows + n > wm:
                # row-counted admission control, vectorized: strike the TAIL
                # rows past the watermark in one slice — never grow per-row
                # objects out of an overload decision
                n_wm = blk.shed_tail(max(0, wm - self._pending_rows),
                                     SHED_WATERMARK)
            live = blk.n_live
            if live:
                self._pending.append(blk)
                self._pending_rows += live
                if len(self._pending) == 1:
                    self._cv.notify()
        # signals + resolution OUTSIDE the lock (the per-request shed rule)
        blk.emit_shed(SHED_WATERMARK, n_wm)
        if not live:
            blk.resolve_shed_only()
        return blk.future

    def evaluate(self, date_idx: int, states, prices=None):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(date_idx, states, prices).result()

    def close(self, timeout: float | None = 10.0) -> None:
        """Drain outstanding requests and stop the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._interrupt.set()
            self._cv.notify_all()
        self._worker.join(timeout)
        if self._watchdog is not None:
            self._watchdog.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- guard decisions -----------------------------------------------------

    def _shed(self, req: _Request, reason: str) -> None:
        """Resolve ``req`` with a structured Rejection + the shed signals."""
        queued = time.perf_counter() - req.submitted_at
        obs_count("guard/shed", reason=reason)
        obs_observe("serve/queue_age_seconds", queued, outcome="shed")
        flight.record("shed", reason=reason, queued_s=round(queued, 6))
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(Rejection(
                reason=reason, queued_s=queued,
                deadline_s=(None if req.deadline is None
                            else req.deadline - req.submitted_at)))

    # -- dispatch loop -------------------------------------------------------
    #
    # admit -> dispatch -> (overlap) -> resolve. The loop never blocks on a
    # device result while there is admission or dispatch work to do, and it
    # never resolves futures under the Condition; _resolve is the one stage
    # whose JOB is to block.

    def _run(self) -> None:
        dev = getattr(self.engine, "device", None)
        if getattr(dev, "type", None) == "cuda" and dev.index is not None:
            import torch

            torch.cuda.set_device(dev)
        inflight: collections.deque[list[_Group]] = collections.deque()
        while True:
            # only block waiting for work when the device has none either —
            # with a batch in flight its execution is the natural window
            batch, expired, closed = self._admit(block=not inflight)
            for req in expired:
                # outside the lock: resolving a future runs its
                # done-callbacks synchronously (see submit's shed note)
                if isinstance(req, Block):
                    # a block every row of which expired: its shed signals
                    # were emitted at admit, only the resolution is left
                    req.resolve_shed_only()
                else:
                    self._shed(req, "deadline")
            if batch:
                inflight.append(self._dispatch(batch))
            if inflight and (not batch or len(inflight) >= self.max_inflight):
                # oldest batch first: FIFO resolution preserves the
                # submission-order contract per request
                self._resolve(inflight.popleft())
                continue
            if closed and not batch and not inflight:
                return

    def _admit(self, block: bool):
        """Drain pending requests into the largest batch that fits
        (``max_batch`` rows): returns ``(batch, expired, closed)``. With
        ``block=True`` waits for the first live request and then holds the
        ``max_wait_us`` coalescing window open for company; with
        ``block=False`` (a batch is already executing) takes whatever is
        there RIGHT NOW and returns — continuous batching's admission
        rule."""
        batch: list[_Request] = []
        expired: list[_Request] = []
        with self._cv:
            if block:
                while not self._pending and not self._closed:
                    self._cv.wait()
            elif len(self._pending) < self.min_fill and not self._closed:
                # device busy + thin queue: let the resolve of the
                # in-flight batch be the wait that fills this one
                return batch, expired, False
            rows = 0
            window_end = None  # opens at the first LIVE request
            while rows < self.max_batch:
                if self._pending:
                    req = self._pending.popleft()
                    now = time.perf_counter()
                    if isinstance(req, Block):
                        # columnar lane: deadline expiry is ONE mask
                        # compare against the float64 deadline column —
                        # expired rows are struck in place, never objects
                        self._pending_rows -= req.n_live
                        n_exp = req.mask_expired(now)
                        req.emit_shed(SHED_DEADLINE, n_exp)
                        live = req.n_live
                        if not live:
                            expired.append(req)
                            continue
                        obs_observe("serve/queue_age_seconds",
                                    now - req.submitted_at, outcome="served")
                        if req.trace is not None:
                            # the queue segment ends here; `now` was read
                            # anyway, so a traced block costs one store
                            req.t_admit = now
                        batch.append(req)
                        rows += live
                        if window_end is None:
                            window_end = now + self.max_wait_us * 1e-6
                        continue
                    self._pending_rows -= req.rows
                    if req.deadline is not None and now > req.deadline:
                        # expired while queued: never burn a device
                        # dispatch on an answer nobody is waiting for
                        expired.append(req)
                        continue
                    obs_observe("serve/queue_age_seconds",
                                now - req.submitted_at, outcome="served")
                    batch.append(req)
                    rows += req.rows
                    if window_end is None:
                        window_end = now + self.max_wait_us * 1e-6
                    continue
                if not batch or not block:
                    break
                remaining = window_end - time.perf_counter()
                if self._closed or remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            return batch, expired, self._closed

    def _dispatch(self, batch: list[_Request]) -> list[_Group]:
        """Group the admitted batch by executable compatibility and submit
        each group to the device WITHOUT blocking. Returns the in-flight
        groups; exceptions are captured per group and delivered at resolve
        time (outside any lock, never poisoning unrelated groups).

        Grouping key: same date, same feature width and same prices
        shape-presence. Width in the key means a malformed request (wrong
        feature count) fails on ITS OWN future with the engine's error
        instead of poisoning the concat of an entire well-formed batch.

        A LONE :class:`~orp_tpu_torch.serve.ingest.Block` rides its OWN group:
        its rows are already one contiguous device-shaped batch (the whole
        point of the columnar lane — zero concatenates on the clean path),
        and its single future resolves with the status column instead of
        per-request slices. SEVERAL admitted blocks sharing one key — the
        fleet's many-small-connections-per-tenant shape — coalesce into
        ONE dispatch (``coalesce_blocks``) with per-origin live-row
        slices, so each connection still gets bitwise its own dispatch's
        columns (per-row forward)."""
        groups: dict[tuple, list[_Request]] = {}
        block_groups: dict[tuple, list[Block]] = {}
        out: list[_Group] = []
        for req in batch:
            if isinstance(req, Block):
                # mixed-date lane: blocks drop the date from the key too
                key = ((None if self.mixed_dates else req.date_idx),
                       req.features.shape[1],
                       None if req.prices is None else req.prices.shape[1])
                block_groups.setdefault(key, []).append(req)
                continue
            # mixed-date lane: drop the date from the key — requests at
            # different rebalance dates fuse into one megakernel dispatch
            key = ((None if self.mixed_dates else req.date_idx),
                   req.features.shape[1],
                   None if req.prices is None else req.prices.shape[1])
            groups.setdefault(key, []).append(req)
        for (date_idx, _, pwidth), blks in block_groups.items():
            if date_idx is None:
                if len({b.date_idx for b in blks}) > 1:
                    # genuinely mixed dates: one fused megakernel dispatch
                    # when coalescing, else one dispatch a block
                    if self.coalesce_blocks:
                        out.append(self._dispatch_coalesced(
                            blks[0].date_idx, pwidth, blks, mixed=True))
                    else:
                        out.extend(self._dispatch_block(b) for b in blks)
                    continue
                date_idx = blks[0].date_idx
            if (len(blks) > 1 and self.coalesce_blocks
                    and self.planner is not None):
                # ragged: the planner's DP picks merge vs keep-separate
                # per run of admitted blocks instead of always-merge; the
                # groups are consecutive in admission order, so every
                # origin's reply still slices out contiguously
                parts = self.planner.plan([b.n_live for b in blks])
                if len(parts) > 1:
                    obs_count("serve/ragged_plans")
                for lo, hi in parts:
                    part = blks[lo:hi]
                    if len(part) == 1:
                        out.append(self._dispatch_block(part[0]))
                    else:
                        out.append(self._dispatch_coalesced(
                            date_idx, pwidth, part))
                continue
            if len(blks) == 1 or not self.coalesce_blocks:
                for blk in blks:
                    out.append(self._dispatch_block(blk))
                continue
            out.append(self._dispatch_coalesced(date_idx, pwidth, blks))
        for (date_idx, _, pwidth), reqs in groups.items():
            has_prices = pwidth is not None
            g = _Group(reqs=reqs, has_prices=has_prices,
                       rows=sum(r.features.shape[0] for r in reqs),
                       date_idx=(reqs[0].date_idx if date_idx is None
                                 else date_idx))
            out.append(g)
            try:
                g.feats = np.concatenate([r.features for r in reqs], axis=0)
                g.prices = (np.concatenate([r.prices for r in reqs], axis=0)
                            if has_prices else None)
                if (date_idx is None
                        and len({r.date_idx for r in reqs}) > 1):
                    # genuinely mixed dates: one fused megakernel dispatch
                    # instead of one launch per distinct date
                    g.dates = np.concatenate(
                        [np.full(r.rows, r.date_idx, np.int32)
                         for r in reqs])
                    g.pending = self._dispatch_engine(
                        g.date_idx, g.feats, g.prices, dates=g.dates)
                else:
                    g.pending = self._dispatch_planned(g.date_idx, g.feats,
                                                       g.prices)
            except Exception as e:  # orp: noqa[ORP009] -- delivered to every future in the group by _resolve
                g.error = e
                continue
            # counters record AFTER the dispatch succeeds: a group whose
            # retries exhaust must not inflate the device-traffic telemetry
            obs_count("serve/batcher_dispatches")
            obs_count("serve/batcher_coalesced_requests", len(reqs))
            if self.metrics is not None:
                cap = (self.engine.bucket_for(g.rows)
                       if hasattr(self.engine, "bucket_for") else
                       self.max_batch)
                self.metrics.record_dispatch(len(reqs), g.rows, cap)
        return out

    def _dispatch_block(self, blk: Block) -> _Group:
        """One block, one dispatch: the block's
        own contiguous columns go to the device with zero concatenates."""
        feats, prices = blk.live_columns()
        g = _Group(reqs=[], has_prices=prices is not None,
                   rows=int(feats.shape[0]), date_idx=blk.date_idx,
                   block=blk)
        try:
            g.feats, g.prices = feats, prices
            g.pending = self._dispatch_planned(g.date_idx, feats, prices)
        except Exception as e:  # orp: noqa[ORP009] -- delivered to the block's future by _resolve
            g.error = e
            return g
        if blk.trace is not None:
            # the dispatch segment ends at device submission
            blk.t_dispatch = time.perf_counter()
        obs_count("serve/batcher_dispatches")
        obs_count("serve/ingest_block_rows", g.rows, sink_event=False)
        if self.metrics is not None:
            cap = (self.engine.bucket_for(g.rows)
                   if hasattr(self.engine, "bucket_for") else
                   self.max_batch)
            self.metrics.record_dispatch(1, g.rows, cap)
        return g

    def _dispatch_coalesced(self, date_idx: int, pwidth, blks, *,
                            mixed: bool = False) -> _Group:
        """Cross-connection coalescing: N admitted blocks with one
        executable key ride ONE device dispatch. The concatenation order is
        admission order, and each block's live-row count is kept so the
        resolve stage slices every origin's columns back out — bitwise what
        a per-block dispatch serves (the forward is per-row, and bucket
        padding rides OUTSIDE the sliced rows). ``mixed``: the blocks' dates
        differ, and their rows ride one mixed-date dispatch with a per-row
        date column (the megakernel lane: bitwise the engine's own
        ``evaluate_mixed_async`` of the rows, not the per-date path's)."""
        has_prices = pwidth is not None
        lives = []
        feat_cols = []
        price_cols = [] if has_prices else None
        for blk in blks:
            f, p = blk.live_columns()
            lives.append(int(f.shape[0]))
            feat_cols.append(f)
            if has_prices:
                price_cols.append(p)
        g = _Group(reqs=[], has_prices=has_prices, rows=sum(lives),
                   date_idx=date_idx, blocks=list(blks), block_lives=lives)
        try:
            g.feats = np.concatenate(feat_cols, axis=0)
            g.prices = (np.concatenate(price_cols, axis=0)
                        if has_prices else None)
            if mixed:
                g.dates = np.concatenate(
                    [np.full(n, blk.date_idx, np.int32)
                     for blk, n in zip(blks, lives)])
                g.pending = self._dispatch_engine(date_idx, g.feats, g.prices,
                                                  dates=g.dates)
            else:
                g.pending = self._dispatch_planned(date_idx, g.feats,
                                                   g.prices)
        except Exception as e:  # orp: noqa[ORP009] -- delivered to every block future by _resolve
            g.error = e
            return g
        now = time.perf_counter()
        for blk in blks:
            if blk.trace is not None:
                blk.t_dispatch = now
        obs_count("serve/batcher_dispatches")
        obs_count("serve/batcher_coalesced_blocks", len(blks))
        obs_count("serve/ingest_block_rows", g.rows, sink_event=False)
        if self.metrics is not None:
            cap = (self.engine.bucket_for(g.rows)
                   if hasattr(self.engine, "bucket_for") else
                   self.max_batch)
            self.metrics.record_dispatch(len(blks), g.rows, cap)
        return g

    def _dispatch_engine(self, date_idx: int, feats, pr, dates=None):
        """One non-blocking engine dispatch, with the policy's bounded
        retry-with-backoff for transient failures (a deterministic error
        propagates on attempt one — retrying it only repeats it with
        latency). The backoff waits on the close-interrupt Event, not
        ``time.sleep``: bounded, small by policy, and breakable.
        ``dates`` (per-row int32 column) routes through the fused
        mixed-date megakernel lane instead of the single-date bucket."""
        if dates is not None:
            submit = lambda d, f, p: self.engine.evaluate_mixed_async(
                dates, f, p)
        else:
            submit = getattr(self.engine, "evaluate_async", None)
            if submit is None:
                # a plain-evaluate engine still works behind the batcher:
                # its blocking result is wrapped to look already-resolved
                submit = lambda d, f, p: _Resolved(
                    self.engine.evaluate(d, f, p))
        pol = self.policy
        attempts = 1 + (pol.max_retries if pol is not None else 0)
        for attempt in range(1, attempts + 1):
            try:
                return submit(date_idx, feats, pr)
            except TransientDispatchError:
                if attempt >= attempts:
                    raise
                obs_count("guard/retry", site="serve/dispatch",
                          attempt=str(attempt))
                self._interrupt.wait(pol.backoff_s(attempt))

    def _dispatch_planned(self, date_idx: int, feats, pr):
        """Engine dispatch with the ragged planner's split decision
        applied: an over-padded batch shatters into exact-bucket chunks
        (each its own engine dispatch, queued back to back on the stream) and
        resolves through one concatenating handle. Without a planner —
        or when its cost model keeps the batch whole — this IS
        ``_dispatch_engine``."""
        if self.planner is not None:
            chunks = self.planner.split_rows(int(feats.shape[0]))
            if chunks is not None:
                obs_count("serve/ragged_splits")
                pends, off = [], 0
                for c in chunks:
                    pends.append(self._dispatch_engine(
                        date_idx, feats[off:off + c],
                        None if pr is None else pr[off:off + c]))
                    off += c
                return _SplitPending(pends)
        return self._dispatch_engine(date_idx, feats, pr)

    def _blocked(self, pending):
        """The ONE block point on a dispatched batch: straight through
        without a watchdog, hard-wall-bounded with one (a hang past
        ``hard_wall_ms`` force-fails as a ``WatchdogTrip`` — transient, so
        the block-time retry below applies; the trip already fed the
        engine's breaker, which may have demoted the hanging bucket)."""
        if self._watchdog is not None:
            return self._watchdog.block(
                pending.result, tag=getattr(pending, "bucket", None))
        return pending.result()

    def _blocked_result(self, g: _Group):
        """Block on ``g``'s dispatched evaluation. A transient failure that
        only SURFACES here (an asynchronous launch fails at completion, not
        submission — or the watchdog force-failed a hung batch) gets the
        same bounded retry policy a dispatch-time failure got: the whole
        group re-dispatches through ``_dispatch_engine`` (whose own retry
        loop then applies). Without a retrying policy the error propagates
        as before — retrying is the operator's call, never a silent
        default."""
        try:
            return self._blocked(g.pending)
        except TransientDispatchError:
            pol = self.policy
            if pol is None or pol.max_retries < 1:
                raise
            obs_count("guard/retry", site="serve/block", attempt="1")
            self._interrupt.wait(pol.backoff_s(1))
            return self._blocked(
                self._dispatch_engine(g.date_idx, g.feats, g.prices,
                                      dates=g.dates))

    def _resolve(self, groups: list[_Group]) -> None:
        """Block on the oldest in-flight batch and resolve every future in
        bulk — strictly outside the Condition (done-callbacks run
        synchronously and may re-enter the batcher)."""
        for g in groups:
            if g.block is not None:
                self._resolve_block(g)
                continue
            if g.blocks is not None:
                self._resolve_coalesced(g)
                continue
            if g.error is not None:
                for r in g.reqs:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(g.error)
                continue
            try:
                with span("serve/batch", attrs={"requests": len(g.reqs),
                                                "rows": g.rows}) as sp:
                    # result() blocks device-side internally, so the span
                    # is already device-complete
                    phi, psi, value = self._blocked_result(g)
            except Exception as e:  # noqa: BLE001 — delivered per-future
                for r in g.reqs:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)
                continue
            done = time.perf_counter()
            off = 0
            served = []
            for r in g.reqs:
                n = r.features.shape[0]
                sl = (phi[off:off + n], psi[off:off + n],
                      value[off:off + n] if g.has_prices else None)
                off += n
                if r.future.set_running_or_notify_cancel():
                    r.future.set_result(sl)
                served.append((done - r.submitted_at, n))
            if self.metrics is not None:
                self.metrics.record_many(served)

    def _resolve_block(self, g: _Group) -> None:
        """Resolve a columnar block's single future: the dispatched live
        rows scatter back into full-size columns next to the status ledger
        (``ingest.Block.resolve_served``); a failed dispatch delivers its
        exception to the one future — no per-row error objects either."""
        blk = g.block
        if g.error is not None:
            if blk.future.set_running_or_notify_cancel():
                blk.future.set_exception(g.error)
            return
        try:
            with span("serve/batch", attrs={"requests": 1,
                                            "rows": g.rows}) as sp:
                phi, psi, value = self._blocked_result(g)
        except Exception as e:  # noqa: BLE001 — delivered through the block future
            if blk.future.set_running_or_notify_cancel():
                blk.future.set_exception(e)
            return
        done = time.perf_counter()
        timing = blk.trace_report(done) if blk.trace is not None else None
        blk.resolve_served(phi, psi, value, timing=timing)
        if self.metrics is not None:
            self.metrics.record(done - blk.submitted_at, g.rows)

    def _resolve_coalesced(self, g: _Group) -> None:
        """Resolve a coalesced multi-block dispatch: slice each origin's
        live rows back out of the shared columns — contiguous slices in
        admission order, so every connection's reply is bitwise its own
        dispatch's — and resolve each block's future independently (one
        dispatch failure reaches every coalesced future; there is one
        device answer to miss)."""
        if g.error is not None:
            for blk in g.blocks:
                if blk.future.set_running_or_notify_cancel():
                    blk.future.set_exception(g.error)
            return
        try:
            with span("serve/batch", attrs={"requests": len(g.blocks),
                                            "rows": g.rows}) as sp:
                phi, psi, value = self._blocked_result(g)
        except Exception as e:  # noqa: BLE001 — delivered through every block future
            for blk in g.blocks:
                if blk.future.set_running_or_notify_cancel():
                    blk.future.set_exception(e)
            return
        done = time.perf_counter()
        off = 0
        served = []
        for blk, n_live in zip(g.blocks, g.block_lives):
            sl_phi = phi[off:off + n_live]
            sl_psi = psi[off:off + n_live]
            sl_val = value[off:off + n_live] if g.has_prices else None
            off += n_live
            timing = blk.trace_report(done) if blk.trace is not None else None
            blk.resolve_served(sl_phi, sl_psi, sl_val, timing=timing)
            served.append((done - blk.submitted_at, n_live))
        if self.metrics is not None:
            self.metrics.record_many(served)


class _Resolved:
    """Adapter: a blocking engine's already-materialized result wearing the
    ``PendingEval`` interface, so the dispatch loop has one resolve path."""

    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


class _SplitPending:
    """A ragged split's in-flight chunks wearing ONE ``PendingEval``
    interface: ``result()`` blocks each chunk in dispatch order and
    concatenates the unpadded rows back — bitwise the unsplit dispatch's
    rows (the forward is per-row and its row results are batch-size
    invariant; tests/test_torch_serve_host.py pins it). Every existing resolve
    path then works unchanged on a split group."""

    __slots__ = ("_pends",)

    def __init__(self, pends):
        self._pends = pends

    def result(self):
        outs = [p.result() for p in self._pends]
        phi = np.concatenate([o[0] for o in outs], axis=0)
        psi = np.concatenate([o[1] for o in outs], axis=0)
        value = (np.concatenate([o[2] for o in outs], axis=0)
                 if outs[0][2] is not None else None)
        return phi, psi, value
