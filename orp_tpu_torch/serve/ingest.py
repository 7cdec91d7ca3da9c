"""Columnar ingest plane: move requests in columns, not Python objects
(counterpart of ``orp_tpu/serve/ingest.py``).

The per-request host cost (one ``submit()`` call, one future, one request
object, one group insert per row) bounds a serve tier once the device is
amortized and overlapped. The columnar lane amortizes the host over rows:

- a **block** is N rows for one rebalance date: a contiguous ``(n,
  n_features)`` feature matrix, an optional ``(n, k)`` price matrix, an
  optional per-row float64 deadline column, and exactly ONE
  :class:`~orp_tpu_torch.serve.batcher.SlimFuture` for all N rows;
- guard semantics stay exact but become **vectorized**: deadline expiry is
  a mask compare on the deadline column, watermark/quota shed the TAIL
  rows of a block as a slice, never a per-row ``Rejection`` object;
- the answer is a :class:`BlockResult`: contiguous ``phi``/``psi``/
  ``value`` columns plus a per-row ``status`` column (:data:`SERVED` /
  :data:`SHED_DEADLINE` / :data:`SHED_WATERMARK` / :data:`SHED_QUOTA`),
  bitwise-equal on served rows to N per-request submits of the same rows
  (the engine's per-date forward runs in fixed row tiles, and the mixed-date
  kernel computes each row on its own; ``tests/test_torch_serve_host.py``).

No ``for`` loop over rows constructs objects, appends futures or calls
``submit`` in this module.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import emit_trace_spans, flight
from orp_tpu_torch.obs import observe as obs_observe

# per-row status codes (the BlockResult.status column / the wire's status
# column — a u8, so the codec ships it with one tobytes)
SERVED = 0
SHED_DEADLINE = 1
SHED_WATERMARK = 2
SHED_QUOTA = 3

STATUS_NAMES = {
    SERVED: "served",
    SHED_DEADLINE: "shed-deadline",
    SHED_WATERMARK: "shed-watermark",
    SHED_QUOTA: "shed-quota",
}

_SHED_REASON = {SHED_DEADLINE: "deadline", SHED_WATERMARK: "watermark",
                SHED_QUOTA: "quota"}


@dataclasses.dataclass(frozen=True)
class BlockResult:
    """The columnar answer to a ``submit_block``: one contiguous column per
    output, one status byte per row. Rows whose status is not
    :data:`SERVED` carry zeros in the value columns — the status column,
    not a sentinel value, is the contract (a legitimately-served phi can be
    0.0).

    ``phi``/``psi``: ``(n,)`` hedge ratios; ``value``: ``(n,)`` portfolio
    values or None when the block carried no prices; ``status``: ``(n,)``
    uint8 of status codes (:data:`STATUS_NAMES`); ``timing``: the compact
    server-timing block of a TRACED block — ``(queue_age_s, dispatch_s)``,
    None on every untraced path (the wire carries it back to the producer
    as the reply's 16-byte trace extension).
    """

    phi: np.ndarray
    psi: np.ndarray
    value: np.ndarray | None
    status: np.ndarray
    timing: tuple[float, float] | None = None

    @property
    def n_rows(self) -> int:
        return int(self.status.shape[0])

    @property
    def served_mask(self) -> np.ndarray:
        """Boolean column: True where the row was served."""
        return self.status == SERVED

    @property
    def n_served(self) -> int:
        return int(np.count_nonzero(self.status == SERVED))

    def shed_counts(self) -> dict[str, int]:
        """Rows per non-served status name (zero-count statuses omitted)."""
        codes, counts = np.unique(self.status, return_counts=True)
        return {STATUS_NAMES[int(c)]: int(k)
                for c, k in zip(codes, counts) if int(c) != SERVED}


def all_shed_result(n: int, code: int, *, has_value: bool,
                    dtype=np.float32) -> BlockResult:
    """A block that never reached the device: every row shed with ``code``
    (quota at the host, watermark at submit, deadline for a block that
    expired whole)."""
    z = np.zeros(n, dtype)
    return BlockResult(
        phi=z, psi=z.copy(),
        value=np.zeros(n, dtype) if has_value else None,
        status=np.full(n, code, np.uint8),
    )


def concat_results(results) -> BlockResult:
    """Stack a sequence of :class:`BlockResult`\\ s into one (the drill /
    bench shape: many blocks, one ledger to compare bitwise). ``value`` is
    kept only when every block carries it."""
    results = list(results)
    if not results:
        raise ValueError("concat_results needs at least one BlockResult")
    has_value = all(r.value is not None for r in results)
    return BlockResult(
        phi=np.concatenate([r.phi for r in results]),
        psi=np.concatenate([r.psi for r in results]),
        value=(np.concatenate([r.value for r in results])
               if has_value else None),
        status=np.concatenate([r.status for r in results]),
    )


def merge_tail_shed(head: BlockResult, n_tail: int, code: int) -> BlockResult:
    """Extend ``head`` (the admitted prefix of a block) with ``n_tail``
    tail rows shed as ``code`` — the quota/watermark tail-slice semantics:
    the shed rows were never objects, so the merge is two concatenates and
    a fill."""
    if n_tail <= 0:
        return head
    tail = all_shed_result(n_tail, code, has_value=head.value is not None,
                           dtype=head.phi.dtype)
    return BlockResult(
        phi=np.concatenate([head.phi, tail.phi]),
        psi=np.concatenate([head.psi, tail.psi]),
        value=(None if head.value is None
               else np.concatenate([head.value, tail.value])),
        status=np.concatenate([head.status, tail.status]),
        timing=head.timing,
    )


class Block:
    """One admitted request block as the batcher tracks it: the columns,
    the per-row status ledger, and the single future the whole block
    resolves through. All mutation is vectorized.

    ``deadlines`` is an absolute-``perf_counter`` float64 column (or None:
    rows never expire); ``status`` starts all-:data:`SERVED` and rows are
    struck off by slice (watermark tail at submit) or mask (deadline at
    admit) before dispatch. ``features``/``prices`` keep the FULL n rows —
    the live subset is sliced out only at dispatch, so the clean path
    (nothing shed) dispatches the caller's own contiguous arrays with zero
    copies.
    """

    __slots__ = ("date_idx", "features", "prices", "future", "submitted_at",
                 "deadlines", "status", "n", "trace", "t_admit",
                 "t_dispatch")

    def __init__(self, date_idx: int, features, prices, future,
                 submitted_at: float, deadlines, trace=None):
        self.date_idx = int(date_idx)
        self.features = features            # (n, n_features), contiguous
        self.prices = prices                # (n, k) or None
        self.future = future                # ONE SlimFuture for the block
        self.submitted_at = submitted_at
        self.deadlines = deadlines          # (n,) float64 absolute, or None
        self.n = int(features.shape[0])
        self.status = np.zeros(self.n, np.uint8)
        # distributed-trace context: (trace_id, parent_span) stamped by the
        # producer and carried through the batcher so the admit/dispatch/
        # resolve instants can be attributed. None (the untraced default)
        # keeps every stamp behind ONE `is not None` test per block
        self.trace = trace
        self.t_admit = None
        self.t_dispatch = None

    @property
    def n_live(self) -> int:
        return int(np.count_nonzero(self.status == SERVED))

    def shed_tail(self, keep: int, code: int) -> int:
        """Watermark/quota semantics: strike every row past ``keep`` (that
        is still live) with ``code``; returns how many rows were struck."""
        tail = self.status[max(0, keep):]
        struck = tail == SERVED
        tail[struck] = code
        return int(np.count_nonzero(struck))

    def mask_expired(self, now: float) -> int:
        """Deadline semantics, vectorized: one compare against the deadline
        column strikes every live row whose deadline has passed; returns
        how many rows were struck."""
        if self.deadlines is None:
            return 0
        expired = (self.status == SERVED) & (self.deadlines < now)
        k = int(np.count_nonzero(expired))
        if k:
            self.status[expired] = SHED_DEADLINE
        return k

    def live_columns(self):
        """The dispatchable columns: ``(features, prices)`` restricted to
        live rows. The nothing-shed fast path returns the stored arrays
        themselves — no copy, no concatenate."""
        if self.n_live == self.n:
            return self.features, self.prices
        live = self.status == SERVED
        return (np.ascontiguousarray(self.features[live]),
                None if self.prices is None
                else np.ascontiguousarray(self.prices[live]))

    def emit_shed(self, code: int, n_rows: int) -> None:
        """Guard signals for ``n_rows`` struck with ``code`` — ONE counter
        bump (by row count) and ONE queue-age observation per block event,
        mirroring the per-request lane's ``guard/shed`` /
        ``serve/queue_age_seconds`` semantics at block cost."""
        if n_rows <= 0:
            return
        obs_count("guard/shed", n_rows, reason=_SHED_REASON[code],
                  lane="block")
        obs_observe("serve/queue_age_seconds",
                    time.perf_counter() - self.submitted_at, outcome="shed")
        flight.record("shed", reason=_SHED_REASON[code], rows=int(n_rows),
                      lane="block")

    def resolve_shed_only(self) -> None:
        """Resolve a block none of whose rows survived to dispatch (all
        quota/watermark/deadline) — zeros in every value column, the status
        column tells the story."""
        if self.future.set_running_or_notify_cancel():
            dt = self.features.dtype if self.features.dtype.kind == "f" \
                else np.float32
            z = np.zeros(self.n, dt)
            self.future.set_result(BlockResult(
                phi=z, psi=z.copy(),
                value=np.zeros(self.n, dt) if self.prices is not None else None,
                status=self.status,
            ))

    def trace_report(self, done: float) -> tuple[float, float]:
        """TRACED blocks only: emit the queue/dispatch/resolve trace spans
        (``obs.emit_trace_span`` — no-ops without a sink) and return the
        compact server-timing block ``(queue_age_s, dispatch_s)`` the
        reply's trace extension carries back to the producer. The segment
        walls are the batcher's own instants: submit → admit is the queue,
        admit → device submit is the dispatch stage, device submit →
        device-complete is the resolve (the stage whose job is to block)."""
        tid, parent = self.trace
        t_admit = self.t_admit if self.t_admit is not None \
            else self.submitted_at
        t_disp = self.t_dispatch if self.t_dispatch is not None else t_admit
        queue_s = max(0.0, t_admit - self.submitted_at)
        dispatch_s = max(0.0, done - t_disp)
        # ONE sink burst for the whole frame: the per-frame tracing budget
        # (BENCH_serve trace_overhead gate) is paid right here
        emit_trace_spans(tid, parent, (
            ("trace/queue", queue_s),
            ("trace/dispatch", max(0.0, t_disp - t_admit)),
            ("trace/resolve", dispatch_s),
        ))
        return (queue_s, dispatch_s)

    def resolve_served(self, phi, psi, value, timing=None) -> None:
        """Scatter the dispatched (live-row) results back into full-size
        columns and resolve the block's one future. The nothing-shed fast
        path hands the engine's arrays through untouched. ``timing`` is the
        traced block's server-timing pair (None untraced)."""
        if self.n_live == self.n:
            out = BlockResult(phi=phi, psi=psi, value=value,
                              status=self.status, timing=timing)
        else:
            live = self.status == SERVED
            full_phi = np.zeros(self.n, phi.dtype)
            full_psi = np.zeros(self.n, psi.dtype)
            full_phi[live] = phi
            full_psi[live] = psi
            full_value = None
            if value is not None:
                full_value = np.zeros(self.n, value.dtype)
                full_value[live] = value
            out = BlockResult(phi=full_phi, psi=full_psi, value=full_value,
                              status=self.status, timing=timing)
        if self.future.set_running_or_notify_cancel():
            self.future.set_result(out)


def as_deadline_column(deadlines, n: int, now: float,
                       default_s: float | None) -> np.ndarray | None:
    """Normalise a caller's ``deadlines`` argument — None, a scalar budget
    in seconds, or an ``(n,)`` per-row budget column — into the absolute
    float64 deadline column the admit-time mask compares against. With no
    per-row deadlines and no policy default, returns None (rows never
    expire)."""
    if deadlines is None:
        if default_s is None:
            return None
        return np.full(n, now + default_s, np.float64)
    col = np.asarray(deadlines, np.float64)
    if col.ndim == 0:
        return np.full(n, now + float(col), np.float64)
    if col.shape != (n,):
        raise ValueError(
            f"deadlines column has shape {col.shape}; expected ({n},) — one "
            "relative budget (seconds) per block row, or a scalar for all"
        )
    return now + col
