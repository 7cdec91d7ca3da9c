"""Ragged batching: stop paying device time for bucket padding (counterpart of
``orp_tpu/serve/ragged.py``).

The bucketed engine rounds every dispatch up to a power-of-two bucket
(``engine.next_bucket``) so the set of launch shapes stays small, but the
padding rows bill REAL device time: a 1040-row coalesced batch runs the
2048 bucket and throws 49% of the compute away. That waste is usually
hidden behind dispatch overhead, which is exactly why the decision needs a COST
MODEL rather than a rule of thumb: splitting 1040 into [1024, 16] trades
one launch for two, and whether that wins depends on the measured
per-bucket device seconds, not on the pad fraction alone.

:class:`BucketPlanner` is that cost model plus the two decisions built
on it:

- ``plan(counts)`` — partition a run of admitted blocks (admission
  order, so every origin's reply still slices out contiguously) into
  dispatch groups: exact DP over consecutive partitions, minimizing the
  summed per-dispatch cost. This subsumes both MERGE (several blocks
  fill one bucket) and KEEP-SEPARATE (a merge that would step up a
  bucket and pad past the threshold stays split).
- ``split_rows(n)`` — decompose one over-padded batch into
  power-of-two chunks ([1024, 16] for 1040) when the model says the
  extra launches cost less than the padding they remove.

The model prefers MEASURED medians — feed it the engine's per-bucket
``serve/device_seconds`` attribution windows (``obs/devprof``
``bucket_stats()``) via :meth:`feed` / :meth:`feed_profile` — and
falls back to an affine proxy (``overhead_rows + bucket``, in
row-equivalents: a dispatch costs a fixed launch overhead plus a row's
worth of compute per bucket slot) until profiles arrive. Measured and
proxy costs are never mixed inside one comparison: with fewer than two
measured buckets the proxy prices every bucket, otherwise an affine fit
through the measured medians prices the unmeasured ones.

Opt-in from :class:`~orp_tpu_torch.serve.batcher.MicroBatcher` via
``ragged=True`` (the padding rows saved land in the first-class
``serve/pad_waste_rows`` counter either way).
"""

from __future__ import annotations

import collections

import numpy as np

from orp_tpu_torch.serve.engine import next_bucket

#: measured device-second samples retained per bucket — enough for a
#: stable median, bounded so a long-lived server never grows
_WINDOW = 256


class BucketPlanner:
    """Pad-waste-aware dispatch planning over the power-of-two buckets.

    ``pad_waste_threshold`` — the pad FRACTION (padding rows / bucket)
    above which a single dispatch is even considered for splitting; below
    it the launch is presumed cheaper than the analysis. ``overhead_rows``
    — the proxy cost model's fixed per-dispatch launch cost, expressed in
    row-equivalents (bucket slots). The default is the JAX package's; it is
    not fitted to the card (feed measured device seconds instead). ``max_splits`` bounds how many launches one batch
    may shatter into — each split multiplies the Python resolve work.
    """

    def __init__(self, *, pad_waste_threshold: float = 0.25,
                 overhead_rows: float = 64.0, max_splits: int = 4,
                 min_bucket: int = 8):
        if not 0.0 <= pad_waste_threshold < 1.0:
            raise ValueError(
                f"pad_waste_threshold={pad_waste_threshold} must be in "
                "[0, 1) — it is a fraction of the dispatched bucket")
        if max_splits < 2:
            raise ValueError(f"max_splits={max_splits}: a split is at "
                             "least two dispatches")
        self.pad_waste_threshold = float(pad_waste_threshold)
        self.overhead_rows = float(overhead_rows)
        self.max_splits = int(max_splits)
        self.min_bucket = int(min_bucket)
        self._measured: dict[int, collections.deque] = {}

    # -- cost model ----------------------------------------------------------

    def feed(self, bucket: int, device_s: float) -> None:
        """One measured device-seconds sample for ``bucket`` (the
        ``serve/device_seconds{bucket}`` attribution unit)."""
        dq = self._measured.get(int(bucket))
        if dq is None:
            dq = self._measured[int(bucket)] = collections.deque(
                maxlen=_WINDOW)
        dq.append(float(device_s))

    def feed_profile(self, stats: dict) -> None:
        """Ingest an ``obs/devprof`` ``bucket_stats()`` table (or a
        ``DevProf`` itself): each bucket's ``device_s_median`` becomes one
        sample (the devprof hand-off)."""
        if hasattr(stats, "bucket_stats"):
            stats = stats.bucket_stats()
        for key, st in stats.items():
            med = st.get("device_s_median") if isinstance(st, dict) else st
            if med is not None:
                self.feed(int(key), float(med))

    def bucket_for(self, n: int) -> int:
        return next_bucket(n, min_bucket=self.min_bucket)

    def pad_fraction(self, n: int) -> float:
        """Fraction of the dispatched bucket that is padding for ``n``
        live rows — the waste the ``serve/pad_waste_rows`` counter bills
        per dispatch."""
        b = self.bucket_for(n)
        return (b - n) / b

    def cost(self, bucket: int) -> float:
        """Modelled cost of ONE dispatch at ``bucket``. Measured median
        device seconds when this bucket has samples; an affine fit
        through the measured buckets when at least two of them do; the
        ``overhead_rows + bucket`` proxy (row-equivalents) otherwise.
        One pricing basis per comparison — never seconds against rows."""
        fit = self._affine_fit()
        if fit is None:
            return self.overhead_rows + float(bucket)
        dq = self._measured.get(int(bucket))
        if dq:
            return float(np.median(dq))
        a, b = fit
        # an affine extrapolation can go nonpositive below the smallest
        # measured bucket; a dispatch never costs less than ~the launch
        floor = min(float(np.median(d)) for d in self._measured.values()
                    if d)
        return max(a + b * float(bucket), floor * 0.5)

    def _affine_fit(self):
        """``cost ≈ a + b*bucket`` through the measured medians — needs
        two distinct measured buckets, else None (proxy mode)."""
        pts = [(k, float(np.median(dq)))
               for k, dq in self._measured.items() if dq]
        if len(pts) < 2:
            return None
        xs = np.array([p[0] for p in pts], np.float64)
        ys = np.array([p[1] for p in pts], np.float64)
        b, a = np.polyfit(xs, ys, 1)
        return float(a), max(float(b), 0.0)

    # -- decisions -----------------------------------------------------------

    def split_rows(self, n: int) -> list[int] | None:
        """Chunk sizes to dispatch ``n`` rows as, or None to keep one
        dispatch. Triggers only past ``pad_waste_threshold``; accepts the
        greedy power-of-two decomposition (largest exact bucket first,
        e.g. 1040 -> [1024, 16]) only when the modelled cost of the extra
        launches undercuts the one padded launch."""
        if n <= self.min_bucket or self.pad_fraction(n) <= \
                self.pad_waste_threshold:
            return None
        chunks: list[int] = []
        left = int(n)
        while left >= self.min_bucket and len(chunks) < self.max_splits - 1:
            c = 1 << (left.bit_length() - 1)  # largest power of two <= left
            chunks.append(c)
            left -= c
        if left:
            chunks.append(left)  # tail pads into its own (small) bucket
        if len(chunks) < 2:
            return None
        whole = self.cost(self.bucket_for(n))
        split = sum(self.cost(self.bucket_for(c)) for c in chunks)
        return chunks if split < whole else None

    def plan(self, counts: list[int]) -> list[tuple[int, int]]:
        """Partition admitted blocks (live-row ``counts``, admission
        order) into dispatch groups: ``[(lo, hi), ...]`` half-open index
        ranges covering ``counts`` in order. Exact DP over consecutive
        partitions minimizing total modelled dispatch cost — merge when
        blocks fill a bucket, keep apart when the merge's step-up bucket
        pads past what a second launch costs."""
        m = len(counts)
        if m <= 1:
            return [(0, m)] if m else []
        # prefix sums -> O(1) group-row lookups inside the O(m^2) DP
        pref = [0]
        for c in counts:
            pref.append(pref[-1] + int(c))
        best = [0.0] + [float("inf")] * m
        back = [0] * (m + 1)
        for i in range(1, m + 1):
            for j in range(i):
                rows = pref[i] - pref[j]
                cand = best[j] + self.cost(self.bucket_for(rows))
                if cand < best[i]:
                    best[i] = cand
                    back[i] = j
        groups: list[tuple[int, int]] = []
        i = m
        while i > 0:
            groups.append((back[i], i))
            i = back[i]
        groups.reverse()
        return groups

    def pad_waste_rows(self, counts: list[int],
                       groups: list[tuple[int, int]] | None = None) -> int:
        """Padding rows the given grouping dispatches (default: one group
        per count) — the closed-form the accounting tests pin the
        ``serve/pad_waste_rows`` counter against."""
        if groups is None:
            groups = [(i, i + 1) for i in range(len(counts))]
        total = 0
        for lo, hi in groups:
            rows = int(sum(counts[lo:hi]))
            if rows:
                total += self.bucket_for(rows) - rows
        return total
