"""Model-health quality plane: hedge-error estimation, baselines, drift
(counterpart of ``orp_tpu/obs/quality.py``; the same ``orp-quality-v1``
record, so each package's validator accepts the other's).

Three instruments over one discipline (measure, record, gate):

- :class:`ValidationSpec` + :func:`evaluate_quality`: the **hedge-quality
  estimator**. Replay a policy over a PINNED validation scenario set
  (resolved through ``orp_tpu_torch.sde.kernels.resolve_sim_fn``, f32, the
  scan path, on the engine's device) with ``replicates`` independent Owen
  scrambles, and report the hedge error (the residual risk of the
  self-financing replication, per date and aggregate) as mean and an RQMC
  confidence interval over the replicates. The record lands in the telemetry
  bundle via ``obs.emit_record`` and publishes
  ``quality/hedge_error{tenant,date}`` registry gauges.
- :class:`FeatureSketch` + :class:`DriftMonitor`: **feature-drift
  detection**. ``serve/bundle.export_bundle`` bakes a per-feature
  moment/quantile sketch of the TRAINING features into the bundle; the
  serving host's block lane folds each admitted block into a vectorized
  online sketch per tenant (one update per block, never per row) and
  compares against the baked baseline (``quality/drift_score{tenant,
  feature}`` gauges; a band breach emits one ``quality/drift_trip`` and a
  flight-recorder trip).
- the **quantitative canary gate** consumes :func:`evaluate_quality` from
  ``ServeHost.reload_tenant(..., quality_band=...)``: candidate and
  incumbent run the SAME pinned scenario set (replicate ``r`` uses Owen
  seed ``seed + 7919*r`` for both, so the comparison is paired), and a
  candidate whose hedge error regresses past the band is rejected.

Hedge-error definition: with ``m_t = e^{-r t_d} S_t / S_0`` the discounted
normalised hedge-instrument price and ``phi_t`` the served hedge ratio at
date ``t``,

    resid_d = e^{-r T} payoff/S_0  -  sum_{t<d} phi_t (m_{t+1} - m_t)

is the unhedged remainder after trading the policy through date ``d``;
``hedge_error[d] = std(resid_d)`` over paths. ``hedge_error[0]`` is the
unhedged payoff risk, the aggregate (last date) the policy's residual risk,
the number the canary band compares.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np

from orp_tpu_torch.obs import flight
from orp_tpu_torch.obs.spans import count as obs_count
from orp_tpu_torch.obs.spans import emit_record as obs_emit_record
from orp_tpu_torch.obs.spans import state as obs_state

QUALITY_SCHEMA = "orp-quality-v1"

#: scenario kinds the validation resolver supports (each maps 1:1 onto a
#: ``sde.kernels.resolve_sim_fn`` key and a feature layout the policies
#: trained on: gbm -> (S/S0,), heston -> (S/S0, v))
VALIDATION_KINDS = ("gbm", "heston-qe", "heston-euler")

#: default drift band: an aggregate score of 1.0 = the live feature mean
#: has moved one BASELINE standard deviation off the training mean
DEFAULT_DRIFT_BAND = 1.0

# two-sided 97.5% Student-t quantiles by degrees of freedom — the replicate
# CI uses R-1 dof; past the table the normal 1.96 is within ~4%
_T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 12: 2.179, 15: 2.131,
         20: 2.086, 30: 2.042}


def _t975(dof: int) -> float:
    if dof < 1:
        return float("inf")
    if dof in _T975:
        return _T975[dof]
    if dof > max(_T975):
        return 1.96
    # between table rows: the next LOWER dof's (wider) quantile — conservative
    return _T975[max(d for d in _T975 if d <= dof)]


@dataclasses.dataclass(frozen=True)
class ValidationSpec:
    """A pinned validation scenario set: enough to regenerate the EXACT
    paths (kind + market params + grid + Owen scramble seeds), so two
    processes evaluating one policy agree bit-for-bit and a canary's
    candidate-vs-incumbent comparison is paired. Baked into the bundle by
    ``serve.bundle.export_bundle`` (``bundle.json`` ``baseline.validation``); the
    ``fingerprint`` (the ``config_fingerprint`` repr discipline) is what
    the promotions chain records."""

    kind: str = "gbm"
    s0: float = 100.0
    r: float = 0.08
    sigma: float = 0.15          # gbm only
    v0: float = 0.0225           # heston-* only
    kappa: float = 1.5
    theta: float = 0.0225
    xi: float = 0.25
    rho: float = -0.6
    strike: float = 100.0
    option_type: str = "call"
    T: float = 1.0
    n_steps: int = 52
    rebalance_every: int = 4
    n_paths: int = 2048
    replicates: int = 8
    seed: int = 9173             # base Owen scramble seed; replicate r uses
    # seed + 7919*r — deterministic, disjoint from the pipelines' training
    # seeds by convention (a validation set must never be the training set)

    def __post_init__(self):
        if self.kind not in VALIDATION_KINDS:
            raise ValueError(
                f"validation kind {self.kind!r}: expected one of "
                f"{VALIDATION_KINDS}")
        if self.n_steps % self.rebalance_every:
            raise ValueError(
                f"n_steps={self.n_steps} not divisible by "
                f"rebalance_every={self.rebalance_every}")
        if self.n_paths < 2 or self.replicates < 2:
            raise ValueError(
                f"n_paths={self.n_paths}/replicates={self.replicates}: a "
                "quality estimate needs >= 2 paths and >= 2 replicates "
                "(the CI is computed ACROSS replicates)")

    @property
    def n_dates(self) -> int:
        return self.n_steps // self.rebalance_every

    @property
    def n_features(self) -> int:
        return 1 if self.kind == "gbm" else 2

    def fingerprint(self) -> str:
        """Repr-based identity (the ``config_fingerprint`` discipline):
        total over fields, so ANY spec change changes the string."""
        return repr(self)

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: dict) -> "ValidationSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})


# -- feature baseline sketches ------------------------------------------------

_SKETCH_QS = (0.01, 0.25, 0.5, 0.75, 0.99)


@dataclasses.dataclass(frozen=True)
class FeatureSketch:
    """Per-feature moment + quantile summary of a feature matrix — the
    export-time baseline the serve-time drift monitor compares against.
    All fields are tuples (one entry per feature), JSON-able via
    ``to_meta``/``from_meta`` so the sketch bakes into ``bundle.json``."""

    count: int
    mean: tuple
    std: tuple
    minimum: tuple
    maximum: tuple
    quantiles: dict  # {"0.01": (per-feature,), ...}

    @property
    def n_features(self) -> int:
        return len(self.mean)

    @classmethod
    def from_features(cls, features) -> "FeatureSketch":
        """Sketch a training feature array of shape ``(..., n_features)``
        (the pipelines' ``(n_paths, n_knots, n_features)``) — one vectorized
        pass, no per-row Python. A numpy array is sketched as the JAX package
        sketches it (numpy, float64); a tensor on its own device in float64
        (:func:`_sketch_tensor`: the pipelines' features stay on the card)."""
        if not isinstance(features, np.ndarray) and hasattr(features, "device"):
            return _sketch_tensor(cls, features)
        x = np.asarray(features, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        x = x.reshape(-1, x.shape[-1])
        qs = np.quantile(x, _SKETCH_QS, axis=0)
        return cls(
            count=int(x.shape[0]),
            mean=tuple(float(v) for v in x.mean(axis=0)),
            std=tuple(float(v) for v in x.std(axis=0)),
            minimum=tuple(float(v) for v in x.min(axis=0)),
            maximum=tuple(float(v) for v in x.max(axis=0)),
            quantiles={str(q): tuple(float(v) for v in row)
                       for q, row in zip(_SKETCH_QS, qs)},
        )

    def to_meta(self) -> dict:
        return {"count": self.count, "mean": list(self.mean),
                "std": list(self.std), "min": list(self.minimum),
                "max": list(self.maximum),
                "quantiles": {k: list(v) for k, v in self.quantiles.items()}}

    @classmethod
    def from_meta(cls, meta: dict) -> "FeatureSketch":
        return cls(
            count=int(meta["count"]),
            mean=tuple(meta["mean"]), std=tuple(meta["std"]),
            minimum=tuple(meta["min"]), maximum=tuple(meta["max"]),
            quantiles={k: tuple(v)
                       for k, v in (meta.get("quantiles") or {}).items()},
        )


def _sketch_tensor(cls, features) -> FeatureSketch:
    """:meth:`FeatureSketch.from_features` of a tensor, in float64 on its
    device: moments by torch reductions, quantiles by numpy's ``linear``
    rule (virtual index ``q (n - 1)``, numpy's two-sided lerp) on the sorted
    columns. Agrees with the numpy sketch to float64 rounding."""
    import torch

    x = features.detach().to(torch.float64)  # orp: noqa[ORP001] -- the sketch's moments are accumulated in f64 on the host side, as the JAX package's numpy sketch
    if x.ndim == 1:
        x = x[:, None]
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    rows = []
    for q in _SKETCH_QS:
        pos = q * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        t = pos - lo
        a, b = srt[lo], srt[hi]
        rows.append(b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t)
    qs = torch.stack(rows).cpu().numpy()

    def cols(v):
        return tuple(float(c) for c in v.cpu().numpy())

    return cls(count=int(n), mean=cols(x.mean(dim=0)), std=cols(x.std(dim=0, correction=0)),
               minimum=cols(srt[0]), maximum=cols(srt[-1]),
               quantiles={str(q): tuple(float(v) for v in row)
                          for q, row in zip(_SKETCH_QS, qs)})


class DriftMonitor:
    """Vectorized online feature sketch vs a baked baseline, per tenant.

    The block lane calls :meth:`update` once per ADMITTED BLOCK (never per
    row): one column-sum + one column-sum-of-squares over the block, merged
    into EXPONENTIALLY-DECAYED running moments under one lock (half-life
    ``half_life_rows`` — an effective window of ~1.44x that many recent
    rows, so detection sensitivity is constant over tenant uptime instead
    of decaying with every served row). The drift score per feature is the
    live mean's displacement in units of the BASELINE std (floored);
    the aggregate is the max over features. Gauges
    (``quality/drift_score{tenant,feature}``, ``quality/drift_max{tenant}``,
    ``quality/drift_rows{tenant}``) are interned ONCE at construction (the
    instruments are not re-interned per block) and updated per block, so a
    registry export carries them with no new
    plumbing.

    Band semantics: once ``min_rows`` rows have been sketched and the
    aggregate score exceeds ``band``, ONE ``quality/drift_trip`` counter +
    flight-recorder TRIP fires (the armed ring auto-dumps — the drifted
    window is the post-mortem evidence) and the monitor latches; it re-arms
    when the score falls back under 80% of the band, so an oscillating
    tenant cannot spam the black box.
    """

    def __init__(self, baseline: FeatureSketch, *,
                 band: float = DEFAULT_DRIFT_BAND, min_rows: int = 256,
                 half_life_rows: int = 1 << 16, registry=None,
                 tenant: str = ""):
        if band <= 0:
            raise ValueError(f"band={band} must be > 0")
        if half_life_rows < 1:
            raise ValueError(f"half_life_rows={half_life_rows} must be >= 1")
        self.baseline = baseline
        self.band = float(band)
        self.min_rows = int(min_rows)
        # the sketch is EXPONENTIALLY WEIGHTED (existing moments decay by
        # 2^(-n/half_life_rows) per n-row fold): an all-time cumulative mean
        # would need as many drifted rows as the tenant has ever served
        # before moving — detection sensitivity must stay CONSTANT over
        # uptime, not decay with it. The effective window is
        # ~1.44 * half_life_rows recent rows (the bounded-histogram spirit)
        self.half_life_rows = int(half_life_rows)
        self.tenant = tenant
        self._base_mean = np.asarray(baseline.mean, np.float64)
        # floor: a constant training feature must not turn any live jitter
        # into an infinite score
        self._base_std = np.maximum(np.asarray(baseline.std, np.float64),
                                    1e-9)
        self._lock = threading.Lock()
        self._n = 0.0                 # decayed effective row count
        self._rows = 0                # lifetime rows folded (gauge/stats)
        self._s1 = np.zeros(baseline.n_features)
        self._s2 = np.zeros(baseline.n_features)
        self._tripped = False
        self.trips = 0
        self._gauges = None
        if registry is not None:
            labels = {"tenant": tenant}
            self._gauges = (
                [registry.gauge("quality/drift_score",
                                {**labels, "feature": f"f{i}"})
                 for i in range(baseline.n_features)],
                registry.gauge("quality/drift_max", labels),
                registry.gauge("quality/drift_rows", labels),
            )

    def update(self, rows) -> float:
        """Fold one admitted block's feature rows ``(n, n_features)`` into
        the running sketch; returns the aggregate drift score. This IS the
        per-block bill the ``drift_overhead`` bench phase gates ≤ 5%."""
        x = np.asarray(rows, np.float64)
        if x.ndim != 2 or x.shape[1] != self.baseline.n_features:
            # a block the baseline cannot describe: monitoring is ADVISORY
            # and must stay fail-open — skip the fold, surface the count
            # (the serving engine rejects wrong-width features on its own)
            obs_count("quality/drift_skipped", tenant=self.tenant,
                      reason="shape")
            return self.scores()["score"]
        finite = np.isfinite(x).all(axis=1)
        if not finite.all():
            # non-finite rows cannot fold into moments (one NaN would
            # poison the decayed sums FOREVER — decay never washes it out)
            # but they ARE model-health signal: count them and fold the rest
            obs_count("quality/drift_nonfinite",
                      int(np.count_nonzero(~finite)), tenant=self.tenant)
            x = x[finite]
            if x.shape[0] == 0:
                return self.scores()["score"]
        n = x.shape[0]
        s1 = x.sum(axis=0)
        s2 = np.einsum("ij,ij->j", x, x)
        fire = False
        decay = 0.5 ** (n / self.half_life_rows)
        with self._lock:
            self._n = self._n * decay + n
            self._s1 = self._s1 * decay + s1
            self._s2 = self._s2 * decay + s2
            self._rows += n
            total = self._n
            rows = self._rows
            mu = self._s1 / total
            scores = np.abs(mu - self._base_mean) / self._base_std
            agg = float(scores.max()) if scores.size else 0.0
            # latch DECISION under the lock: two concurrent block submits
            # must not both win the check-and-set and double-dump the
            # black box — the ONE-trip contract is the point of the latch
            if rows >= self.min_rows:
                if agg > self.band and not self._tripped:
                    self._tripped = True
                    self.trips += 1
                    fire = True
                elif agg < 0.8 * self.band:
                    self._tripped = False  # re-arm after the episode clears
        # emission OUTSIDE the lock (obs/flight take their own locks; the
        # ring dump a TRIP triggers does file I/O)
        if self._gauges is not None:
            per_feature, gmax, grows = self._gauges
            for g, v in zip(per_feature, scores):
                g.set(float(v))
            gmax.set(agg)
            grows.set(float(rows))
        if fire:
            obs_count("quality/drift_trip", tenant=self.tenant)
            flight.record("drift_trip", tenant=self.tenant,
                          score=round(agg, 4), band=self.band,
                          rows=int(rows),
                          scores=[round(float(v), 4) for v in scores])
        return agg

    def scores(self) -> dict:
        """Current per-feature scores + live moments (operator read path)."""
        with self._lock:
            total = self._n
            rows = self._rows
            s1, s2 = self._s1.copy(), self._s2.copy()
            tripped, trips = self._tripped, self.trips
        if rows == 0:
            return {"rows": 0, "score": 0.0, "per_feature": [],
                    "tripped": False, "band": self.band}
        mu = s1 / total
        var = np.maximum(s2 / total - mu * mu, 0.0)
        scores = np.abs(mu - self._base_mean) / self._base_std
        return {
            "rows": int(rows),
            "score": float(scores.max()),
            "per_feature": [
                {"feature": f"f{i}", "score": round(float(s), 4),
                 "live_mean": round(float(m), 6),
                 "live_std": round(float(math.sqrt(v)), 6),
                 "base_mean": round(float(bm), 6),
                 "base_std": round(float(bs), 6)}
                for i, (s, m, v, bm, bs) in enumerate(
                    zip(scores, mu, var, self._base_mean, self._base_std))
            ],
            "tripped": tripped,
            "trips": trips,
            "band": self.band,
        }


# -- the hedge-quality estimator ----------------------------------------------


def _simulate_validation(spec: ValidationSpec, n_paths: int, seed: int, device):
    """One replicate's paths through the shared sim-fn resolver, in f32 on the
    scan path on ``device``: returns ``(s, payoff, feats)`` as host arrays, the
    hedge-instrument price paths ``(n, knots)``, the f32 payoff ``(n,)`` and
    the policy feature tensor ``(n, knots, n_features)`` in the training
    normalisation."""
    import torch

    from orp_tpu_torch.parallel.mesh import path_indices
    from orp_tpu_torch.sde import TimeGrid, payoffs
    from orp_tpu_torch.sde.kernels import resolve_sim_fn

    sim_fn = resolve_sim_fn(spec.kind)
    grid = TimeGrid(spec.T, spec.n_steps)
    idx = path_indices(n_paths, None, device=device)
    if spec.kind == "gbm":
        s_t = sim_fn(idx, grid, spec.s0, spec.r, spec.sigma, seed, scramble="owen",
                     store_every=spec.rebalance_every, dtype=torch.float32)
        payoff = payoffs.european(s_t[:, -1], spec.strike, spec.option_type)
        s = s_t.cpu().numpy()
        feats = (s / spec.s0)[:, :, None].astype(np.float32)
        return s, payoff.cpu().numpy(), feats
    traj = sim_fn(idx, grid, s0=spec.s0, mu=spec.r, v0=spec.v0, kappa=spec.kappa,
                  theta=spec.theta, xi=spec.xi, rho=spec.rho, seed=seed, scramble="owen",
                  store_every=spec.rebalance_every, dtype=torch.float32)
    payoff = payoffs.european(traj["S"][:, -1], spec.strike, spec.option_type)
    s, v = traj["S"].cpu().numpy(), traj["v"].cpu().numpy()
    feats = np.stack([s / spec.s0, v], axis=-1).astype(np.float32)
    return s, payoff.cpu().numpy(), feats


def evaluate_quality(policy=None, spec: ValidationSpec | None = None, *,
                     engine=None, n_paths: int | None = None,
                     replicates: int | None = None, registry=None,
                     tenant: str | None = None, device=None) -> dict:
    """Hedge-quality estimate of a policy on a pinned validation set.

    ``policy`` — a ``PolicyBundle``/``PipelineResult`` (an engine is built
    from it on ``device``, the card by default), or pass a live ``engine=``
    directly (the canary gate's shape: the SERVING engine's bits are what
    gets measured). The validation paths run in f32 on the scan path on the
    engine's device. ``spec`` defaults to
    the policy's baked validation set (``export_bundle`` bakes one); with
    neither, the estimate is refused in flag-speak. ``n_paths`` /
    ``replicates`` shrink the spec's defaults (the doctor probe's knob).

    Returns the ``orp-quality-v1`` record: per-date and aggregate
    hedge-error mean ± 95% CI over the Owen-scrambled replicates. The
    evaluation is DETERMINISTIC — fixed spec, fixed seeds, the serving
    forward — so two runs agree bit-for-bit (pinned in
    tests/test_torch_serve_host.py). When a telemetry session is active the record
    lands in the bundle (``obs.emit_record``); with ``registry`` (or an
    active session) the ``quality/hedge_error{tenant,date}`` gauges update.
    """
    from orp_tpu_torch.sde import TimeGrid

    if engine is None:
        if policy is None:
            raise ValueError("evaluate_quality needs a policy or an engine")
        from orp_tpu_torch.serve.engine import HedgeEngine

        engine = HedgeEngine(policy, device=device)
    if spec is None:
        spec = getattr(policy, "validation", None)
        if spec is None:
            raise ValueError(
                "no pinned validation set: pass spec=ValidationSpec(...) or "
                "re-export the bundle with the current code (`export_bundle` "
                "bakes one into bundle.json)")
    if spec.n_dates != engine.n_dates:
        raise ValueError(
            f"validation set has {spec.n_dates} rebalance dates; the policy "
            f"serves {engine.n_dates} — the spec must mirror the training "
            "grid (n_steps/rebalance_every)")
    if spec.n_features != engine.model.n_features:
        raise ValueError(
            f"validation kind {spec.kind!r} yields {spec.n_features} "
            f"feature(s); the policy was trained on "
            f"{engine.model.n_features}")
    n = int(n_paths if n_paths is not None else spec.n_paths)
    reps = int(replicates if replicates is not None else spec.replicates)
    if reps < 2:
        raise ValueError(f"replicates={reps}: the RQMC CI needs >= 2")
    grid = TimeGrid(spec.T, spec.n_steps)
    times = grid.reduced(spec.rebalance_every).times().numpy().astype(np.float64)
    disc = np.exp(-spec.r * times)
    n_dates = spec.n_dates
    per_rep = []
    for rep in range(reps):
        s, payoff, feats = _simulate_validation(spec, n, spec.seed + 7919 * rep,
                                                engine.device)
        payoff_n = np.asarray(payoff, np.float64) / spec.s0
        m = disc[None, :] * (np.asarray(s, np.float64) / spec.s0)
        target = disc[-1] * payoff_n
        # served hedge ratios, date by date — THE serving forward, so the
        # estimate measures exactly what the tenant answers
        phis = np.stack(
            [np.asarray(engine.evaluate(
                d, np.ascontiguousarray(feats[:, d]))[0], np.float64)
             for d in range(n_dates)], axis=1)
        resid = target[:, None] - np.cumsum(phis * np.diff(m, axis=1),
                                            axis=1)
        e = np.concatenate([[target.std()], resid.std(axis=0)])
        per_rep.append(e)
    arr = np.stack(per_rep)                      # (reps, n_dates+1)
    mean = arr.mean(axis=0)
    sd = arr.std(axis=0, ddof=1)
    ci = _t975(reps - 1) * sd / math.sqrt(reps)
    record = {
        "schema": QUALITY_SCHEMA,
        "kind": spec.kind,
        "validation_fingerprint": spec.fingerprint(),
        "n_paths": n,
        "n_dates": n_dates,
        "replicates": reps,
        "seed": spec.seed,
        "hedge_error": {"mean": float(mean[-1]), "ci95": float(ci[-1]),
                        "std": float(sd[-1])},
        "unhedged": {"mean": float(mean[0]), "ci95": float(ci[0])},
        "per_date": [
            {"date": d, "mean": float(mean[d + 1]), "ci95": float(ci[d + 1])}
            for d in range(n_dates)
        ],
    }
    # nested under "record": the sink stamps its OWN schema on the event's
    # top level (orp-obs-v1), and the quality record's orp-quality-v1 tag
    # must survive the round trip for bundle-side consumers
    obs_emit_record("quality/hedge_error", {"record": record})
    if registry is None:
        st = obs_state()
        registry = st.registry if st is not None else None
    if registry is not None:
        publish_quality(record, registry, tenant=tenant)
    return record


def publish_quality(record: dict, registry, *, tenant: str | None = None
                    ) -> None:
    """Set the ``quality/hedge_error{tenant,date}`` gauges from an
    ``orp-quality-v1`` record — the one gauge-publishing path, shared by
    :func:`evaluate_quality` and the canary gate's post-promote refresh
    (the live series must describe the SERVING policy, so a promote
    re-publishes the candidate's numbers over the retired incumbent's)."""
    labels = {"tenant": tenant} if tenant else {}
    he = record["hedge_error"]
    registry.gauge("quality/hedge_error",
                   {**labels, "date": "all"}).set(float(he["mean"]))
    registry.gauge("quality/hedge_error_ci",
                   {**labels, "date": "all"}).set(float(he["ci95"]))
    for row in record.get("per_date", ()):
        registry.gauge(
            "quality/hedge_error",
            {**labels, "date": str(row["date"])}).set(float(row["mean"]))


def validate_quality_record(record: dict) -> list[str]:
    """Schema check for one ``orp-quality-v1`` record; returns problems
    (empty = valid) — the ``validate_event`` contract shape, what
    the promotions chain relies on."""
    problems = []
    if record.get("schema") != QUALITY_SCHEMA:
        problems.append(
            f"schema {record.get('schema')!r} != {QUALITY_SCHEMA!r}")
    for key in ("validation_fingerprint", "n_paths", "n_dates",
                "replicates", "hedge_error", "per_date"):
        if key not in record:
            problems.append(f"missing key {key!r}")
    he = record.get("hedge_error")
    if isinstance(he, dict):
        for key in ("mean", "ci95"):
            if not isinstance(he.get(key), (int, float)):
                problems.append(f"hedge_error.{key} is not a number")
            elif not math.isfinite(he[key]):
                problems.append(f"hedge_error.{key}={he[key]} is not finite")
    elif he is not None:
        problems.append("hedge_error is not an object")
    pd = record.get("per_date")
    if isinstance(pd, list) and isinstance(record.get("n_dates"), int):
        if len(pd) != record["n_dates"]:
            problems.append(
                f"per_date has {len(pd)} rows for n_dates="
                f"{record['n_dates']}")
    return problems
