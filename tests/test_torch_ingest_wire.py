"""The single-host serve path's host-side modules against the JAX package: the
``orp-ingest-v2`` wire codec (frames byte-identical both ways, each package
decoding the other's), the columnar ingest ledger under one shed schedule,
``BucketPlanner``, ``Cooldown``, ``GuardPolicy`` / ``CircuitBreaker``,
``FeatureSketch`` / ``DriftMonitor`` and ``policy_fingerprint``.

Every comparison here is exact (bytes, statuses, plans, floats ``==``) except
the tensor sketch, which sums in another order than numpy (rtol 1e-12)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from orp_tpu.guard.cooldown import Cooldown as JCooldown
from orp_tpu.guard.serve import CircuitBreaker as JCircuitBreaker
from orp_tpu.guard.serve import GuardPolicy as JGuardPolicy
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.obs import quality as jquality
from orp_tpu.serve import ingest as jingest
from orp_tpu.serve import wire as jwire
from orp_tpu.serve.ragged import BucketPlanner as JBucketPlanner
from orp_tpu.utils.fingerprint import policy_fingerprint as jpolicy_fingerprint
from orp_tpu_torch.guard import CircuitBreaker, Cooldown, GuardPolicy
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.obs import quality
from orp_tpu_torch.serve import BucketPlanner, ingest, wire
from orp_tpu_torch.utils.fingerprint import policy_fingerprint


def _cols(n=5, f=3, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, f)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32),
            rng.uniform(0.001, 0.5, n))


def _reply(n=5, value=True, seed=1):
    rng = np.random.default_rng(seed)
    return dict(phi=rng.standard_normal(n).astype(np.float32),
                psi=rng.standard_normal(n).astype(np.float32),
                value=rng.standard_normal(n).astype(np.float32) if value else None,
                status=rng.integers(0, 4, n).astype(np.uint8))


# every frame kind, v1 and v2, with and without the trace extension
_S, _P, _D = _cols()
FRAMES = {
    "request-v1": lambda w: w.encode_request("desk-a", 3, _S),
    "request-v1-prices-deadlines": lambda w: w.encode_request("desk-a", -2, _S, _P, _D),
    "request-v1-block-deadline": lambda w: w.encode_request("t", 0, _S, _P, deadline_ms=12.5),
    "request-v2": lambda w: w.encode_request("desk-b", 7, _S, _P, seq=41),
    "request-v2-trace": lambda w: w.encode_request("desk-b", 7, _S, _P, _D, seq=42,
                                                   trace=(2**63 + 5, 77)),
    "request-v1-trace": lambda w: w.encode_request("x", 1, _S[:1], trace=(1, 2)),
    "request-1d-states": lambda w: w.encode_request("x", 1, _S[0]),
    "reply-v1": lambda w: w.encode_reply(w.BlockResult(**_reply())),
    "reply-v1-novalue": lambda w: w.encode_reply(w.BlockResult(**_reply(value=False))),
    "reply-v2": lambda w: w.encode_reply(w.BlockResult(**_reply()), date_idx=4, seq=9),
    "reply-v2-trace": lambda w: w.encode_reply(w.BlockResult(**_reply()), seq=9,
                                               timing=(2**64 - 1, 0.125, 3.5e-4)),
    "error-v1": lambda w: w.encode_error("n_rows=0 outside [1, 16777216] — split the block"),
    "error-v2": lambda w: w.encode_error("bad frame", seq=3),
    "ping": lambda w: w.encode_ping(),
    "pong": lambda w: w.encode_pong(),
    "hello-new": lambda w: w.encode_hello(),
    "hello-resume": lambda w: w.encode_hello(b"0123456789abcdef"),
    "welcome": lambda w: w.encode_welcome(b"0123456789abcdef", 17),
    "busy": lambda w: w.encode_busy(5, "slow down"),
    "redirect": lambda w: w.encode_redirect("10.0.0.2", 7001, seq=6),
    "metrics-ask": lambda w: w.encode_metrics(),
    "metrics": lambda w: w.encode_metrics("# TYPE x counter\nx 1\n"),
    "health-ask": lambda w: w.encode_health(),
    "health": lambda w: w.encode_health({"draining": False, "sessions": 2}),
}


class _W:
    """A codec module plus its package's BlockResult, for the frame table."""

    def __init__(self, mod, ing):
        self.mod, self.BlockResult = mod, ing.BlockResult

    def __getattr__(self, name):
        return getattr(self.mod, name)


PORT, REF = _W(wire, ingest), _W(jwire, jingest)


def _decode_all(w, buf):
    """Every decoder of ``w`` that accepts ``buf``'s kind, as plain data."""
    kind = w.decode_kind(buf)
    out = {"kind": kind, "meta": w.frame_meta(buf), "seq": w.frame_seq(buf)}
    if kind == w.KIND_REQUEST:
        req = w.decode_request(buf)
        out.update({k: (np.array(v) if isinstance(v, np.ndarray) else v)
                    for k, v in req.items()})
    elif kind == w.KIND_REPLY:
        r = w.decode_reply(buf)
        out.update(phi=np.array(r.phi), psi=np.array(r.psi), status=np.array(r.status),
                   value=None if r.value is None else np.array(r.value), timing=r.timing)
    elif kind == w.KIND_ERROR:
        out["msg"] = w.decode_error(buf)
    elif kind == w.KIND_HELLO:
        out["token"] = w.decode_hello(buf)
    elif kind == w.KIND_WELCOME:
        out["welcome"] = w.decode_welcome(buf)
    elif kind == w.KIND_BUSY:
        out["busy"] = w.decode_busy(buf)
    elif kind == w.KIND_REDIRECT:
        out["redirect"] = w.decode_redirect(buf)
    elif kind == w.KIND_METRICS:
        out["metrics"] = w.decode_metrics(buf)
    elif kind == w.KIND_HEALTH:
        out["health"] = w.decode_health(buf)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", list(FRAMES))
def test_wire_frames_byte_identical_and_cross_decoded(name):
    port, ref = FRAMES[name](PORT), FRAMES[name](REF)
    assert port == ref
    # each package decodes the other's frame to the same data
    _same(_decode_all(PORT, ref), _decode_all(REF, port))
    _same(_decode_all(PORT, port), _decode_all(REF, ref))
    assert wire.HEADER_BYTES == jwire.HEADER_BYTES and wire.HEADER_V2_BYTES == jwire.HEADER_V2_BYTES


MALFORMED = {
    "short": b"ORPI",
    "magic": b"XXXX" + FRAMES["request-v1"](REF)[4:],
    "version": FRAMES["request-v1"](REF)[:4] + b"\x07" + FRAMES["request-v1"](REF)[5:],
    "truncated": FRAMES["request-v2"](REF)[:-3],
    "oversized": FRAMES["request-v1"](REF) + b"\x00",
    "v2-kind-in-v1": FRAMES["ping"](REF)[:5] + bytes([jwire.KIND_HELLO]) + FRAMES["ping"](REF)[6:],
    "tenant-not-ascii": (FRAMES["request-v1"](REF)[:8] + b"\xff" * 16
                         + FRAMES["request-v1"](REF)[24:]),
    "reply-truncated": FRAMES["reply-v1"](REF)[:-1],
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_wire_refusals_match(name):
    buf = MALFORMED[name]
    decode = "decode_reply" if name.startswith("reply") else "decode_request"
    with pytest.raises(jwire.WireError) as want:
        getattr(jwire, decode)(buf)
    with pytest.raises(wire.WireError) as got:
        getattr(wire, decode)(buf)
    assert str(got.value) == str(want.value)


def test_wire_encode_refusals_match():
    for call in (lambda w: w.encode_request("a-tenant-name-too-long", 0, _S),
                 lambda w: w.encode_request("t", 0, _S, _P[:2]),
                 lambda w: w.encode_hello(b"short"),
                 lambda w: w.encode_welcome(b"short", 0)):
        with pytest.raises(jwire.WireError) as want:
            call(jwire)
        with pytest.raises(wire.WireError) as got:
            call(wire)
        assert str(got.value) == str(want.value)


def _blocks(mod, now):
    """Three blocks through one shed schedule: a watermark tail, a deadline
    mask at an injected instant, both; each package's ``Block``."""
    s, p, d = _cols(n=9, seed=3)
    out = []
    for i, (keep, t_check) in enumerate([(6, now + 0.1), (9, now + 0.3), (2, now + 0.45)]):
        dl = mod.as_deadline_column(d, 9, now, None) if i != 1 else \
            mod.as_deadline_column(0.25, 9, now, 1.0)
        blk = mod.Block(i, s, p, None, now, dl)
        n_wm = blk.shed_tail(keep, mod.SHED_WATERMARK)
        n_dl = blk.mask_expired(t_check)
        out.append((blk.status.copy(), n_wm, n_dl, blk.n_live,
                    [np.array(c) for c in blk.live_columns() if c is not None]))
    return out


def test_block_status_columns_under_one_shed_schedule():
    now = 1000.0  # the injected clock: every instant is an argument
    for (st, wm, dl, live, cols), (jst, jwm, jdl, jlive, jcols) in zip(
            _blocks(ingest, now), _blocks(jingest, now)):
        assert np.array_equal(st, jst) and (wm, dl, live) == (jwm, jdl, jlive)
        assert all(np.array_equal(a, b) for a, b in zip(cols, jcols))
    # the result helpers
    r = _reply(n=4)
    for mod in (ingest, jingest):
        assert mod.STATUS_NAMES == ingest.STATUS_NAMES
    got = ingest.merge_tail_shed(ingest.BlockResult(**r), 3, ingest.SHED_QUOTA)
    want = jingest.merge_tail_shed(jingest.BlockResult(**r), 3, jingest.SHED_QUOTA)
    for f in ("phi", "psi", "value", "status"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.shed_counts() == want.shed_counts() and got.n_served == want.n_served
    both = ingest.concat_results([got, ingest.all_shed_result(2, ingest.SHED_DEADLINE,
                                                              has_value=True)])
    jboth = jingest.concat_results([want, jingest.all_shed_result(2, jingest.SHED_DEADLINE,
                                                                  has_value=True)])
    assert np.array_equal(both.status, jboth.status) and both.shed_counts() == jboth.shed_counts()
    with pytest.raises(ValueError, match="deadlines column has shape"):
        ingest.as_deadline_column(np.ones(3), 4, 0.0, None)


PLANS = [([5, 1000, 24, 24, 300], None), ([1040], None), ([8, 8, 8, 8, 8, 8, 8, 8], None),
         ([3000, 70, 70, 2000, 1], {8: 1e-5, 1024: 4e-5, 4096: 9e-5}),
         ([1040, 16, 512], {16: 2e-6, 2048: 8e-5})]


@pytest.mark.parametrize("counts, profile", PLANS)
def test_bucket_planner_plans_equal(counts, profile):
    kw = dict(pad_waste_threshold=0.2, overhead_rows=48.0, max_splits=3)
    got, want = BucketPlanner(**kw), JBucketPlanner(**kw)
    if profile:
        stats = {str(b): {"device_s_median": s} for b, s in profile.items()}
        got.feed_profile(stats)
        want.feed_profile(stats)
    assert got.plan(counts) == want.plan(counts)
    for n in counts:
        assert got.split_rows(n) == want.split_rows(n)
        assert got.cost(got.bucket_for(n)) == want.cost(want.bucket_for(n))
    assert got.pad_waste_rows(counts, got.plan(counts)) == \
        want.pad_waste_rows(counts, want.plan(counts))


def test_cooldown_schedule_equal():
    log = []
    for mod in (Cooldown, JCooldown):
        t = [0.0]
        cd = mod(cooldown_s=10.0, backoff=3.0, max_backoff_s=100.0, clock=lambda: t[0])
        seq = [cd.ready()]
        for step, dt in (("fire", 1.0), ("reject", 4.0), ("reject", 25.0), ("reject", 7.0),
                         ("promote", 50.0), ("fire", 2.0), ("reject", 200.0)):
            getattr(cd, f"note_{step}")()
            t[0] += dt
            seq.append((cd.ready(), cd.remaining(), cd.snapshot()))
        log.append(seq)
    assert log[0] == log[1]
    with pytest.raises(ValueError, match="backoff="):
        Cooldown(backoff=0.5)


def test_guard_policy_and_breaker_equal():
    for kw in (dict(), dict(deadline_ms=5.0, queue_watermark=64, max_retries=3, backoff_ms=2.0,
                            backoff_cap_ms=5.0, hard_wall_ms=100.0)):
        got, want = GuardPolicy(**kw), JGuardPolicy(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [got.backoff_s(a) for a in range(1, 6)] == [want.backoff_s(a) for a in range(1, 6)]
    for bad in (dict(deadline_ms=0), dict(queue_watermark=0), dict(max_retries=-1),
                dict(hard_wall_ms=-1.0)):
        with pytest.raises(ValueError) as want:
            JGuardPolicy(**bad)
        with pytest.raises(ValueError) as got:
            GuardPolicy(**bad)
        assert str(got.value) == str(want.value)
    events = []
    for mod in (CircuitBreaker, JCircuitBreaker):
        br = mod(threshold=2)
        events.append([br.record_failure(8), br.record_failure(8), br.record_failure(8),
                       br.record_failure("hang:8"), br.record_success("hang:8"),
                       br.record_failure("hang:8"), br.record_failure("hang:8"),
                       br.is_open(8), br.open_keys])
    assert events[0] == events[1]


def _features(seed=0, n=4096, knots=9, f=3):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.2 * rng.standard_normal((n, knots, f))).astype(np.float32)


def test_feature_sketch_and_drift_verdicts_equal():
    x = _features()
    got, want = quality.FeatureSketch.from_features(x), jquality.FeatureSketch.from_features(x)
    assert got.to_meta() == want.to_meta()
    assert quality.FeatureSketch.from_meta(want.to_meta()) == got
    # the pipelines sketch their features as a tensor, on its device
    tens = quality.FeatureSketch.from_features(torch.from_numpy(x))
    np.testing.assert_allclose(
        np.concatenate([np.ravel(v) for v in tens.to_meta().values() if not isinstance(v, dict)]
                       + [np.ravel(v) for v in tens.quantiles.values()]),
        np.concatenate([np.ravel(v) for v in got.to_meta().values() if not isinstance(v, dict)]
                       + [np.ravel(v) for v in got.quantiles.values()]), rtol=1e-12)
    # the same block stream through both monitors: scores, trips and latches
    rng = np.random.default_rng(4)
    mons = [quality.DriftMonitor(got, band=0.8, min_rows=64, half_life_rows=512),
            jquality.DriftMonitor(want, band=0.8, min_rows=64, half_life_rows=512)]
    for i in range(24):
        shift = 0.0 if i < 8 else (0.5 if i < 16 else 0.0)
        blk = (1.0 + shift + 0.2 * rng.standard_normal((100, 3))).astype(np.float32)
        if i == 5:
            blk[3, 1] = np.nan
        scores = [m.update(blk) for m in mons]
        assert scores[0] == scores[1]
    assert mons[0].scores() == mons[1].scores() and mons[0].trips == mons[1].trips == 1
    assert mons[0].update(np.ones((4, 2))) == mons[1].update(np.ones((4, 2)))


@pytest.mark.parametrize("kw", [
    dict(n_features=1),
    dict(n_features=3, constrain_self_financing=False),
    dict(n_features=5, n_hedge_assets=5, hidden=(8, 8)),
    dict(n_features=1, constrain_self_financing=True, negative_slope=0.2),
], ids=["north-star", "pension", "vector", "constrained"])
def test_policy_fingerprint_equal(kw):
    jkw = dict(kw, dtype=jnp.float32)
    for combine in (dict(dual_mode="mse_only", holdings_combine="single", cost_of_capital=0.0),
                    dict(dual_mode="shared", holdings_combine="py", cost_of_capital=0.1)):
        assert policy_fingerprint(HedgeMLP(**kw), 40, **combine) == \
            jpolicy_fingerprint(JHedgeMLP(**jkw), 40, **combine)


def test_validation_spec_meta_and_validator_equal():
    spec = quality.ValidationSpec(kind="heston-qe", n_steps=16, rebalance_every=4, n_paths=64,
                                  replicates=3)
    jspec = jquality.ValidationSpec(**spec.to_meta())
    assert spec.fingerprint() == jspec.fingerprint() and spec.n_dates == jspec.n_dates
    for bad in (dict(kind="sabr"), dict(n_steps=10, rebalance_every=4), dict(replicates=1)):
        with pytest.raises(ValueError) as want:
            jquality.ValidationSpec(**bad)
        with pytest.raises(ValueError) as got:
            quality.ValidationSpec(**bad)
        assert str(got.value) == str(want.value)
    bad_rec = {"schema": "orp-quality-v0", "n_dates": 2, "per_date": [{}],
               "hedge_error": {"mean": float("nan"), "ci95": "x"}}
    assert quality.validate_quality_record(bad_rec) == jquality.validate_quality_record(bad_rec)
    assert quality._t975(4) == jquality._t975(4) and quality._t975(11) == jquality._t975(11)
