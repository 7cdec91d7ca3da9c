"""Port parity: the closed-loop pilot (``orp_tpu_torch/pilot/``) against the
JAX package's (``orp_tpu/pilot/``), mirroring ``tests/test_pilot.py``.

- calibration: ``calibrate_window`` / ``bootstrap_ci`` / ``calibrate_rolling``
  equal JAX's BITWISE on the same prices (the port's Owen-scrambled Sobol is
  bitwise JAX's and the refits are the same numpy code); ``shift_significant``
  gives the same verdicts; a baked ``calibration.json`` reads in both;
- the ``orp-pilot-v1`` journal: either package reads and appends to the
  other's, the same calls write equal records but for ``ts_unix``, the torn
  tail heals, a torn middle raises, unconsumed requests survive a restart;
- ``warm_params`` of the same policy: bitwise across packages;
- the controller on a tiny policy (256 paths, 4 dates, on the CPU): a clean
  promote emits no guard event, a reject leaves the incumbent serving
  bitwise and escalates the cooldown, a NaN-poisoned retrain degrades
  without aborting, a kill mid-training resumes bitwise from the journal,
  and the journal's state sequence equals the JAX controller's;
- the warm-started retrain's walk: held to JAX's in float64 at the walk's
  band (rtol 1e-7);
- ``_pilot_phase(quick=True)``: the contract fields equal the JAX drill's.

The slow tests run on one torch intra-op thread (module fixture), as the
other slow port files do under ``-n 6``; no test gates on a wall clock.
"""

import contextlib
import dataclasses
import hashlib
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orp_tpu import api as japi
from orp_tpu import guard as jguard
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.pilot import calibrate as jcal
from orp_tpu.pilot import journal as jjournal
from orp_tpu.pilot import triggers as jtriggers
from orp_tpu.pilot.controller import PilotConfig as JPilotConfig
from orp_tpu.pilot.controller import PilotController as JPilotController
from orp_tpu.pilot.controller import warm_params as jwarm_params
from orp_tpu.serve import ServeHost as JServeHost
from orp_tpu.serve import export_bundle as jexport_bundle
from orp_tpu.serve.bench import _pilot_market as jpilot_market
from orp_tpu.train.backward import BackwardConfig as JBackwardConfig
from orp_tpu.train.backward import backward_induction as jbackward_induction
from orp_tpu_torch import guard, obs
from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu_torch.calib.cir import CalibrationFit, CIRParams
from orp_tpu_torch.guard import Cooldown, FaultPlan
from orp_tpu_torch.guard.inject import WalkKilled
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.obs.manifest import chain_verify, read_chain
from orp_tpu_torch.pilot import (PilotConfig, PilotController, TriggerEvent, TriggerHub,
                                 bake_calibration, bootstrap_ci, calibrate_rolling,
                                 calibrate_window, journal_append, last_cycle, read_calibration,
                                 read_journal, shift_significant, unconsumed_requests,
                                 validate_pilot_record, warm_params)
from orp_tpu_torch.pilot import calibrate as _calibrate
from orp_tpu_torch.pilot import journal as _journal
from orp_tpu_torch.pilot.controller import _window_from_meta
from orp_tpu_torch.qmc import gbm_log_plain
from orp_tpu_torch.serve import ServeHost, export_bundle, load_bundle
from orp_tpu_torch.serve.bench import _pilot_market, _pilot_phase
from orp_tpu_torch.train import BackwardConfig, backward_induction

from test_torch_serve import _pair

EURO = EuropeanConfig()
SIM = SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2)  # 4 dates
FIRST = TrainConfig(dual_mode="mse_only", epochs_first=12, epochs_warm=6)
RETRAIN = TrainConfig(dual_mode="mse_only", epochs_first=6, epochs_warm=3)
JSIM = japi.SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2)
JFIRST = japi.TrainConfig(dual_mode="mse_only", epochs_first=12, epochs_warm=6)
JRETRAIN = japi.TrainConfig(dual_mode="mse_only", epochs_first=6, epochs_warm=3)

# the synthetic market the drill calibrates: CIR vol mean-reverting to b
CALM = dict(a=4.0, b=0.15, c=0.2, mu=0.08, sigma0=0.15)
SHIFT = dict(a=4.0, b=0.45, c=0.3, mu=0.08, sigma0=0.4)
KEYS = ("a", "b", "c", "mu", "sigma0")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def calm_prices():
    return _pilot_market(240, seed=7, **CALM)


@pytest.fixture(scope="module")
def shifted_prices():
    return _pilot_market(176, seed=8, **SHIFT)


@pytest.fixture(scope="module")
def calm_window(calm_prices):
    return calibrate_window(calm_prices[-160:], vol_window=40, n_boot=12, seed=0)


@pytest.fixture(scope="module")
def trained():
    return european_hedge(EURO, SIM, FIRST, device="cpu")


def _train_fn(rc, sabotage):
    def train_fn(window, warm, ckpt_dir):
        res = european_hedge(dataclasses.replace(EURO, sigma=float(window.fit.sigma0)), SIM,
                             dataclasses.replace(rc, checkpoint_dir=ckpt_dir),
                             warm_start=warm, device="cpu")
        if sabotage[0]:
            bw = res.backward
            res = dataclasses.replace(res, backward=dataclasses.replace(
                bw, params1_by_date={k: -v for k, v in bw.params1_by_date.items()}))
        return res
    return train_fn


@contextlib.contextmanager
def _rig(trained, calm_window, tmp_path, *, retrain_cfg=None):
    """One tenant's closed loop on a live CPU host: the incumbent exported
    with the calm calibration baked, a fake-clock trigger hub (no sleeps),
    and the drill's train_fn with a togglable sabotage flag (negated per-date
    params — the finite-but-wrong candidate only the quality band catches)."""
    inc = tmp_path / "incumbent"
    export_bundle(trained, inc)
    bake_calibration(inc, calm_window)
    cfg = PilotConfig(tenant="desk", workdir=str(tmp_path / "pilot"), calib_window=160,
                      vol_window=40, n_boot=12, cooldown_s=60.0, backoff=2.0)
    clk = [0.0]
    hub = TriggerHub("desk", cooldown=Cooldown(cooldown_s=60.0, backoff=2.0,
                                               clock=lambda: clk[0]))
    sabotage = [False]
    train_fn = _train_fn(RETRAIN if retrain_cfg is None else retrain_cfg, sabotage)
    with ServeHost(promotion_chain=tmp_path / "promotions.jsonl",
                   engine_kwargs={"device": "cpu"}) as host:
        host.add_tenant("desk", inc)
        ctl = PilotController(host, cfg, train_fn, hub=hub)
        yield host, ctl, inc, clk, sabotage, train_fn


def _params_equal(a: dict, b: dict) -> bool:
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return sorted(a) == sorted(b) and all(np.array_equal(host(a[k]), host(b[k])) for k in a)


def _dir_digest(d: pathlib.Path) -> str:
    h = hashlib.sha256()
    for p in sorted(d.rglob("*")):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


# -- calibration: fit, bands, significance gate -------------------------------


def test_pilot_market_is_the_reference_generator():
    for seed, kw in ((7, CALM), (8, SHIFT)):
        np.testing.assert_array_equal(_pilot_market(240, seed=seed, **kw),
                                      jpilot_market(240, seed=seed, **kw))


@pytest.mark.parametrize("n_boot, seed", [(12, 0), (24, 11)])
def test_calibrate_window_equals_jax_bitwise(calm_prices, n_boot, seed):
    got = calibrate_window(calm_prices[-160:], vol_window=40, n_boot=n_boot, seed=seed)
    want = jcal.calibrate_window(calm_prices[-160:], vol_window=40, n_boot=n_boot, seed=seed)
    assert got.fit.as_dict() == want.fit.as_dict()
    assert got.ci == want.ci and got.n_failed == want.n_failed
    assert got.to_meta() == want.to_meta()


def test_sobol_unit_and_bootstrap_ci_equal_jax(shifted_prices):
    np.testing.assert_array_equal(_calibrate._sobol_unit(24, 13, 5),
                                  jcal._sobol_unit(24, 13, 5))
    for block in (None, 12):
        got = bootstrap_ci(shifted_prices, vol_window=40, n_boot=16, seed=3, block=block)
        want = jcal.bootstrap_ci(shifted_prices, vol_window=40, n_boot=16, seed=3, block=block)
        assert got == want


def test_calibrate_rolling_equals_jax(calm_prices):
    got = calibrate_rolling(calm_prices, window=120, n_boot=8, seed=3)
    want = jcal.calibrate_rolling(calm_prices, window=120, n_boot=8, seed=3)
    assert len(got) == len(want) >= 2
    assert [w.to_meta() for w in got] == [w.to_meta() for w in want]


def test_calibrate_window_recovers_generator(calm_window):
    """The rolling-window fit recovers the CIR generator it watched and every
    parameter carries a finite, ordered bootstrap band; to_meta round-trips
    through the journal rebuild path."""
    fit = calm_window.fit
    assert 0.05 < fit.params.b < 0.30          # generator b = 0.15
    assert fit.sigma0 > 0 and fit.params.a > 0
    for k in KEYS:
        lo, hi = calm_window.ci[k]
        assert np.isfinite(lo) and np.isfinite(hi) and lo < hi
    assert calm_window.n_failed < calm_window.n_boot // 2
    rebuilt = _window_from_meta(calm_window.to_meta())
    assert rebuilt.fit.as_dict() == calm_window.fit.as_dict()
    assert rebuilt.ci == {k: tuple(v) for k, v in calm_window.to_meta()["ci"].items()}


def test_bootstrap_collapse_raises(monkeypatch, calm_prices):
    monkeypatch.setattr(_calibrate, "calibrate_prices",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("no reversion")))
    with pytest.raises(ValueError, match="bootstrap collapsed"):
        bootstrap_ci(calm_prices, vol_window=40, n_boot=8, seed=0)


@pytest.mark.parametrize("b, band", [(0.33, [0.10, 0.20]), (0.15, [0.10, 0.20]),
                                     (0.10, [0.10, 0.20]), (0.2000001, [0.10, 0.20])])
def test_shift_significance_gate_matches_jax(b, band):
    """The churn gate: a point inside the baked band is noise, outside it is
    signal — the same verdicts and detail in both packages."""
    from orp_tpu.calib.cir import CalibrationFit as JFit
    from orp_tpu.calib.cir import CIRParams as JParams

    kw = dict(mu=0.08, sigma0=0.3, n_prices=160, vol_window=40)
    got = shift_significant(CalibrationFit(params=CIRParams(a=4.0, b=b, c=0.2), **kw),
                            {"ci": {"b": band}})
    want = jcal.shift_significant(JFit(params=JParams(a=4.0, b=b, c=0.2), **kw),
                                  {"ci": {"b": band}})
    assert got == want
    assert got[0] == (not band[0] <= b <= band[1])


def test_bake_and_read_calibration_cross_package(tmp_path, calm_window):
    assert read_calibration(tmp_path) is None   # pre-pilot bundle
    bake_calibration(tmp_path / "port", calm_window)
    assert jcal.read_calibration(tmp_path / "port") == calm_window.to_meta()
    jwin = jcal.calibrate_window(_pilot_market(240, seed=7, **CALM)[-160:], vol_window=40,
                                 n_boot=12, seed=0)
    jcal.bake_calibration(tmp_path / "jax", jwin)
    assert read_calibration(tmp_path / "jax") == calm_window.to_meta()
    assert ((tmp_path / "jax" / "calibration.json").read_bytes()
            == (tmp_path / "port" / "calibration.json").read_bytes())


def test_check_calibration_gate_in_the_hub(calm_window):
    hub = TriggerHub("desk")
    ev = hub.check_calibration(calm_window, None)
    assert ev is not None and ev.source == "calibration"
    point = calm_window.fit.as_dict()
    wide = {"ci": {k: [point[k] - 1.0, point[k] + 1.0] for k in KEYS}}
    assert hub.check_calibration(calm_window, wide) is None
    narrow = {"ci": {"b": [point["b"] + 0.5, point["b"] + 0.6]}}
    ev = hub.check_calibration(calm_window, narrow)
    jev = jtriggers.TriggerHub("desk").check_calibration(calm_window, narrow)
    assert ev is not None and "b" in ev.reason
    assert (ev.source, ev.reason, ev.payload) == (jev.source, jev.reason, jev.payload)


# -- the orp-pilot-v1 journal -------------------------------------------------


_CALLS = ({"kind": "config", "tenant": "desk", "calib_window": 160},
          {"kind": "transition", "cycle": 0, "state": "calibrating", "trigger_seq": None},
          {"kind": "trigger_request", "source": "manual", "tenant": "desk"},
          {"kind": "transition", "cycle": 0, "state": "training", "checkpoint_dir": "/x"},
          {"kind": "transition", "cycle": 0, "state": "promoted", "chain": None})


def test_journal_envelope_and_seq(tmp_path):
    jp = tmp_path / "pilot.jsonl"
    a = journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating"})
    b = journal_append(jp, {"kind": "trigger_request", "source": "manual"})
    assert a["schema"] == "orp-pilot-v1" and a["seq"] == 0
    assert b["seq"] == 1 and "ts_unix" in b
    records, problems = read_journal(jp)
    assert problems == [] and [r["seq"] for r in records] == [0, 1]
    c = journal_append(jp, {"kind": "config", "schema": None, "seq": 99})
    assert c["seq"] == 2 and c["schema"] == "orp-pilot-v1"


def test_journal_same_calls_equal_records(tmp_path):
    """The same calls through both packages write equal records but for the
    wall-clock stamp, line for line in the same canonical encoding."""
    for mod, name in ((_journal, "port"), (jjournal, "jax")):
        for rec in _CALLS:
            mod.journal_append(tmp_path / f"{name}.jsonl", dict(rec))

    def strip(path):
        return [{k: v for k, v in json.loads(ln).items() if k != "ts_unix"}
                for ln in path.read_text().splitlines()]
    assert strip(tmp_path / "port.jsonl") == strip(tmp_path / "jax.jsonl")
    for lp, lj in zip((tmp_path / "port.jsonl").read_text().splitlines(),
                      (tmp_path / "jax.jsonl").read_text().splitlines()):
        assert lp.split('"ts_unix"')[0] == lj.split('"ts_unix"')[0]


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_journal_cross_package_read_and_append(tmp_path, writer, reader):
    mods = {"port": _journal, "jax": jjournal}
    jp = tmp_path / "pilot.jsonl"
    for rec in _CALLS[:3]:
        mods[writer].journal_append(jp, dict(rec))
    with open(jp, "a") as f:
        f.write('{"kind": "transition", "cy')   # a torn tail, healed by the reader's append
    records, problems = mods[reader].read_journal(jp)
    assert [r["seq"] for r in records] == [0, 1, 2] and len(problems) == 1
    out = mods[reader].journal_append(jp, dict(_CALLS[3]))
    assert out["seq"] == 3
    for mod in mods.values():
        records, problems = mod.read_journal(jp)
        assert problems == [] and [r["seq"] for r in records] == [0, 1, 2, 3]
        assert [r["seq"] for r in mod.unconsumed_requests(records)] == [2]
        assert mod.last_cycle(records)[0] == 0
        assert mod.latest_config(records)["calib_window"] == 160


def test_journal_validation_refuses_garbage(tmp_path):
    jp = tmp_path / "pilot.jsonl"
    bad = ({"kind": "nonsense"}, {"kind": "transition", "state": "training"},
           {"kind": "transition", "cycle": 0, "state": "limbo"}, {"kind": "trigger_request"},
           {"kind": "config", "schema": "orp-pilot-v0"}, [1, 2])
    for rec, match in zip(bad, ("kind", "cycle", "state", "source", "schema")):
        with pytest.raises(ValueError, match=match):
            journal_append(jp, rec)
    for rec in bad:
        assert validate_pilot_record(rec) == jjournal.validate_pilot_record(rec)
    assert not jp.exists()                      # nothing invalid landed


def test_journal_torn_tail_tolerated_and_healed(tmp_path):
    jp = tmp_path / "pilot.jsonl"
    journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating"})
    with open(jp, "a") as f:
        f.write('{"kind": "transition", "cycle": 0, "sta')   # torn, no \n
    records, problems = read_journal(jp)
    assert len(records) == 1 and len(problems) == 1
    healed = journal_append(jp, {"kind": "transition", "cycle": 0, "state": "training"})
    assert healed["seq"] == 1
    records, problems = read_journal(jp)
    assert problems == [] and [r["state"] for r in records
                               if r["kind"] == "transition"] == ["calibrating", "training"]


def test_journal_torn_middle_raises(tmp_path):
    jp = tmp_path / "pilot.jsonl"
    journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating"})
    jp.write_text("{broken\n" + jp.read_text())
    with pytest.raises(ValueError, match="not the torn tail"):
        read_journal(jp)


def test_unconsumed_requests_survive_restart(tmp_path):
    jp = tmp_path / "pilot.jsonl"
    req = journal_append(jp, {"kind": "trigger_request", "source": "manual", "tenant": "desk"})
    records, _ = read_journal(jp)
    assert [r["seq"] for r in unconsumed_requests(records)] == [req["seq"]]
    journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating",
                        "trigger_seq": req["seq"]})
    records, _ = read_journal(jp)
    assert unconsumed_requests(records) == []


# -- triggers: debounce, backoff, incremental drift ---------------------------


def test_cooldown_backoff_escalates_and_resets():
    clk = [0.0]
    c = Cooldown(cooldown_s=10.0, backoff=2.0, max_backoff_s=35.0, clock=lambda: clk[0])
    assert c.ready()
    c.note_fire()
    assert not c.ready() and c.remaining() == pytest.approx(10.0)
    c.note_reject()
    assert c.snapshot()["window_s"] == pytest.approx(20.0)
    c.note_reject()
    snap = c.snapshot()
    assert snap["window_s"] == pytest.approx(35.0) and snap["consecutive_rejects"] == 2
    clk[0] += 35.0
    assert c.ready()
    c.note_promote()
    assert c.snapshot()["window_s"] == pytest.approx(10.0)


def test_hub_debounce_is_the_one_door():
    clk = [0.0]
    hub = TriggerHub("desk", cooldown=Cooldown(cooldown_s=60.0, clock=lambda: clk[0]))
    ev = TriggerEvent(source="manual", tenant="desk", reason="test")
    reg, sink = obs.Registry(), obs.ListSink()
    with obs.active(reg, sink):
        assert hub.accept(ev)  # orp: noqa[ORP014] -- the debounce door, not a socket
        assert not hub.accept(ev)  # orp: noqa[ORP014] -- the debounce door, not a socket
        clk[0] += 61.0
        assert hub.accept(ev)  # orp: noqa[ORP014] -- the debounce door, not a socket
    names = [e["name"] for e in sink.events if e["type"] == "counter"]
    assert names.count("pilot/trigger") == 2 and names.count("pilot/debounced") == 1


def test_poll_drift_is_incremental_and_matches_jax():
    events = [{"kind": "drift_trip", "tenant": "desk", "score": 9.0, "band": 3.0, "rows": 256},
              {"kind": "drift_trip", "tenant": "other", "score": 9.0, "band": 3.0, "rows": 256},
              {"kind": "degrade", "tenant": "desk"}]
    hub, jhub = TriggerHub("desk"), jtriggers.TriggerHub("desk")
    got, want = hub.poll_drift(events), jhub.poll_drift(events)
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert [e.source for e in got] == ["drift"] and got[0].payload["score"] == 9.0
    assert hub.poll_drift(events) == []
    events.append({"kind": "drift_trip", "tenant": "desk", "score": 11.0, "band": 3.0,
                   "rows": 512})
    assert len(hub.poll_drift(events)) == len(jhub.poll_drift(events)) == 1
    recs = [{"kind": "trigger_request", "source": "manual", "tenant": t, "seq": i,
             "reason": r} for i, (t, r) in enumerate((("desk", None), ("other", "x"),
                                                        (None, "any tenant")))]
    assert ([dataclasses.astuple(e) for e in hub.poll_manual(recs)]
            == [dataclasses.astuple(e) for e in jhub.poll_manual(recs)])


@pytest.mark.parametrize("dual_mode", ["mse_only", "separate"])
def test_warm_params_bitwise_across_packages(dual_mode):
    """``warm_params`` of the same policy picks the first visited date (index
    -1) in both packages, bitwise."""
    jpol, tpol = _pair(n_dates=5, dual_mode=dual_mode, seed=3)
    (p1, p2), (q1, q2) = warm_params(tpol), jwarm_params(jpol)
    assert _params_equal(p1, q1)
    assert (p2 is None) == (q2 is None) == (dual_mode == "mse_only")
    if p2 is not None:
        assert _params_equal(p2, q2)
    assert _params_equal(p1, {k: v[-1] for k, v in tpol.backward.params1_by_date.items()})
    with pytest.raises(ValueError, match="warm-start"):
        warm_params(dataclasses.replace(tpol, backward=dataclasses.replace(
            tpol.backward, params1_by_date=None)))


def test_warm_started_walk_matches_jax_in_f64():
    """The retrain is a warm-started walk: from the same policy's warm params
    and the same paths, the port's f64 GN walk equals JAX's at rtol 1e-7."""
    jpol, tpol = _pair(n_features=1, n_dates=8, seed=5)
    warm = tuple(None if p is None else {k: v.astype(np.float64) for k, v in p.items()}
                 for p in warm_params(tpol))
    s = gbm_log_plain(512, 16, s0=1.0, drift=0.08, sigma=0.15, dt=1 / 16, seed=2,
                      store_every=2).exp().double().numpy()
    b = np.exp(0.08 * np.linspace(0.0, 1.0, 9))
    term = np.maximum(s[:, -1] - 1.0, 0.0)
    args = (s[..., None], s, b, term)
    cfg = dict(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=8,
               gn_iters_warm=4)
    want = jbackward_induction(JHedgeMLP(n_features=1, hidden=(8, 8), dtype=jnp.float64),
                               *(jnp.asarray(a) for a in args), JBackwardConfig(**cfg),
                               initial_params=warm)
    got = backward_induction(HedgeMLP(n_features=1, hidden=(8, 8), dtype=torch.float64),
                             *(torch.tensor(a) for a in args), BackwardConfig(**cfg),
                             initial_params=warm)
    for k in ("values", "phi", "psi"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
    for k, v in want.params1_by_date.items():
        np.testing.assert_allclose(got.params1_by_date[k].numpy(), np.asarray(v), rtol=1e-7,
                                   atol=1e-10, err_msg=k)


# -- controller chaos bars ----------------------------------------------------


def test_clean_promote_cycle_emits_zero_guard_events(trained, calm_window, shifted_prices,
                                                     tmp_path):
    with _rig(trained, calm_window, tmp_path) as (host, ctl, inc, clk, _, _):
        v0 = host.stats()["desk"]["version"]
        reg, sink = obs.Registry(), obs.ListSink()
        with obs.active(reg, sink):
            out = ctl.run_cycle(TriggerEvent(source="manual", tenant="desk", reason="test"),
                                shifted_prices)
        assert out["outcome"] == "promoted"
        assert host.stats()["desk"]["version"] == v0 + 1
        assert [e for e in sink.events if e.get("name", "").startswith("guard/")] == []
        records, problems = read_journal(ctl.journal_path)
        assert problems == []
        cid, recs = last_cycle(records)
        assert cid == 0 and [r["state"] for r in recs] == [
            "calibrating", "training", "exporting", "canary", "promoted"]
        chain = tmp_path / "promotions.jsonl"
        assert chain_verify(chain)["ok"]
        assert "promote" in [r["action"] for r in read_chain(chain)]


def test_reject_leaves_incumbent_bitwise_and_escalates(trained, calm_window, shifted_prices,
                                                       tmp_path):
    with _rig(trained, calm_window, tmp_path) as (host, ctl, inc, clk, sabotage, _):
        before = _dir_digest(inc)
        v0 = host.stats()["desk"]["version"]
        rows = np.linspace(0.9, 1.1, 16, dtype=np.float32)[:, None]
        served = host.submit_block("desk", 1, rows).result(timeout=60)
        sabotage[0] = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the reject warns by design
            out = ctl.run_cycle(TriggerEvent(source="manual", tenant="desk", reason="test"),
                                shifted_prices)
        assert out["outcome"] == "rejected" and "regression" in out["why"]
        assert _dir_digest(inc) == before
        assert host.stats()["desk"]["version"] == v0
        assert str(host.tenant_source("desk")) == str(inc)
        again = host.submit_block("desk", 1, rows).result(timeout=60)
        np.testing.assert_array_equal(again.phi, served.phi)
        np.testing.assert_array_equal(again.psi, served.psi)
        snap = ctl.hub.cooldown.snapshot()
        assert snap["window_s"] == pytest.approx(120.0)   # 60 x backoff 2
        assert snap["consecutive_rejects"] == 1 and snap["remaining_s"] > 0
        assert "reject" in [r["action"] for r in read_chain(tmp_path / "promotions.jsonl")]
        _, recs = last_cycle(read_journal(ctl.journal_path)[0])
        assert recs[-1]["state"] == "rejected"
        assert recs[-1]["cooldown"]["consecutive_rejects"] == 1


def test_nan_poisoned_retrain_degrades_without_aborting(trained, calm_window, shifted_prices,
                                                        tmp_path):
    with _rig(trained, calm_window, tmp_path,
              retrain_cfg=dataclasses.replace(RETRAIN, nan_guard=True)) as (
            host, ctl, inc, clk, _, _):
        reg, sink = obs.Registry(), obs.ListSink()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with obs.active(reg, sink):
                with guard.faults(FaultPlan(seed=3, nan_dates=frozenset({1}), nan_frac=0.02)):
                    out = ctl.run_cycle(TriggerEvent(source="manual", tenant="desk",
                                                     reason="test"), shifted_prices)
        assert out["outcome"] == "promoted"
        names = [e["name"] for e in sink.events if e["type"] == "counter"]
        assert "guard/nan_event" in names and "guard/degrade" in names
        assert any("guard: non-finite" in str(w.message) for w in caught)
        _, recs = last_cycle(read_journal(ctl.journal_path)[0])
        assert recs[-1]["state"] == "promoted"


def test_kill_mid_training_resumes_bitwise_from_journal(trained, calm_window, shifted_prices,
                                                        tmp_path):
    with _rig(trained, calm_window, tmp_path) as (host, ctl, inc, clk, _, train_fn):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the kill warns by design
            with guard.faults(FaultPlan(kill_after_step=1)):
                with pytest.raises(WalkKilled):
                    ctl.run_cycle(TriggerEvent(source="manual", tenant="desk", reason="test"),
                                  shifted_prices)
        records, _ = read_journal(ctl.journal_path)
        cid, recs = last_cycle(records)
        assert recs[-1]["state"] == "training"  # parked mid-cycle
        ckpt = pathlib.Path(recs[-1]["checkpoint_dir"])
        assert sorted(p.name for p in ckpt.glob("orp_step_*.npz"))  # the completed dates
        ctl2 = PilotController(host, ctl.cfg, train_fn, hub=ctl.hub)
        out = ctl2.resume()
        assert out is not None and out["outcome"] == "promoted" and out["cycle"] == cid
        assert ctl2.resume() is None
        train_rec = {r["state"]: r for r in last_cycle(read_journal(ctl.journal_path)[0])[1]
                     }["training"]
        window = _window_from_meta(train_rec["calibration"])
        warm = warm_params(load_bundle(train_rec["incumbent"]))
        # the same calibration + warm start resolve to the same checkpoint dir
        assert ctl2._ckpt_dir(window, ctl2._warm_from(train_rec["incumbent"])[1]) == ckpt
        ref = train_fn(window, warm, None)
        promoted = load_bundle(host.tenant_source("desk"))
        assert _params_equal(ref.backward.params1_by_date, promoted.backward.params1_by_date)


def test_journal_state_sequence_equals_jax_controller(trained, calm_window, shifted_prices,
                                                      tmp_path):
    """The same trigger and prices through both controllers (each on its own
    package's host, policy and walk): the journals hold the same record kinds,
    states, keys and trigger/calibration payloads; only the wall-clock stamp
    and digest- or path-valued fields differ."""
    with _rig(trained, calm_window, tmp_path / "port") as (host, ctl, *_):
        ctl.run_cycle(TriggerEvent(source="manual", tenant="desk", reason="test"),
                      shifted_prices)
        port_recs = read_journal(ctl.journal_path)[0]
    jroot = tmp_path / "jax"
    inc = jroot / "incumbent"
    jexport_bundle(japi.european_hedge(japi.EuropeanConfig(), JSIM, JFIRST), inc)
    jcal.bake_calibration(inc, calm_window)
    cfg = JPilotConfig(tenant="desk", workdir=str(jroot / "pilot"), calib_window=160,
                       vol_window=40, n_boot=12, cooldown_s=60.0, backoff=2.0)

    def jtrain(window, warm, ckpt_dir):
        return japi.european_hedge(
            dataclasses.replace(japi.EuropeanConfig(), sigma=float(window.fit.sigma0)), JSIM,
            dataclasses.replace(JRETRAIN, checkpoint_dir=ckpt_dir), warm_start=warm)

    with JServeHost(promotion_chain=jroot / "promotions.jsonl") as jhost:
        jhost.add_tenant("desk", inc)
        jctl = JPilotController(jhost, cfg, jtrain, hub=jtriggers.TriggerHub(
            "desk", cooldown=jguard.Cooldown(cooldown_s=60.0, backoff=2.0, clock=lambda: 0.0)))
        jctl.run_cycle(jtriggers.TriggerEvent(source="manual", tenant="desk", reason="test"),
                       shifted_prices)
        jax_recs = jjournal.read_journal(jctl.journal_path)[0]
    volatile = {"ts_unix", "workdir", "checkpoint_dir", "incumbent", "candidate", "chain",
                "elapsed_s", "version"}
    assert len(port_recs) == len(jax_recs)
    for p, j in zip(port_recs, jax_recs):
        assert sorted(p) == sorted(j)
        assert ({k: v for k, v in p.items() if k not in volatile}
                == {k: v for k, v in j.items() if k not in volatile})
    assert [r.get("state") for r in port_recs] == [
        None, "calibrating", "training", "exporting", "canary", "promoted"]


# -- the drill ------------------------------------------------------------------

_CONTRACT = ("quick", "n_paths", "n_dates", "calib_window", "n_boot", "drift_trips",
             "debounced", "trigger_sources", "reject_left_incumbent", "rows_lost",
             "journal_records", "journal_problems")


@pytest.fixture(scope="module")
def drills():
    from orp_tpu.serve.bench import _pilot_phase as jpilot_phase

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the drill's reject warns by design
        return _pilot_phase(quick=True, seed=0, device="cpu"), jpilot_phase(quick=True, seed=0)


def test_pilot_drill_contract_equals_jax(drills):
    got, want = drills
    assert {k: got[k] for k in _CONTRACT} == {k: want[k] for k in _CONTRACT}
    assert got["rows_lost"] == 0 and got["rows_served"] == got["rows_submitted"] > 0
    assert got["resume"]["bits_equal"] and want["resume"]["bits_equal"]
    assert got["resume"]["outcome"] == want["resume"]["outcome"] == "promoted"
    assert got["chain"]["ok"] and want["chain"]["ok"]
    assert got["chain"]["verdicts"] == want["chain"]["verdicts"] == [
        "reject", "promote", "promote"]
    assert ([(c["cycle"], c["trigger"], c["outcome"]) for c in got["cycles"]]
            == [(c["cycle"], c["trigger"], c["outcome"]) for c in want["cycles"]])
    # the calibrations are the same numpy on the same prices
    assert got["baseline_b"] == want["baseline_b"] and got["shifted_b"] == want["shifted_b"]


def test_serve_bench_pilot_drill_smoke(trained):
    """``serve_bench(pilot=True, pilot_quick=True)`` runs the drill instead of
    refusing, and its record carries the contract fields (the phase RAISES
    on a violated contract, so reaching the asserts IS the drill passing)."""
    from orp_tpu_torch.serve.bench import serve_bench

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = serve_bench(trained, n_requests=8, batch_sizes=(1,), batcher_requests=4,
                          sweep_concurrency=(), pilot=True, pilot_quick=True, repeats=1,
                          device="cpu")
    pl = rec["pilot"]
    assert pl["rows_lost"] == 0 and rec["pilot_rows_lost"] == 0
    assert rec["pilot_time_to_promote_s"] == pl["time_to_promote_s"] > 0
    outcomes = [c["outcome"] for c in pl["cycles"]]
    assert "rejected" in outcomes and "promoted" in outcomes
    assert pl["drift_trips"] >= 1 and pl["debounced"] >= 1
    assert {"promote", "reject"} <= set(pl["chain"]["verdicts"])
    assert pl["reject_left_incumbent"] and pl["resume"]["bits_equal"]
    assert pl["baseline_b"] < pl["shifted_b"]
