"""Port parity: the command line's JSON lines (``orp_tpu_torch/cli.py``) against
the JAX package's (``orp_tpu/cli.py``) and against the port's own API.

Each compute command runs the same argv through ``orp_tpu.cli.main`` and
``orp_tpu_torch.cli.main(["--device", "cpu", ...])``. Before any number is
compared, the configs the port's CLI handed its API (recorded by a wrapper
around the API function) must equal the ones the test builds itself; the
port's line must then equal, bitwise, the line of the port's API called with
those configs. Against the reference's line each case holds the band of that
entry point's existing parity file:

- ``euro``, ``heston`` (QE-M and Euler), ``basket``, ``export``: GN walks in
  float32 from the JAX walk's initial params (below), ``v0_cv`` and ``v0_acv``
  within 0.5bp, ``v0`` at ``rtol=1e-3``, ``v0_plain`` and the discounted
  payoff at ``rtol=1e-5`` (``tests/test_torch_walk.py``); the ``oos_`` line
  the same. The Euler walk's network ``v0`` is not held to JAX's: that file
  measured its band on the QE and GBM walks, and here the Euler walk's parts
  by 1.7e-3 (its prices stay inside 0.5bp), the basket's by 2.8e-3;
- ``pension``, ``sweep`` on the scan engine (exact thinning: JAX's paths
  bitwise): V0 at ``rtol=2e-3``, phi0 and psi0 within 2% of V0
  (``tests/test_torch_dual_walk.py``; a sweep row carries no V0: its total
  ``phi + psi`` within 4%, the sum of the two 2% bands, the split itself not
  held: phi 4.7% of the total apart at sigma 0.1, measured here); ``pension --engine
  pallas`` (normal thinning): the discounted payoff at ``rtol=1e-5``, the walk
  parting further (``test_pension_line``). ``basket``: its prices in the walk
  band, its network ``v0`` not (no parity file holds an f32 basket walk's);
- ``asian``, ``barrier``, ``lookback``, ``bermudan``: ``rtol=3e-5``, the
  float32 scan path (``tests/test_torch_exotics.py``, ``test_torch_lsm.py``);
  ``surface``: prices at ``rtol=3e-5`` plus ``atol=1e-6`` for the line's
  rounding to six decimals, IVs at ``atol=3e-4`` with the null mask equal;
- ``greeks``: price, delta, vega, rho at ``rtol=1e-6``, theta at ``rtol=1e-5``,
  the standard errors at ``rtol=1e-4`` (``tests/test_torch_greeks.py``; gamma,
  a finite difference of two float32 means, is held there in float64 only,
  so here only to the port's API);
- ``calibrate`` (both forms): equal (``tests/test_torch_risk_tools.py``,
  ``test_torch_pilot.py``: the same host float64 code).

The walks start where the JAX walk starts: torch cannot draw JAX's threefry
params, so a wrapper around the port's ``backward_induction`` hands it
``initial_params`` = the JAX walk's cold-start draws (``model.init`` on keys
0 and 1 of ``split(key(1234), 3)``), as the pipeline parity files pass
``warm_start``. The same wrapper is active for the port's API run, so the
bitwise comparison is unaffected by it. The hedges are trained by
Gauss-Newton: Adam's epoch orders differ between the packages.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from orp_tpu import cli as jcli
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu_torch import api as tapi
from orp_tpu_torch import cli as tcli
from orp_tpu_torch.api import pipelines as tpipe


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (the suite's workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(model, bias_init):
    """The JAX walk's cold-start params for the port's ``model``."""
    ks = jax.random.split(jax.random.key(1234), 3)
    jm = JHedgeMLP(n_features=model.n_features,
                   constrain_self_financing=model.constrain_self_financing,
                   n_hedge_assets=model.n_hedge_assets)
    return tuple({k: np.asarray(v) for k, v in jm.init(ks[i], bias_init=bias_init).items()}
                 for i in (0, 1))


@pytest.fixture
def jax_start(monkeypatch):
    real = tpipe.backward_induction

    def walk(model, *args, bias_init=None, initial_params=None, **kw):
        if initial_params is None:
            initial_params = _jax_init(model, bias_init)
        return real(model, *args, bias_init=bias_init, initial_params=initial_params, **kw)

    monkeypatch.setattr(tpipe, "backward_induction", walk)


def _record(monkeypatch, module, name):
    """Wrap ``module.name``: every call's arguments land in the returned list."""
    calls = []
    real = getattr(module, name)

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, rec)
    return calls


def _lines(main, argv, capsys) -> list:
    capsys.readouterr()
    main(argv)
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


def _both(argv, capsys):
    return (_lines(jcli.main, argv, capsys),
            _lines(tcli.main, ["--device", "cpu", *argv], capsys))


def _bp(a, b) -> float:
    return abs(a - b) / abs(b) * 1e4


def _walk_band(got: dict, want: dict, prefix: str = "", v0: bool = True) -> None:
    """``tests/test_torch_walk.py``'s f32 pipeline band (``v0``: also the
    network's value, which that file measured on the QE and GBM walks)."""
    for k in ("v0_cv", "v0_acv"):
        assert _bp(got[prefix + k], want[prefix + k]) <= 0.5, (prefix + k, got, want)
    if v0:
        np.testing.assert_allclose(got[prefix + "v0"], want[prefix + "v0"], rtol=1e-3)
    for k in ("v0_plain", "discounted_payoff"):
        np.testing.assert_allclose(got[prefix + k], want[prefix + k], rtol=1e-5)
    assert set(got) == set(want)


def _dual_band(got: dict, want: dict, prefix: str = "") -> None:
    """``tests/test_torch_dual_walk.py``'s f32 pipeline band."""
    v0 = want[prefix + "v0"]
    np.testing.assert_allclose(got[prefix + "v0"], v0, rtol=2e-3)
    for k in ("phi0", "psi0"):
        assert abs(got[prefix + k] - want[prefix + k]) <= 0.02 * v0, (k, got, want)
    assert set(got) == set(want)


HEDGE_ARGV = ["--optimizer", "gauss_newton", "--gn-iters-first", "20", "--gn-iters-warm",
              "10", "--json"]
EURO_SIM = dict(n_paths=1024, T=1.0, dt=1.0 / 16, rebalance_every=2, engine="pallas")
GN_TRAIN = dict(optimizer="gauss_newton", gn_iters_first=20, gn_iters_warm=10)


def test_euro_line(monkeypatch, capsys, jax_start):
    calls = _record(monkeypatch, tapi, "european_hedge")
    oos_calls = _record(monkeypatch, tapi, "european_oos")
    argv = ["euro", "--paths", "1024", "--steps", "16", "--rebalance-every", "2",
            "--unconstrained", "--engine", "pallas", "--oos-seed", "4321", *HEDGE_ARGV]
    want, got = _both(argv, capsys)
    euro = tapi.EuropeanConfig(constrain_self_financing=False)
    sim = tapi.SimConfig(**EURO_SIM)
    train = tapi.TrainConfig(dual_mode="mse_only", **GN_TRAIN)
    (args, kw), = calls
    assert args == (euro, sim, train) and kw["device"] == "cpu" and kw["mesh"] is None
    oos_sim = dataclasses.replace(sim, seed_fund=4321)
    assert oos_calls[0][0][1:] == (euro, oos_sim, train)
    # the port's line is its API's, bitwise
    res = tpipe.european_hedge(euro, sim, train, device="cpu")
    oos = tpipe.european_oos(res, euro, oos_sim, train, device="cpu")
    assert got == [tcli.result_line(res.report), tcli.result_line(oos.report, prefix="oos_")]
    _walk_band(got[0], want[0])
    _walk_band(got[1], want[1], "oos_")


@pytest.mark.parametrize("scheme", [None, "euler"])
def test_heston_line(monkeypatch, capsys, jax_start, scheme):
    calls = _record(monkeypatch, tapi, "heston_hedge")
    extra = [] if scheme is None else ["--scheme", scheme]
    argv = ["heston", "--paths", "1024", "--steps", "16", "--rebalance-every", "2",
            "--engine", "pallas", *extra, *HEDGE_ARGV]
    want, got = _both(argv, capsys)
    h = tapi.HestonConfig(scheme=scheme)
    sim = tapi.SimConfig(**EURO_SIM)
    train = tapi.TrainConfig(dual_mode="mse_only", **GN_TRAIN)
    assert calls[0][0] == (h, sim, train)
    res = tpipe.heston_hedge(h, sim, train, device="cpu")
    oracle = got[0]["oracle"]
    assert got == [tcli.result_line(res.report, extra={
        "oracle": oracle, "cv_err_bp": (res.report.v0_cv - oracle) / oracle * 1e4})]
    np.testing.assert_allclose(oracle, want[0]["oracle"], rtol=1e-10)
    assert abs(got[0]["cv_err_bp"] - want[0]["cv_err_bp"]) <= 0.5
    # the Euler walk's network v0 parts from JAX's by 1.7e-3 at this size (no parity
    # file holds an Euler walk's v0): its prices alone are held
    _walk_band(got[0], want[0], v0=scheme is None)


def _pension_argv(engine):
    return ["--paths", "1024", "--steps", "8", "--T", "2", "--rebalance-every", "4",
            "--engine", engine, *HEDGE_ARGV]


def _pension_cfg(engine):
    return tapi.HedgeRunConfig(
        market=tapi.MarketConfig(mu=0.08, r=0.03, sigma=0.15),
        sim=tapi.SimConfig(n_paths=1024, T=2.0, dt=0.25, rebalance_every=4, engine=engine,
                           binomial_mode="normal" if engine == "pallas" else "exact"),
        train=tapi.TrainConfig(dual_mode="separate", **GN_TRAIN))


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_pension_line(monkeypatch, capsys, jax_start, engine):
    """``scan``: exact thinning, JAX's paths bitwise, held in the dual walk's band.
    ``pallas`` (K3c's plain version, normal thinning): the f32 walk from the same
    init parts further there (V0 2.4e-3 apart, measured here, outside the band
    that file measured on inversion paths), so the paths alone are held to the
    reference's, through the discounted payoff."""
    calls = _record(monkeypatch, tapi, "pension_hedge")
    want, got = _both(["pension", *_pension_argv(engine), "--oos-seed", "99"], capsys)
    cfg = _pension_cfg(engine)
    assert calls[0][0] == (cfg,)
    res = tpipe.pension_hedge(cfg, device="cpu")
    oos = tpipe.pension_oos(res, dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, seed=99)), device="cpu")
    assert got == [tcli.result_line(res.report), tcli.result_line(oos.report, prefix="oos_")]
    for prefix, g, w in (("", got[0], want[0]), ("oos_", got[1], want[1])):
        np.testing.assert_allclose(g[prefix + "discounted_payoff"],
                                   w[prefix + "discounted_payoff"], rtol=1e-5)
        if engine == "scan":
            _dual_band(g, w, prefix)


def test_sweep_line(monkeypatch, capsys, jax_start):
    calls = _record(monkeypatch, tapi, "sigma_sweep")
    want, got = _both(["sweep", "--sigmas", "0.1,0.2", *_pension_argv("scan")], capsys)
    sigmas, base = calls[0][0]
    assert sigmas == [0.1, 0.2] and base == dataclasses.replace(
        _pension_cfg("scan"), market=tapi.MarketConfig())
    assert got == [tpipe.sigma_sweep([0.1, 0.2], base, device="cpu")]
    for g, w in zip(got[0], want[0]):
        assert g["sigma"] == w["sigma"] and set(g) == set(w)
        # phi + psi: the sum of the dual walk's two 2%-of-V0 bands; the split
        # itself is weakly identified (phi 4.7% of the total apart at sigma 0.1)
        assert abs(g["total"] - w["total"]) <= 0.04 * w["total"], (g, w)


def test_basket_line(monkeypatch, capsys, jax_start):
    calls = _record(monkeypatch, tapi, "basket_hedge")
    argv = ["basket", "--paths", "1024", "--steps", "8", "--rebalance-every", "2",
            "--s0", "100,100", "--weights", "0.5,0.5", "--sigmas", "0.2,0.15", *HEDGE_ARGV]
    want, got = _both(argv, capsys)
    bcfg = tapi.BasketConfig(sigmas=(0.2, 0.15), s0=(100.0, 100.0), weights=(0.5, 0.5))
    sim = tapi.SimConfig(n_paths=1024, T=1.0, dt=1.0 / 8, rebalance_every=2)
    train = tapi.TrainConfig(dual_mode="mse_only", **GN_TRAIN)
    assert calls[0][0] == (bcfg, sim, train) and calls[0][1]["instruments"] == "basket"
    rep = tpipe.basket_hedge(bcfg, sim, train, device="cpu").report
    assert got == [tcli.result_line(rep, extra={
        "oracle_mm": rep.oracle_mm,
        "mm_diff_bp": (rep.v0_cv - rep.oracle_mm) / rep.oracle_mm * 1e4})]
    np.testing.assert_allclose(got[0]["oracle_mm"], want[0]["oracle_mm"], rtol=1e-12)
    assert abs(got[0]["mm_diff_bp"] - want[0]["mm_diff_bp"]) <= 0.5
    # no parity file holds an f32 basket walk's network v0 (test_torch_basket.py holds
    # the walk in f64); here it parts by 2.8e-3: the prices alone are held
    _walk_band(got[0], want[0], v0=False)


def test_export_line(monkeypatch, capsys, tmp_path, jax_start):
    calls = _record(monkeypatch, tapi, "european_hedge")
    argv = ["export", "--pipeline", "euro", "--paths", "1024", "--steps", "16",
            "--rebalance-every", "2", *HEDGE_ARGV]
    want = _lines(jcli.main, [*argv, "--out", str(tmp_path / "j")], capsys)
    got = _lines(tcli.main, ["--device", "cpu", *argv, "--out", str(tmp_path / "t")], capsys)
    sim = tapi.SimConfig(n_paths=1024, T=1.0, dt=1.0 / 16, rebalance_every=2)
    train = tapi.TrainConfig(dual_mode="mse_only", **GN_TRAIN)
    assert calls[0][0] == (tapi.EuropeanConfig(), sim, train)
    res = tpipe.european_hedge(tapi.EuropeanConfig(), sim, train, device="cpu")
    from orp_tpu_torch.serve import load_bundle

    b = load_bundle(tmp_path / "t")
    assert got == [{"out": str(tmp_path / "t"), "pipeline": "euro", "n_dates": 8,
                    "v0": res.v0, "fingerprint": b.fingerprint}]
    assert want[0]["n_dates"] == 8 and want[0]["pipeline"] == "euro"
    np.testing.assert_allclose(got[0]["v0"], want[0]["v0"], rtol=1e-3)


# -- the option analytics: the same Sobol points on the scan path ------------------

ANALYTICS = {
    "asian": (["asian", "--paths", "4096", "--avg-dates", "13", "--steps-per-avg", "2"],
              "orp_tpu_torch.risk.asian", "asian_call_qmc",
              lambda f: f(4096, 100.0, 100.0, 0.08, 0.15, 1.0, n_avg=13, steps_per_avg=2,
                          seed=1234, device="cpu")),
    "barrier": (["barrier", "--paths", "4096", "--monitor-dates", "13"],
                "orp_tpu_torch.risk.barrier", "down_and_out_call_qmc",
                lambda f: f(4096, 100.0, 100.0, 90.0, 0.08, 0.25, 1.0, n_monitor=13,
                            bridge=True, seed=1234, device="cpu")),
    "lookback": (["lookback", "--paths", "4096"], "orp_tpu_torch.risk.lookback",
                 "lookback_call_qmc",
                 lambda f: f(4096, 100.0, 110.0, 0.08, 0.25, 1.0, n_monitor=13, bridge=True,
                             seed=1234, device="cpu")),
    "lookback-floating": (["lookback", "--paths", "4096", "--floating", "--naive"],
                          "orp_tpu_torch.risk.lookback", "lookback_floating_qmc",
                          lambda f: f(4096, 100.0, 0.08, 0.25, 1.0, n_monitor=13,
                                      bridge=False, seed=1234, device="cpu")),
    "bermudan": (["bermudan", "--paths", "4096", "--exercise-dates", "10",
                  "--steps-per-exercise", "2"], "orp_tpu_torch.train.lsm", "bermudan_lsm",
                 lambda f: f(4096, 36.0, 40.0, 0.06, 0.2, 1.0, kind="put", n_exercise=10,
                             steps_per_exercise=2, seed=1234, device="cpu")),
}


@pytest.mark.parametrize("case", sorted(ANALYTICS))
def test_analytics_line(monkeypatch, capsys, case):
    import importlib

    argv, module, name, call = ANALYTICS[case]
    mod = importlib.import_module(module)
    calls = _record(monkeypatch, mod, name)
    want, got = _both([*argv, "--json"], capsys)
    api = call(getattr(mod, name))
    assert calls[0] == calls[1]  # the CLI's call and the test's: the same arguments
    oracle = got[0].pop("oracle", None)
    assert got[0] == tcli._jsonable(api)
    assert set(got[0]) | ({"oracle"} if oracle is not None else set()) == set(want[0])
    for k, w in want[0].items():
        g = oracle if k == "oracle" else got[0][k]
        np.testing.assert_allclose(g, w, rtol=1e-12 if k == "oracle" else 3e-5, err_msg=k)


def test_surface_line(monkeypatch, capsys):
    from orp_tpu_torch.risk import surface

    calls = _record(monkeypatch, surface, "price_surface")
    argv = ["surface", "--paths", "4096", "--strikes", "80,100,120", "--maturities", "4",
            "--steps-per-maturity", "4", "--json"]
    want, got = _both(argv, capsys)
    api = surface.price_surface(4096, 100.0, 0.08, 0.15, [80.0, 100.0, 120.0], 1.0,
                                kind="call", n_maturities=4, steps_per_maturity=4, seed=1234,
                                device="cpu")
    assert calls[0] == calls[1]
    prices = api["prices"].numpy().round(6).tolist()
    iv = [[float(v) if np.isfinite(v) else None for v in row]
          for row in api["iv"].numpy().round(6)]
    assert got == [{"times": api["times"].numpy().tolist(), "strikes": [80.0, 100.0, 120.0],
                    "prices": prices, "iv": iv}]
    g, w = got[0], want[0]
    np.testing.assert_allclose(g["times"], w["times"], rtol=1e-6)
    np.testing.assert_allclose(g["prices"], w["prices"], rtol=3e-5, atol=1e-6)
    gi = np.array(g["iv"], dtype=float)
    wi = np.array(w["iv"], dtype=float)
    np.testing.assert_array_equal(np.isnan(gi), np.isnan(wi))
    np.testing.assert_allclose(gi, wi, rtol=0.0, atol=3e-4)


def test_greeks_line(monkeypatch, capsys):
    from orp_tpu_torch.risk import greeks

    calls = _record(monkeypatch, greeks, "european_greeks")
    want, got = _both(["greeks", "--paths", "2048", "--steps", "26", "--json"], capsys)
    res = greeks.european_greeks(2048, 100.0, 100.0, 0.08, 0.15, 1.0, kind="call", n_steps=26,
                                 seed=1234, gamma_bump=0.01, device="cpu")
    assert calls[0] == calls[1]
    assert got == [tcli._jsonable({**res.as_dict(), "se": res.se, "n_paths": 2048,
                                   "n_steps": 26})]
    g, w = got[0], want[0]
    for k in ("price", "delta", "vega", "rho"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(g["theta"], w["theta"], rtol=1e-5)
    for k, v in w["se"].items():
        np.testing.assert_allclose(g["se"][k], v, rtol=1e-4, err_msg=k)
    assert (g["n_paths"], g["n_steps"]) == (w["n_paths"], w["n_steps"])


def test_calibrate_lines(capsys, tmp_path):
    from orp_tpu_torch.pilot import calibrate_window
    from orp_tpu_torch.serve.bench import _pilot_market

    rng = np.random.default_rng(0)
    f = tmp_path / "prices.csv"
    np.savetxt(f, 100 * np.exp(np.cumsum(rng.normal(0.0003, 0.01, size=400))), delimiter=",")
    want, got = _both(["calibrate", str(f), "--years", "1.6", "--json"], capsys)
    assert got == want and set(got[0]) == {"a", "b", "c", "mu", "sigma0"}
    from orp_tpu_torch.calib import (annualized_drift, estimate_cir_params, log_returns,
                                     rolling_volatility)

    series = np.loadtxt(f, delimiter=",")
    vol = rolling_volatility(log_returns(series), window=40)
    cir = estimate_cir_params(vol)
    assert got == [{"a": cir.a, "b": cir.b, "c": cir.c, "mu": annualized_drift(series, 1.6),
                    "sigma0": float(vol[-1])}]
    prices = _pilot_market(220, a=4.0, b=0.15, c=0.2, mu=0.08, sigma0=0.15, seed=7)
    g = tmp_path / "pilot.csv"
    np.savetxt(g, prices, delimiter=",")
    want, got = _both(["calibrate", "--prices", str(g), "--window", "40", "--boot", "12",
                       "--json"], capsys)
    assert got == want
    assert got == [json.loads(json.dumps(calibrate_window(
        np.loadtxt(g, delimiter=","), vol_window=40, n_boot=12, seed=0).to_meta()))]
