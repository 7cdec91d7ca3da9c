"""Port parity: the basket slice (``sde.simulate_gbm_basket`` /
``simulate_gbm_arithmetic``, ``qmc.sobol_normal_matrix`` and ``qmc.brownian``,
the scenario table, ``utils.basket.basket_call_mm``, ``api.BasketConfig``,
``basket_hedge`` / ``basket_oos`` with the vector head, and serving a basket
policy) against the JAX package.

Tolerances and why:
- paths in float32 at ``rtol=3e-5``, the scan test's tolerance
  (``test_torch_gbm.py``: ``ndtri`` and the ``(A, A)`` products of two f32
  implementations, carried over the steps); in float64 at ``rtol=1e-12``;
- the Sobol matrix and paths at ``rtol=2e-6, atol=1e-6`` in f32 (two f32
  ``ndtri`` a couple of ulps apart, ``test_torch_sobol.py``), ``1e-12`` in f64;
- ``basket_call_mm`` at ``rtol=1e-12`` (the same host float64 arithmetic), its
  degeneracies at ``rtol=1e-10`` against ``bs_call`` (the JAX test's pin);
- the walks in float64 from the JAX walk's initial params (Adam on JAX's
  epoch orders): ledgers, per-date params and report at ``rtol=1e-7`` (as the
  other walks, ``test_torch_adam_walk.py``), the epochs / accepted
  iterations equal on every date;
- the replay of JAX's per-date params on the port's paths: ``v0_cv`` within
  0.05bp (``test_torch_oos.py``'s pin; measured 0.0011bp), ``v0_acv`` within
  0.5bp, about twice the largest gap of 16 replays on the port's paths with
  every knot moved by -1, 0 or +1 ulp (0.080bp for the basket head's 13 OLS
  slots, 0.244bp for the vector head's 65: the f32 backfit's per-slot
  ``eigh``); on JAX's own paths the port lands 0.005bp / 0.091bp from JAX;
- the served block at ``rtol=1e-5, atol=1e-6`` (``test_torch_serve.py``).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu import api as japi
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.qmc import brownian as jbrownian
from orp_tpu.qmc.sobol import sobol_normal_matrix as jsobol_normal_matrix
from orp_tpu.sde import TimeGrid as JTimeGrid
from orp_tpu.sde import kernels as jkernels
from orp_tpu.serve import HedgeEngine as JHedgeEngine
from orp_tpu.serve.megakernel import mixed_head_forward as jmixed_head_forward
from orp_tpu.train.backward import backward_induction as jbackward_induction
from orp_tpu.utils.basket import basket_call_mm as jbasket_call_mm
from orp_tpu_torch import api as tapi
from orp_tpu_torch.api import pipelines as tpipe
from orp_tpu_torch.qmc import brownian, sobol_normal_matrix
from orp_tpu_torch.sde import (TimeGrid, heston_sim_fn, resolve_sim_fn, simulate_gbm_arithmetic,
                               simulate_gbm_basket)
from orp_tpu_torch.serve import HedgeEngine, load_bundle, save_bundle
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.serve.megakernel import mixed_head_plain
from orp_tpu_torch.train import backward_induction
from orp_tpu_torch.utils import bs_call
from orp_tpu_torch.utils.basket import basket_call_mm
from test_torch_adam_walk import walk_keys
from test_torch_fit import inject_jax_orders

CFG = tapi.BasketConfig()
JCFG = japi.BasketConfig()
A = len(CFG.s0)
DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=3e-5, atol=0.0)),
          "f64": (jnp.float64, torch.float64, dict(rtol=1e-12, atol=0.0))}
SIM = dict(n_paths=1024, T=1.0, dt=1 / 13, rebalance_every=1)  # 13 dates
GN = dict(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=6, gn_iters_warm=3)
ADAM = dict(dual_mode="mse_only", epochs_first=6, epochs_warm=4, patience_first=3,
            patience_warm=1, batch_size=256, lr=1e-2)
REPORT_KEYS = ("v0", "phi0", "psi0", "discounted_payoff", "v0_plain", "v0_cv", "cv_std",
               "v0_acv", "acv_std", "oracle_mm")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("store_every", [1, 3])
def test_basket_paths_match_jax(dt, store_every):
    """The basket paths against JAX's scan: f32 at ``rtol=3e-5``, f64 at
    ``rtol=1e-12``; knot 0 is ``s0`` exactly."""
    jd, td, tol = DTYPES[dt]
    grid, jgrid = TimeGrid(1.0, 12), JTimeGrid(1.0, 12)
    want = jkernels.simulate_gbm_basket(
        jnp.arange(4096, dtype=jnp.uint32), jgrid, s0=jnp.asarray(CFG.s0, jd),
        drift=jnp.full(A, CFG.r, jd), sigma=jnp.asarray(CFG.sigmas, jd),
        corr=jnp.asarray(CFG.corr(), jd), seed=1235, store_every=store_every, dtype=jd)
    got = simulate_gbm_basket(torch.arange(4096), grid, s0=CFG.s0, drift=[CFG.r] * A,
                              sigma=CFG.sigmas, corr=CFG.corr(), seed=1235,
                              store_every=store_every, dtype=td)
    assert got.dtype == td and got.shape == (4096, 12 // store_every + 1, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.broadcast_to(CFG.s0, (4096, A)))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_arithmetic_gbm_matches_jax(dt):
    """Arithmetic-Euler GBM inside a 3-factor layout: f32 at ``rtol=3e-5``, f64 at
    ``rtol=1e-12``."""
    jd, td, tol = DTYPES[dt]
    want = jkernels.simulate_gbm_arithmetic(jnp.arange(4096, dtype=jnp.uint32),
                                            JTimeGrid(10.0, 40), 1.0, 0.08, 0.15, seed=1235,
                                            store_every=4, dtype=jd, n_factors=3, factor=1)
    got = simulate_gbm_arithmetic(torch.arange(4096), TimeGrid(10.0, 40), 1.0, 0.08, 0.15,
                                  seed=1235, store_every=4, dtype=td, n_factors=3, factor=1)
    assert got.dtype == td and got.shape == (4096, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_sobol_normal_matrix_and_brownian_match_jax(dt):
    """The Sobol matrix and the Sobol Brownian pair against JAX's: f32 at ``rtol=2e-6,
    atol=1e-6`` (two ``ndtri``), f64 at ``1e-12``."""
    jd, td, _ = DTYPES[dt]
    tol = dict(rtol=2e-6, atol=1e-6) if dt == "f32" else dict(rtol=1e-12, atol=1e-12)
    got = sobol_normal_matrix(10, 7, seed=99, dtype=td, device="cpu")
    assert got.shape == (1024, 7) and got.dtype == td
    np.testing.assert_allclose(got.numpy(), np.asarray(jsobol_normal_matrix(10, 7, 99,
                                                                           dtype=jd)), **tol)
    idx = np.arange(3, 515)
    for name in ("get_dW_sobol", "get_W_sobol"):
        got = getattr(brownian, name)(torch.from_numpy(idx), 9, seed=5, dtype=td)
        want = getattr(jbrownian, name)(jnp.asarray(idx, jnp.uint32), 9, seed=5, dtype=jd)
        assert got.shape == (512, 9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=name)
    assert torch.all(brownian.get_W_sobol(torch.from_numpy(idx), 9, dtype=td)[:, 0] == 0)


def test_pseudo_random_brownian_in_law_and_shape():
    """``get_dW``/``get_W`` draw from a ``torch.Generator``: equal to JAX's in law.
    200,000 increments: mean within 5 sd of 0 (sd 0.0022), variance within 1%;
    the path starts at 0 and its increments are the draws."""
    g = torch.Generator().manual_seed(3)
    dw = brownian.get_dW(g, 200_000, device="cpu")
    assert dw.shape == (200_000,) and dw.dtype == torch.float32
    assert abs(float(dw.mean())) < 5 / np.sqrt(200_000)
    assert abs(float(dw.var()) - 1.0) < 0.01
    w = brownian.get_W(torch.Generator().manual_seed(3), 1000, dtype=torch.float64,
                       device="cpu")
    jw = jbrownian.get_W(jax.random.key(3), 1000, dtype=jnp.float64)
    assert w.shape == jw.shape == (1000,) and w.dtype == torch.float64
    assert float(w[0]) == float(jw[0]) == 0.0
    np.testing.assert_allclose(
        torch.diff(w).numpy(),
        brownian.get_dW(torch.Generator().manual_seed(3), 1000, torch.float64,
                        device="cpu")[:-1].numpy(),
        rtol=1e-12, atol=1e-12)


def test_scenario_table_matches_jax():
    """The scenario table: the same keys, the same simulators by name, the same error
    text."""
    from orp_tpu_torch.sde import kernels as tkernels

    assert sorted(tkernels._SIM_FNS) == sorted(jkernels._SIM_FNS)
    for kind, fn in tkernels._SIM_FNS.items():
        assert resolve_sim_fn(kind) is fn
        assert fn.__name__ == jkernels._SIM_FNS[kind].__name__
    for call, jcall, arg in ((resolve_sim_fn, jkernels.resolve_sim_fn, "sabr"),
                             (heston_sim_fn, jkernels.heston_sim_fn, "milstein")):
        with pytest.raises(ValueError) as got:
            call(arg)
        with pytest.raises(ValueError) as want:
            jcall(arg)
        assert str(got.value) == str(want.value)
    assert heston_sim_fn("qe") is resolve_sim_fn("heston-qe")
    assert heston_sim_fn("euler") is resolve_sim_fn("heston-euler")


def test_basket_call_mm_matches_jax_and_its_degeneracies():
    """``basket_call_mm`` at ``rtol=1e-12`` against JAX's; A = 1 and the comonotone
    basket equal ``bs_call`` at ``rtol=1e-10``; zero vol exact."""
    corr = CFG.corr()
    got = basket_call_mm(CFG.s0, CFG.weights, CFG.strike, CFG.r, CFG.sigmas, corr, 1.0)
    want = jbasket_call_mm(CFG.s0, CFG.weights, CFG.strike, CFG.r, CFG.sigmas, corr, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, (8.860278, 0.100640), rtol=1e-6)
    price, vol = basket_call_mm([100.0], [1.0], 100.0, 0.08, [0.15], [[1.0]], 1.0)
    np.testing.assert_allclose(price, bs_call(100.0, 100.0, 0.08, 0.15, 1.0)[0], rtol=1e-10)
    np.testing.assert_allclose(vol, 0.15, rtol=1e-10)
    s0, w = [80.0, 90.0, 110.0, 120.0], [0.25] * 4
    price, _ = basket_call_mm(s0, w, 100.0, 0.05, [0.2] * 4, np.ones((4, 4)), 2.0)
    np.testing.assert_allclose(price, bs_call(float(np.dot(w, s0)), 100.0, 0.05, 0.2, 2.0)[0],
                               rtol=1e-10)
    assert basket_call_mm([100.0], [1.0], 90.0, 0.05, [0.0], [[1.0]], 1.0) == \
        jbasket_call_mm([100.0], [1.0], 90.0, 0.05, [0.0], [[1.0]], 1.0)


@pytest.mark.parametrize("kw", [dict(weights=(0.5, 0.5)), dict(rho=-0.5), dict(rho=1.0)])
def test_basket_config_validation_matches_jax(kw):
    """``BasketConfig``'s refusals carry JAX's messages; its fields and ``corr()`` are
    equal."""
    with pytest.raises(ValueError) as got:
        tapi.BasketConfig(**kw)
    with pytest.raises(ValueError) as want:
        japi.BasketConfig(**kw)
    assert str(got.value) == str(want.value)
    np.testing.assert_array_equal(CFG.corr(), JCFG.corr())
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


@pytest.mark.parametrize("call", ["hedge", "oos"])
def test_basket_refusals_match_jax(call):
    """``engine="pallas"`` and an unknown ``instruments`` are refused in JAX's words,
    by both entry points."""
    sim = dict(SIM, n_paths=64)
    policy = tapi.PipelineResult(report=None, backward=None, times=None,
                                 adjustment_factor=100.0)
    for kw, sim_kw in ((dict(), dict(engine="pallas")), (dict(instruments="both"), dict())):
        want_sim = japi.SimConfig(**sim, **sim_kw)
        got_sim = tapi.SimConfig(**sim, **sim_kw)
        with pytest.raises(ValueError) as want:
            if call == "hedge":
                japi.basket_hedge(JCFG, want_sim, **kw)
            else:
                japi.basket_oos(policy, JCFG, want_sim, **kw)
        with pytest.raises(ValueError) as got:
            if call == "hedge":
                tapi.basket_hedge(CFG, got_sim, device="cpu", **kw)
            else:
                tapi.basket_oos(policy, CFG, got_sim, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def jax_basket_init(instruments: str, bias) -> dict:
    """The JAX walk's cold-start params of the basket head: ``model.init`` on
    key 0 of ``split(key(1234), 3)`` (``orp_tpu/train/backward.py:794``)."""
    vector = instruments == "assets"
    m = JHedgeMLP(n_features=A, n_hedge_assets=A if vector else 1, dtype=jnp.float64)
    k1 = jax.random.split(jax.random.key(1234), 3)[0]
    return {k: np.asarray(v) for k, v in m.init(k1, bias_init=bias).items()}


def walk_pair(monkeypatch, instruments: str, train: dict):
    """The basket walk and report in float64 from the JAX walk's initial params:
    JAX's ``backward_induction`` on its pipeline's inputs (``_basket_setup``)
    with ``_basket_report``, and the port's on its own (``basket_inputs``,
    checked against JAX's at ``rtol=1e-12, atol=1e-14``: the payoff cancels
    near the strike) with ``_basket_result``; Adam on
    JAX's epoch orders."""
    jsim = japi.SimConfig(**SIM, dtype="float64")
    (_, _, s, w, bkt, coarse, b, payoff, norm, vector, jmodel,
     hedge_prices) = japi.pipelines._basket_setup(JCFG, jsim, None, instruments, "t")
    tsim, ttrain = tapi.SimConfig(**SIM, dtype="float64"), tapi.TrainConfig(**train)
    inp = tpipe.basket_inputs(CFG, tsim, instruments, "basket_hedge", torch.device("cpu"))
    for got, want in ((inp.s, s), (inp.bkt, bkt), (inp.hedge_prices, hedge_prices),
                      (inp.b, b / norm), (inp.terminal, payoff / norm),
                      (inp.features, s / np.asarray(CFG.s0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    assert inp.vector == vector and inp.model.n_outputs == jmodel.n_outputs
    init = jax_basket_init(instruments, inp.bias_init)
    jcfg = dataclasses.replace(japi.pipelines._backward_cfg(japi.TrainConfig(**train)))
    jres = jbackward_induction(
        dataclasses.replace(jmodel, dtype=jnp.float64), s / jnp.asarray(CFG.s0), hedge_prices,
        b / norm, payoff / norm, jcfg, initial_params=(init, None))
    want, _ = japi.pipelines._basket_report(JCFG, jsim, jres, s, w, bkt, coarse, b, payoff,
                                            norm, vector, "sort")
    if train.get("optimizer") != "gauss_newton":
        inject_jax_orders(monkeypatch, walk_keys(1234, tsim.n_rebalance, train["epochs_first"],
                                                 train["epochs_warm"]))
    res = backward_induction(inp.model.with_dtype(torch.float64), inp.features,
                             inp.hedge_prices, inp.b, inp.terminal, tpipe._backward_cfg(ttrain),
                             initial_params=(init, None))
    got = tpipe._basket_result(CFG, tsim, ttrain, inp, res, "sort")
    return (jres, want), got


@pytest.mark.parametrize("train", [GN, ADAM], ids=["gauss_newton", "adam"])
@pytest.mark.parametrize("instruments", ["basket", "assets"])
def test_basket_walk_matches_jax_in_f64(monkeypatch, instruments, train):
    """The walk and report in f64 at ``rtol=1e-7`` (module docstring), iterations /
    epochs equal."""
    (jres, want), got = walk_pair(monkeypatch, instruments, train)
    vector = instruments == "assets"
    assert got.backward.phi.shape == ((1024, 13, A) if vector else (1024, 13))
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(got.backward, k).numpy(),
                                   np.asarray(getattr(jres, k)), rtol=1e-7, atol=1e-9,
                                   err_msg=k)
    for k, v in jres.params1_by_date.items():
        np.testing.assert_allclose(got.backward.params1_by_date[k].numpy(), np.asarray(v),
                                   rtol=1e-7, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got.backward.epochs_ran, jres.epochs_ran)
    np.testing.assert_allclose(got.backward.train_loss, jres.train_loss, rtol=1e-7)
    for k in REPORT_KEYS:
        np.testing.assert_allclose(getattr(got.report, k), getattr(want, k), rtol=1e-7,
                                   err_msg=k)
    for k in ("phi_by_date", "psi_by_date"):
        np.testing.assert_allclose(got.report.holdings[k], want.holdings[k], rtol=1e-7,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(got.report.var_overall, want.var_overall, rtol=1e-7)
    assert got.report.holdings["phi_by_date"].shape == (13,)


@pytest.mark.parametrize("train", [dict(GN, gn_block_rows=256), dict(ADAM, shuffle="blocks")],
                         ids=["gauss_newton", "adam"])
def test_fused_vector_walk_is_the_host_loop_bitwise(train):
    """The fused vector walk (GN blocked, Adam blocks) equals the host loop bitwise."""
    sim = tapi.SimConfig(**SIM)
    host = tapi.basket_hedge(CFG, sim, tapi.TrainConfig(**train), instruments="assets",
                             device="cpu")
    fused = tapi.basket_hedge(CFG, sim, tapi.TrainConfig(**train, fused=True),
                              instruments="assets", device="cpu")
    for k in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(fused.backward, k), getattr(host.backward, k)), k
    for k, v in host.backward.params1_by_date.items():
        assert torch.equal(fused.backward.params1_by_date[k], v), k
    np.testing.assert_array_equal(fused.backward.epochs_ran, host.backward.epochs_ran)
    assert fused.report.v0_cv == host.report.v0_cv


@pytest.fixture(scope="module", params=["basket", "assets"])
def jax_trained(request):
    """A JAX-trained basket policy (f32) and its per-date params as a port bundle."""
    res = japi.basket_hedge(JCFG, japi.SimConfig(**SIM), japi.TrainConfig(**GN),
                            instruments=request.param)
    vector = request.param == "assets"
    model = tapi.pipelines.HedgeMLP(n_features=A, n_hedge_assets=A if vector else 1)
    meta = {"model": model_meta(model), "times": np.asarray(res.times).tolist(),
            "adjustment_factor": 100.0, "dual_mode": "mse_only", "holdings_combine": "single",
            "cost_of_capital": 0.1, "sim_seed": res.sim_seed}
    p1 = {k: np.asarray(v, np.float32) for k, v in res.backward.params1_by_date.items()}
    return request.param, res, meta, p1


def test_basket_oos_replays_jax_params(jax_trained, tmp_path):
    """JAX's per-date params replayed on fresh paths: ``v0_cv`` within 0.05bp,
    ``v0_acv`` within 0.5bp (module docstring), the rest at ``rtol=1e-4``."""
    instruments, res, meta, p1 = jax_trained
    policy = save_bundle(tmp_path / "policy", meta, p1)
    sim = dict(SIM, seed_fund=4321)
    want = japi.basket_oos(res, JCFG, japi.SimConfig(**sim), japi.TrainConfig(**GN),
                           instruments=instruments)
    got = tapi.basket_oos(load_bundle(tmp_path / "policy"), CFG, tapi.SimConfig(**sim),
                          tapi.TrainConfig(**GN), instruments=instruments, device="cpu")
    for k, lim in (("v0_cv", 0.05), ("v0_acv", 0.5)):
        a, b = getattr(got.report, k), getattr(want.report, k)
        assert abs(a - b) / b * 1e4 <= lim, (k, a, b)
    for k in ("v0", "v0_plain", "cv_std", "oracle_mm"):
        np.testing.assert_allclose(getattr(got.report, k), getattr(want.report, k), rtol=1e-4,
                                   err_msg=k)
    with pytest.raises(ValueError, match="TRAINING seed"):
        tapi.basket_oos(policy, CFG, tapi.SimConfig(**SIM), tapi.TrainConfig(**GN),
                        instruments=instruments, device="cpu")
    other = "basket" if instruments == "assets" else "assets"
    with pytest.raises(ValueError):
        tapi.basket_oos(policy, CFG, tapi.SimConfig(**sim), tapi.TrainConfig(**GN),
                        instruments=other, device="cpu")


def test_basket_policy_serves_like_jax(jax_trained, tmp_path):
    """The basket policy (5 features; 2 outputs, or 6 for the vector head)
    through ``save_bundle`` -> ``load_bundle`` -> ``HedgeEngine``: the
    mixed-date block against the JAX engine, and its head against the Pallas
    kernel in interpret mode."""
    instruments, res, meta, p1 = jax_trained
    save_bundle(tmp_path / "policy", meta, p1)
    policy = load_bundle(tmp_path / "policy")
    n_out = A + 1 if instruments == "assets" else 2
    assert policy.model.n_outputs == n_out and policy.model.n_features == A
    rng = np.random.default_rng(7)
    n = 300
    dates = rng.integers(0, 13, n)
    states = (1.0 + 0.1 * rng.standard_normal((n, A))).astype(np.float32)
    prices = np.concatenate([states[:, :n_out - 1], np.full((n, 1), 0.0108, np.float32)], 1)
    eng = HedgeEngine(policy, device="cpu")
    got = eng.evaluate_mixed_async(dates, states, prices).result()
    want = JHedgeEngine(res, use_aot=False).evaluate_mixed_async(dates, states, prices).result()
    for a, b in zip(got, want):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    head = mixed_head_plain(policy.model, policy.backward.params1_by_date,
                            torch.from_numpy(dates.astype(np.int32)), torch.from_numpy(states))
    jhead = jmixed_head_forward(res.model, res.backward.params1_by_date,
                                jnp.asarray(dates, jnp.int32)[:, None], jnp.asarray(states),
                                interpret=True)
    np.testing.assert_allclose(head.numpy(), np.asarray(jhead), rtol=1e-5, atol=1e-6)
