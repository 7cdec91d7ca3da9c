"""Port parity: the quantile leg and the dual walk (``orp_tpu_torch/train/gn.py``
``fit_gn_pinball``, ``orp_tpu_torch/train/backward.py`` in ``separate`` and
``shared`` mode, ``orp_tpu_torch/api/pipelines.py`` ``pension_hedge`` /
``pension_oos`` and the reference shims) against the JAX package, from the
same JAX-initialised params (threefry cannot be reproduced by torch).

Tolerances and why:
- in float64 the port and JAX run the same LM iterations: the IRLS fit's
  final loss at ``rtol=1e-7``, the walk's ledgers and per-date params at
  ``rtol=1e-7`` (as ``tests/test_torch_walk.py``) with ``atol=1e-9`` on
  ledgers of order 0.1-1 (the IRLS weights ``1/|r|`` lift f64 roundoff in
  the near-zero residuals to ~4e-10), per-date params with ``atol=1e-7``
  (the first layer's row for lambda, a feature of spread ~1e-4, is the
  Gram's weakest direction: measured 1.1e-8 on params of order 0.1-1), the
  same accepted-step counts;
- the IRLS fit in float32, warm-started (the walk's regime): final loss at
  ``rtol=1e-4``, as ``tests/test_torch_gn.py`` holds the MSE leg;
- the f32 pipeline from the same initial params: accept/reject branches on
  float compares and date 0's features are the same on every path (a
  rank-deficient Gram), so the f32 trajectories part at date 0. Pinned: V0
  at ``rtol=2e-3`` (the JAX package holds its two path engines to 1e-3,
  ``tests/test_pallas.py``; measured 7e-4 shared, 3e-4 separate) and phi0,
  psi0 within 2% of V0 (measured 1.0% and 0.9%, the weakly identified split).
  Replayed, a ``shared`` policy's value is the quantile leg's alone, which
  parts further: V0 within 2% there (measured 0.97%);
- a replay of one policy on both packages' paths: report fields at
  ``rtol=1e-4``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu import api as japi
from orp_tpu.api.pipelines import _cfg_from_params as j_cfg_from_params
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train import losses as JL
from orp_tpu.train.backward import BackwardConfig as JBackwardConfig
from orp_tpu.train.backward import backward_induction as jbackward_induction
from orp_tpu.train.gn import GNPinballConfig as JGNPinballConfig
from orp_tpu.train.gn import fit_gn_pinball as jfit_gn_pinball
from orp_tpu_torch import api as tapi
from orp_tpu_torch.api import pipelines as tpipe
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.serve import policy_from_numpy
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.train import BackwardConfig, backward_induction, losses
from orp_tpu_torch.train.backward import _initial_params
from orp_tpu_torch.train.gn import GNPinballConfig, fit_gn_pinball

N = 4096
GN = dict(optimizer="gauss_newton")
SIM = dict(n_paths=1024, T=2.0, dt=0.25, rebalance_every=4, engine="pallas",
           binomial_mode="inversion")
REF_PARAMS = {  # the key set of Multi Time Step.ipynb#28 (tests/test_api.py, tiny grid)
    "Y": 1.0, "K": 1.0, "T": 2.0, "mu": 0.08, "r": 0.03, "sigma": 0.15,
    "rebalancing": 1.0, "N": 10_000, "P": 100.0, "x": 55,
    "l0": 0.01, "c": 0.075, "ita": 0.000597, "dt": 1 / 12, "n_paths": 8,
}


def regression(seed: int, dtype=np.float32):
    """A pension-like date: features ``(Y_t, N_t/N0, lambda_t)``, prices
    ``(Y_{t+1}, B)``, target the floored liability ``max(Y_{t+1}, 1) N_{t+1}/N0``."""
    rng = np.random.default_rng(seed)
    y = np.exp(0.15 * rng.standard_normal(N) + 0.05)
    pop = 1.0 - 0.01 * rng.random(N)
    lam = 0.01 + 1e-4 * rng.standard_normal(N)
    y1 = y * np.exp(0.15 * 0.5 * rng.standard_normal(N) + 0.04)
    pop1 = pop - 0.005 * rng.random(N)
    feats = np.stack([y, pop, lam], 1)
    prices = np.stack([y1, np.full(N, np.exp(0.03 * 0.5))], 1)
    target = np.maximum(y1, 1.0) * pop1
    return tuple(a.astype(dtype) for a in (feats, prices, target))


def jax_params(dtype=jnp.float32, seed: int = 0) -> dict:
    p = JHedgeMLP(n_features=3, dtype=dtype).init(jax.random.key(seed), bias_init=(0.6, 0.4))
    return {k: np.asarray(v) for k, v in p.items()}


def run_pinball(params: dict, data, n_iters: int, dtype, block_rows=None,
                loss: str = "pinball"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.float64,
                                                                         torch.float64)
    jm = JHedgeMLP(n_features=3, dtype=jdt)
    jp, jaux = jfit_gn_pinball(
        {k: jnp.asarray(v, jdt) for k, v in params.items()}, *(jnp.asarray(a, jdt) for a in data),
        None, value_fn=jm.value, loss_fn=JL.make_loss(loss, q=0.99),
        cfg=JGNPinballConfig(n_iters=n_iters, block_rows=block_rows))
    tp, taux = fit_gn_pinball(
        HedgeMLP(n_features=3, dtype=tdt), {k: torch.tensor(v, dtype=tdt) for k, v in
                                            params.items()},
        *(torch.tensor(a, dtype=tdt) for a in data), loss_fn=losses.make_loss(loss, q=0.99),
        cfg=GNPinballConfig(n_iters=n_iters, block_rows=block_rows))
    return (jp, jaux), (tp, taux)


def test_pinball_losses_match_jax():
    rng = np.random.default_rng(0)
    pred, target = (rng.standard_normal(1000).astype(np.float32) * s for s in (1.0, 1e-3))
    for name in ("pinball", "smoothed_pinball", "mse"):
        for q in (0.99, 0.5):
            tf, jf = losses.make_loss(name, q=q), JL.make_loss(name, q=q)
            np.testing.assert_allclose(float(tf(torch.tensor(pred), torch.tensor(target))),
                                       float(jf(jnp.asarray(pred), jnp.asarray(target))),
                                       rtol=1e-6, err_msg=f"{name} q={q}")
    assert losses.make_loss("pinball", q=0.99) is losses.make_loss("pinball", q=0.99)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss("huber")


@pytest.mark.parametrize("block_rows, loss", [(None, "pinball"), (1024, "pinball"),
                                              (None, "smoothed_pinball")])
def test_fit_gn_pinball_matches_jax_in_f64(block_rows, loss):
    (jp, jaux), (tp, taux) = run_pinball(jax_params(jnp.float64), regression(1, np.float64),
                                         20, np.float64, block_rows, loss)
    np.testing.assert_allclose(float(taux["final_loss"]), float(jaux["final_loss"]), rtol=1e-7)
    np.testing.assert_allclose(taux["loss_history"].numpy(), np.asarray(jaux["loss_history"]),
                               rtol=1e-7)
    assert int(taux["n_epochs_ran"]) == int(jaux["n_epochs_ran"]) > 0
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("block_rows", [None, 1024])
def test_fit_gn_pinball_matches_jax_in_f32_warm_started(block_rows):
    """The walk's regime: params already fitted at the neighbouring date."""
    jm = JHedgeMLP(n_features=3, dtype=jnp.float32)
    warm, _ = jfit_gn_pinball({k: jnp.asarray(v) for k, v in jax_params().items()},
                              *(jnp.asarray(a) for a in regression(1)), None, value_fn=jm.value,
                              loss_fn=JL.make_loss("pinball", q=0.99),
                              cfg=JGNPinballConfig(n_iters=30))
    warm = {k: np.asarray(v) for k, v in warm.items()}
    (_, jaux), (_, taux) = run_pinball(warm, regression(2), 10, np.float32, block_rows)
    np.testing.assert_allclose(float(taux["final_loss"]), float(jaux["final_loss"]), rtol=1e-4)
    assert taux["final_loss"].dtype == torch.float32


def test_fit_gn_pinball_runs_in_full_f32_without_tf32(monkeypatch):
    """Every weighted Gram and solve of the IRLS fit runs with TF32 off and
    matmul precision "highest", whatever the caller set before."""
    seen = []
    solve_ex = torch.linalg.solve_ex

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return solve_ex(*a, **kw)

    monkeypatch.setattr(torch.linalg, "solve_ex", spy)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        model = HedgeMLP(n_features=3)
        fit_gn_pinball(model, model.init(torch.Generator().manual_seed(0)),
                       *(torch.tensor(a) for a in regression(1)),
                       loss_fn=losses.make_loss("pinball"), cfg=GNPinballConfig(n_iters=3))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])
    assert len(seen) == 3 and all(s == (False, False, "highest") for s in seen)


def test_fit_gn_pinball_refuses_a_readout_solve():
    model = HedgeMLP(n_features=3)
    with pytest.raises(ValueError, match="pinball objective"):
        fit_gn_pinball(model, model.init(), *(torch.tensor(a) for a in regression(1)),
                       loss_fn=losses.make_loss("pinball"), final_solve=True)
    with pytest.raises(ValueError, match="MSE only"):
        from orp_tpu_torch.train.gn import fit_gn
        fit_gn(model, model.init(), *(torch.tensor(a) for a in regression(1)),
               loss_fn=losses.make_loss("pinball"))


@pytest.fixture(scope="module")
def walk_inputs():
    """Pension paths (the kernel's plain twin), 1,024 x 8 steps stored every 2
    (4 dates), as the pipeline builds them, in f64."""
    cfg = tapi.HedgeRunConfig(sim=tapi.SimConfig(**dict(SIM, rebalance_every=2)))
    inp = tpipe.pension_inputs(cfg, "t", torch.device("cpu"))
    arrays = tuple(t.double().numpy() for t in (inp.features, inp.y, inp.b, inp.terminal))
    return arrays, inp.bias_init


def jax_walk_init(dtype, bias) -> tuple[dict, dict]:
    """The JAX walk's cold-start draws: ``model.init`` on keys 0 and 1 of ``split(key(1234))``."""
    ks = jax.random.split(jax.random.key(1234), 3)
    m = JHedgeMLP(n_features=3, dtype=dtype)
    return tuple({k: np.asarray(v) for k, v in m.init(ks[i], bias_init=bias).items()}
                 for i in (0, 1))


@pytest.mark.parametrize("dual_mode, combine", [("separate", "single"), ("shared", "py"),
                                                ("separate", "py")])
def test_walk_matches_jax_in_f64(walk_inputs, dual_mode, combine):
    arrays, bias = walk_inputs
    init = jax_walk_init(jnp.float64, bias)
    cfg = dict(GN, dual_mode=dual_mode, holdings_combine=combine, gn_iters_first=12,
               gn_iters_warm=6)
    want = jbackward_induction(JHedgeMLP(n_features=3, dtype=jnp.float64),
                               *(jnp.asarray(a) for a in arrays), JBackwardConfig(**cfg),
                               initial_params=init)
    got = backward_induction(HedgeMLP(n_features=3, dtype=torch.float64),
                             *(torch.tensor(a) for a in arrays), BackwardConfig(**cfg),
                             initial_params=init)
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-9, err_msg=k)
    for which in ("params1_by_date", "params2_by_date"):
        w = getattr(want, which)
        if w is None:
            assert getattr(got, which) is None
            continue
        for k, v in w.items():
            np.testing.assert_allclose(getattr(got, which)[k].numpy(), np.asarray(v),
                                       rtol=1e-7, atol=1e-7, err_msg=f"{which} {k}")
    for k in ("train_loss", "train_mae", "train_mape"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got.epochs_ran, want.epochs_ran)
    assert (got.params2_by_date is not None) == (dual_mode == "separate")
    # the quantile leg's own record (no JAX counterpart): per date, finite, within its budget
    assert got.quantile_loss.shape == (4,) and np.isfinite(got.quantile_loss).all()
    assert got.quantile_epochs_ran.max() <= 12 and got.quantile_epochs_ran.dtype == np.int64


def test_initial_params_order_and_fallbacks():
    """params1 then (separate only) params2 from one seeded generator;
    ``initial_params=(p1, None)`` keeps the seeded params2; ``shared`` ignores p2."""
    model = HedgeMLP(n_features=3)
    gen = torch.Generator().manual_seed(5)
    d1, d2 = model.init(gen, bias_init=(0.6, 0.4)), model.init(gen, bias_init=(0.6, 0.4))
    cpu = torch.device("cpu")
    sep = BackwardConfig(**GN, seed=5)
    p1, p2 = _initial_params(model, sep, (0.6, 0.4), None, cpu, torch.float32)
    assert all(torch.equal(p1[k], d1[k]) and torch.equal(p2[k], d2[k]) for k in d1)
    w = {k: np.full(v.shape, 0.5, np.float32) for k, v in d1.items()}
    p1, p2 = _initial_params(model, sep, (0.6, 0.4), (w, None), cpu, torch.float32)
    assert all(float(p1[k].min()) == 0.5 and torch.equal(p2[k], d2[k]) for k in d1)
    shared = dataclasses.replace(sep, dual_mode="shared")
    p1, p2 = _initial_params(model, shared, (0.6, 0.4), (w, d2), cpu, torch.float32)
    assert p2 is p1 and all(float(p1[k].min()) == 0.5 for k in d1)


ADAM_SMALL = dict(epochs_first=40, epochs_warm=10, batch_size=256)


@pytest.mark.parametrize("cfg, match", [
    (dict(ADAM_SMALL, dual_mode="shared"), None),                   # Adam: runs
    (dict(GN, **ADAM_SMALL, dual_mode="shared", gn_quantile=False), None),  # Adam quantile leg
    (dict(GN, dual_mode="separate", fused=True), "fused=True"),
])
def test_pension_hedge_refuses_before_simulating(cfg, match):
    """Each walk that was once refused runs. Adam and the Adam quantile leg: V0
    within 5% of the JAX pipeline's on the same config (each package from its
    own seeded init, as ``test_pension_hedge_entry_point_runs``;
    ``tests/test_torch_adam_walk.py`` holds the walk from JAX's init). The
    fused walk (``fused=True``): bitwise the host loop's pension hedge, both
    legs' iterations equal (``tests/test_torch_fused_walk.py`` holds it to
    JAX's fused walk)."""
    tcfg = tapi.HedgeRunConfig(sim=tapi.SimConfig(**SIM), train=tapi.TrainConfig(**cfg))
    if match is None:
        want = japi.pension_hedge(japi.HedgeRunConfig(sim=japi.SimConfig(**SIM),
                                                      train=japi.TrainConfig(**cfg)))
        res = tapi.pension_hedge(tcfg, device="cpu")
        assert np.isfinite([res.v0, res.phi0, res.psi0]).all()
        assert abs(res.v0 / want.v0 - 1) < 0.05, (res.v0, want.v0)
        assert res.backward.quantile_epochs_ran.max() <= ADAM_SMALL["epochs_first"]
        return
    fused = tapi.pension_hedge(tcfg, device="cpu").backward
    host = tapi.pension_hedge(dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, fused=False)), device="cpu").backward
    for k in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(fused, k), getattr(host, k)), k
    for which in ("params1_by_date", "params2_by_date"):
        for k, v in getattr(host, which).items():
            assert torch.equal(getattr(fused, which)[k], v), (which, k)
    for k in ("epochs_ran", "quantile_epochs_ran", "train_loss", "quantile_loss"):
        np.testing.assert_array_equal(getattr(fused, k), getattr(host, k), err_msg=k)


def _band(got, want, v0_rtol: float = 2e-3) -> None:
    v0 = want.report.v0
    np.testing.assert_allclose(got.report.v0, v0, rtol=v0_rtol)
    for k in ("phi0", "psi0"):
        assert abs(getattr(got.report, k) - getattr(want.report, k)) <= 0.02 * v0, k


@pytest.fixture(scope="module", params=[("shared", "py"), ("separate", "single")])
def pension_runs(request):
    dual_mode, combine = request.param
    train = dict(GN, dual_mode=dual_mode, holdings_combine=combine, gn_iters_first=20,
                 gn_iters_warm=10)
    jcfg = japi.HedgeRunConfig(sim=japi.SimConfig(**SIM), train=japi.TrainConfig(**train))
    tcfg = tapi.HedgeRunConfig(sim=tapi.SimConfig(**SIM), train=tapi.TrainConfig(**train))
    want = japi.pension_hedge(jcfg)
    # the port's pipeline inputs, walked from the JAX walk's initial params
    inp = tpipe.pension_inputs(tcfg, "pension_hedge", torch.device("cpu"))
    grid = japi.pipelines.TimeGrid(jcfg.sim.T, jcfg.sim.n_steps)
    y_t = japi.pipelines._simulate_pension_paths(jcfg, None, grid, "t")["Y"][:, -1]
    otm = float(jnp.mean(y_t < 1.0))
    assert inp.bias_init == pytest.approx((1.0 - otm, otm))
    res = backward_induction(HedgeMLP(n_features=3), inp.features, inp.y, inp.b, inp.terminal,
                             tpipe._backward_cfg(tcfg.train),
                             initial_params=jax_walk_init(jnp.float32, (1.0 - otm, otm)))
    got = tpipe._pension_result(tcfg, inp, res, HedgeMLP(n_features=3), "sort")
    return jcfg, tcfg, want, got


def test_pension_hedge_matches_jax(pension_runs):
    jcfg, tcfg, want, got = pension_runs
    _band(got, want)
    assert got.backward.values.shape == (1024, 3) and got.sim_seed == want.sim_seed == 1234
    np.testing.assert_allclose(got.times, want.times, rtol=1e-6)
    assert got.adjustment_factor == want.adjustment_factor == 1e6
    np.testing.assert_allclose(got.report.discounted_payoff, want.report.discounted_payoff,
                               rtol=1e-5)
    assert got.dual_mode == tcfg.train.dual_mode
    assert (got.backward.params2_by_date is None) == (tcfg.train.dual_mode == "shared")


def test_pension_hedge_entry_point_runs(pension_runs):
    """``pension_hedge`` itself (the port's own seeded init) on the same config."""
    _, tcfg, want, _ = pension_runs
    res = tapi.pension_hedge(tcfg, device="cpu")
    assert np.isfinite([res.v0, res.phi0, res.psi0]).all()
    assert abs(res.v0 / want.v0 - 1) < 0.05
    assert res.model.n_params() == 122 and res.backward.phi.shape == (1024, 2)


def test_pension_oos_matches_jax(pension_runs):
    """The JAX-trained policy replayed by both packages on fresh paths (tight),
    the port's own policy inside the walk's band, and the refusals."""
    jcfg, tcfg, want, got = pension_runs
    fresh = dict(seed=4321)
    jo, to = (dataclasses.replace(c, sim=dataclasses.replace(c.sim, **fresh))
              for c in (jcfg, tcfg))
    dual = tcfg.train.dual_mode
    meta = {"model": model_meta(HedgeMLP(n_features=3)), "times": want.times.tolist(),
            "adjustment_factor": want.adjustment_factor, "dual_mode": dual,
            "holdings_combine": tcfg.train.holdings_combine, "cost_of_capital": 0.1,
            "sim_seed": want.sim_seed}
    p2 = want.backward.params2_by_date
    jpolicy = policy_from_numpy(
        meta, {k: np.asarray(v, np.float32) for k, v in want.backward.params1_by_date.items()},
        None if p2 is None else {k: np.asarray(v, np.float32) for k, v in p2.items()})
    want_oos = japi.pension_oos(want, jo)
    with pytest.warns(UserWarning, match="shared") if dual == "shared" else _nothing():
        got_oos = tapi.pension_oos(jpolicy, to, device="cpu")
    for k in ("v0", "phi0", "psi0", "discounted_payoff"):
        np.testing.assert_allclose(getattr(got_oos.report, k), getattr(want_oos.report, k),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got_oos.report.var_overall, want_oos.report.var_overall,
                               rtol=1e-3, atol=1e-3 * want_oos.report.v0)
    own = tapi.pension_oos(got, to, device="cpu")
    _band(own, want_oos, 2e-2 if dual == "shared" else 2e-3)
    # t=0 features are the same on every path: the replayed holdings equal training's
    np.testing.assert_allclose([own.phi0, own.psi0], [got.phi0, got.psi0], rtol=1e-5)
    with pytest.raises(ValueError, match="TRAINING seed"):
        tapi.pension_oos(got, tcfg, device="cpu")
    other = "separate" if dual == "shared" else "shared"
    with pytest.raises(ValueError, match="dual_mode"):
        tapi.pension_oos(got, dataclasses.replace(to, train=dataclasses.replace(
            to.train, dual_mode=other)), device="cpu")


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cfg_from_params_matches_jax():
    """The flat-dict mapping, the 'c' collision's fix and the SV initial vol."""
    sv_params = {k: v for k, v in REF_PARAMS.items() if k != "sigma"} | {"s0": 0.16}
    for params, sv_c in ((REF_PARAMS, None), (REF_PARAMS, 0.02), (sv_params, 0.01583)):
        want = j_cfg_from_params(params, sv_c=sv_c)
        got = tpipe._cfg_from_params(params, sv_c=sv_c)
        for part in ("market", "actuarial", "sv"):
            w, g = getattr(want, part), getattr(got, part)
            assert (w is None) == (g is None)
            if w is not None:
                assert dataclasses.asdict(g) == dataclasses.asdict(w), part
        for f in ("n_paths", "T", "dt", "rebalance_every", "seed"):
            assert getattr(got.sim, f) == getattr(want.sim, f), f
    assert tpipe._cfg_from_params(REF_PARAMS, sv_c=0.02).actuarial.mort_c == 0.075


def test_reference_shims_need_a_gauss_newton_train():
    """The shims run at the JAX package's defaults when no ``train`` is given
    (Adam 500/100, ``separate``, exact binomial thinning on the scan path; here
    the tiny grid: 256 paths, 2 dates): phi0 + psi0 within 2% of the JAX
    shim's (measured -0.35%; the port's seeds 1-3 -0.84% to +0.004%, the
    phi0/psi0 split moving more). The Pallas engine refuses exact thinning, as
    the JAX package's does."""
    want = sum(japi.replicating_portfolio(REF_PARAMS))
    phi, psi = tapi.replicating_portfolio(REF_PARAMS, device="cpu")
    assert np.isfinite([phi, psi]).all() and abs((phi + psi) / want - 1) < 0.02, (phi, psi)
    phi_sv, psi_sv = tapi.replicating_portfolio_sv(REF_PARAMS, train=tapi.TrainConfig(),
                                                   device="cpu")
    assert np.isfinite([phi_sv, psi_sv]).all() and 1e4 < phi_sv + psi_sv < 5e6
    with pytest.raises(ValueError, match="engine='pallas' supports binomial_mode"):
        tapi.pension_hedge(tapi.HedgeRunConfig(sim=tapi.SimConfig(
            **dict(SIM, binomial_mode="exact")), train=tapi.TrainConfig(**GN)), device="cpu")
    with pytest.raises(ValueError, match="SV fund"):
        tapi.sigma_sweep([0.1], tapi.HedgeRunConfig(sv=tapi.StochVolConfig()), device="cpu")
    train = tapi.TrainConfig(**GN, dual_mode="shared", holdings_combine="py", gn_iters_first=6,
                             gn_iters_warm=3)
    phi, psi = tapi.replicating_portfolio(REF_PARAMS, train, binomial_mode="inversion",
                                          device="cpu")
    phi_sv, psi_sv = tapi.replicating_portfolio_sv(REF_PARAMS, train=train,
                                                   binomial_mode="inversion", device="cpu")
    assert np.isfinite([phi, psi, phi_sv, psi_sv]).all() and 1e4 < phi + psi < 5e6
    rows = tapi.sigma_sweep([0.05, 0.3], tapi.HedgeRunConfig(
        sim=tapi.SimConfig(n_paths=256, T=2.0, dt=1 / 12, rebalance_every=12,
                           binomial_mode="inversion"), train=train), device="cpu")
    assert [r["sigma"] for r in rows] == [0.05, 0.3]
    assert rows[1]["total"] > rows[0]["total"]  # a dearer guarantee at higher vol
