"""Port parity: the Gauss-Newton fit (``orp_tpu_torch/train/gn.py``), the
network's training half (``HedgeMLP.init``, ``solve_readout``,
``value_jacobian``) and the MSE metrics against the JAX package.

Tolerances and why:
- in float64 the port and JAX run the same LM iterations: final loss at
  ``rtol=1e-9``, the loss history at ``rtol=1e-8``, the same accepted-step
  count. This pins the algorithm;
- in float32 the Gram's normal equations square a condition number near
  f32's limit, and accept/reject branches on float compares, so from a cold
  start the two trajectories part within a few iterations (measured 0.7% on
  the third iteration's loss, where f64 agrees to the last digit). The f32
  pin is the walk's regime, a warm-started 10-iteration fit: final loss at
  ``rtol=1e-4``;
- ``solve_readout`` (one ridge-shrunk normal-equations solve of a Gram that
  is ill-conditioned by construction, the risky and bond legs correlating
  across paths): ``rtol=1e-4`` in f32 (measured 1.1e-5), ``1e-10`` in f64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train import losses as JL
from orp_tpu.train.gn import GNConfig as JGNConfig
from orp_tpu.train.gn import fit_gn as jfit_gn
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import losses
from orp_tpu_torch.train.gn import GNConfig, fit_gn

N = 4096


def regression(seed: int, dtype=np.float32):
    """A walk-like date: features ``(S_t/S0, v_t)``, prices ``(S_{t+1}/S0,
    B/S0)``, target the discounted call on ``S_{t+1}``."""
    rng = np.random.default_rng(seed)
    s = np.exp(0.15 * rng.standard_normal(N) - 0.01)
    v = 0.0225 * rng.gamma(4.0, 0.25, N)
    s1 = s * np.exp(np.sqrt(v / 52) * rng.standard_normal(N) - v / 104)
    feats = np.stack([s, v], 1)
    prices = np.stack([s1, np.full(N, np.exp(0.08 * 0.5) / 100.0)], 1)
    y = np.maximum(s1 - 1.0, 0.0) * np.exp(-0.08 * 0.5)
    return tuple(a.astype(dtype) for a in (feats, prices, y))


def jax_params(model: JHedgeMLP, seed: int = 0) -> dict:
    p = model.init(jax.random.key(seed), bias_init=(0.05, 0.0))
    return {k: np.asarray(v) for k, v in p.items()}


def run_both(params: dict, data, n_iters: int, dtype, constrain=False, block_rows=None):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.float64,
                                                                         torch.float64)
    jm = JHedgeMLP(n_features=2, dtype=jdt, constrain_self_financing=constrain)
    tm = HedgeMLP(n_features=2, dtype=tdt, constrain_self_financing=constrain)
    jp, jaux = jfit_gn({k: jnp.asarray(v, jdt) for k, v in params.items()},
                       *(jnp.asarray(a, jdt) for a in data), None, value_fn=jm.value,
                       loss_fn=JL.mse, cfg=JGNConfig(n_iters=n_iters, block_rows=block_rows),
                       metric_fns=(JL.mae, JL.mape))
    tp, taux = fit_gn(tm, {k: torch.tensor(v, dtype=tdt) for k, v in params.items()},
                      *(torch.tensor(a, dtype=tdt) for a in data),
                      cfg=GNConfig(n_iters=n_iters, block_rows=block_rows))
    return (jp, jaux), (tp, taux)


@pytest.mark.parametrize("constrain", [False, True])
@pytest.mark.parametrize("block_rows", [None, 1024])
def test_fit_gn_matches_jax_in_f64(constrain, block_rows):
    params = jax_params(JHedgeMLP(n_features=2, dtype=jnp.float64,
                                  constrain_self_financing=constrain))
    (jp, jaux), (tp, taux) = run_both(params, regression(1, np.float64), 30, np.float64,
                                      constrain, block_rows)
    np.testing.assert_allclose(float(taux["final_loss"]), float(jaux["final_loss"]), rtol=1e-9)
    np.testing.assert_allclose(taux["loss_history"].numpy(), np.asarray(jaux["loss_history"]),
                               rtol=1e-8)
    assert int(taux["n_epochs_ran"]) == int(jaux["n_epochs_ran"])
    for k in ("best_loss", "mae", "mape"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-8, err_msg=k)
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_fit_gn_matches_jax_in_f32_warm_started():
    """The walk's regime: params already fitted at the neighbouring date."""
    jm = JHedgeMLP(n_features=2, dtype=jnp.float32)
    warm, _ = jfit_gn({k: jnp.asarray(v) for k, v in jax_params(jm).items()},
                      *(jnp.asarray(a) for a in regression(1)), None, value_fn=jm.value,
                      loss_fn=JL.mse, cfg=JGNConfig(n_iters=30))
    warm = {k: np.asarray(v) for k, v in warm.items()}
    (_, jaux), (_, taux) = run_both(warm, regression(2), 10, np.float32)
    np.testing.assert_allclose(float(taux["final_loss"]), float(jaux["final_loss"]), rtol=1e-4)
    assert int(taux["n_epochs_ran"]) == int(jaux["n_epochs_ran"])
    assert taux["final_loss"].dtype == torch.float32


def test_frozen_fit_leaves_params_unchanged_and_records_inf():
    """Once an accepted step gains less than ``min_rel_improve`` the fit
    freezes: later iterations record ``inf`` and change nothing."""
    params = jax_params(JHedgeMLP(n_features=2, dtype=jnp.float64))
    model = HedgeMLP(n_features=2, dtype=torch.float64)
    data = [torch.tensor(a) for a in regression(1, np.float64)]
    p0 = {k: torch.tensor(v) for k, v in params.items()}
    cfg = GNConfig(n_iters=200, min_rel_improve=1e-3)
    long_p, long_aux = fit_gn(model, p0, *data, cfg=cfg)
    hist = long_aux["loss_history"].numpy()
    frozen_at = int(np.argmax(np.isinf(hist)))
    assert 0 < frozen_at < 200 and np.isinf(hist[frozen_at:]).all()
    assert np.isfinite(hist[:frozen_at]).all() and (np.diff(hist[:frozen_at]) <= 0).all()
    short_p, short_aux = fit_gn(model, p0, *data,
                                cfg=GNConfig(n_iters=frozen_at, min_rel_improve=1e-3))
    for k in long_p:
        torch.testing.assert_close(long_p[k], short_p[k], rtol=0, atol=0)
    assert float(long_aux["best_loss"]) == float(short_aux["best_loss"])


def test_fit_gn_refusals():
    model = HedgeMLP(n_features=2)
    data = [torch.tensor(a) for a in regression(1)]
    p0 = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MSE only"):
        fit_gn(model, p0, *data, loss_fn=losses.mae)
    with pytest.raises(ValueError, match="does not divide"):
        fit_gn(model, p0, *data, cfg=GNConfig(n_iters=1, block_rows=1000))
    # n <= block_rows needs no blocking
    fit_gn(model, p0, *data, cfg=GNConfig(n_iters=1, block_rows=N))


def test_fit_runs_in_full_f32_without_tf32(monkeypatch):
    """Every Gram and solve of a fit runs with TF32 off and matmul precision
    "highest", whatever the caller set before."""
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
        model = HedgeMLP(n_features=2)
        data = [torch.tensor(a) for a in regression(1)]
        fit_gn(model, model.init(torch.Generator().manual_seed(0)), *data,
               cfg=GNConfig(n_iters=3), final_solve=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])
    assert len(seen) == 4  # three LM solves and the readout solve
    assert all(s == (False, False, "highest") for s in seen)


@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-4), (np.float64, 1e-10)])
@pytest.mark.parametrize("constrain", [False, True])
def test_solve_readout_matches_jax(dtype, rtol, constrain):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.float64,
                                                                         torch.float64)
    jm = JHedgeMLP(n_features=2, dtype=jdt, constrain_self_financing=constrain)
    tm = HedgeMLP(n_features=2, dtype=tdt, constrain_self_financing=constrain)
    params = jax_params(jm)
    data = regression(3, dtype)
    want = jm.solve_readout({k: jnp.asarray(v) for k, v in params.items()},
                            *(jnp.asarray(a) for a in data))
    got = tm.solve_readout({k: torch.tensor(v) for k, v in params.items()},
                           *(torch.tensor(a) for a in data))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rtol, atol=rtol * 1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("model", [
    HedgeMLP(n_features=2, dtype=torch.float64),
    HedgeMLP(n_features=1, constrain_self_financing=True, dtype=torch.float64),
    HedgeMLP(n_features=3, hidden=(5, 4, 6), n_hedge_assets=2, dtype=torch.float64),
])
def test_value_jacobian_is_the_autodiff_gradient(model):
    """The closed-form per-sample gradient equals ``torch.func`` autodiff (f64),
    in the flat order of JAX's ``ravel_pytree``, and its value is ``model.value``."""
    g = torch.Generator().manual_seed(1)
    params = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
              for k, v in model.init(g).items()}
    n = 64
    feats = torch.randn(n, model.n_features, generator=g, dtype=torch.float64)
    prices = 1.0 + 0.1 * torch.randn(n, model.n_outputs + model.constrain_self_financing,
                                     generator=g, dtype=torch.float64)
    value, J = model.value_jacobian(params, feats, prices)
    theta = model.flatten(params)
    want = torch.func.vmap(torch.func.grad(
        lambda t, f, p: model.value(model.unflatten(t), f[None], p[None])[0]),
        in_dims=(None, 0, 0))(theta, feats, prices)
    torch.testing.assert_close(J, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(value, model.value(params, feats, prices), rtol=0, atol=0)
    jtheta, _ = ravel_pytree({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    for k, v in model.unflatten(theta).items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)


def test_init_law_and_bias_init():
    """``init`` follows the JAX law: weights N(0, 1) * init_scale, zero biases,
    ``bias_init`` on the output bias; the draws come from the generator."""
    wide = HedgeMLP(n_features=64, hidden=(64, 64), init_scale=0.1)
    p = wide.init(torch.Generator().manual_seed(0))
    w = torch.cat([p[f"w{i}"].reshape(-1) for i in range(3)])
    assert abs(float(w.mean())) < 0.004 and abs(float(w.std()) - 0.1) < 0.004
    assert all(float(p[f"b{i}"].abs().max()) == 0.0 for i in range(3))
    model = HedgeMLP(n_features=2)
    a = model.init(torch.Generator().manual_seed(7), bias_init=(0.12, 0.0))
    b = model.init(torch.Generator().manual_seed(7), bias_init=(0.12, 0.0))
    c = model.init(torch.Generator().manual_seed(8))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["w0"], c["w0"])
    assert a["b2"].tolist() == pytest.approx([0.12, 0.0])
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in jax_params(JHedgeMLP(n_features=2)).items()}
    cons = HedgeMLP(n_features=1, constrain_self_financing=True)
    assert cons.init(bias_init=(0.3, 0.7))["b2"].tolist() == pytest.approx([0.3])
    with pytest.raises(ValueError, match="bias_init has 1"):
        model.init(bias_init=(0.1,))


def test_mse_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.standard_normal(1000).astype(np.float32), rng.standard_normal(
        1000).astype(np.float32)
    target[0] = 0.0  # the eps floor of mape
    for tf, jf in ((losses.mse, JL.mse), (losses.mae, JL.mae), (losses.mape, JL.mape)):
        np.testing.assert_allclose(float(tf(torch.tensor(pred), torch.tensor(target))),
                                   float(jf(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
