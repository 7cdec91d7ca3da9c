"""Port parity: the Gauss-Newton backward walk (``orp_tpu_torch/train/backward.py``)
and the training pipelines (``european_hedge``, ``heston_hedge``,
``heston_oos``) against the JAX package, from the same JAX-initialised params
(JAX's threefry init cannot be reproduced by torch, so both sides start from
``model.init`` of the JAX package, passed as ``initial_params`` /
``warm_start``).

Tolerances and why:
- the walk in float64: values, holdings and per-date params at ``rtol=1e-7``
  (the same LM iterations; f64 leaves no borderline accept/reject);
- the walk in float32 and the pipelines: the Levenberg-Marquardt
  accept/reject branches on float compares, so f32 trajectories may part;
  the pins are the hedged-CV and OLS-martingale prices within 0.5bp
  (measured at 1,024 paths, dt=1/16, 8 dates: heston |dv0_cv| 0.001bp,
  |dv0_acv| 0.012bp; european 0.002bp / 0.18bp) and the network's v0 at
  ``rtol=1e-3``. At 4,096 paths x 52 dates the trajectories do part and the
  band widens (``tests/test_torch_fixture.py``, ``tools/torch_walk_spread.py``);
- a replay of the same policy on the same engine (``heston_oos``): report
  fields at ``rtol=1e-4`` and the OLS price within 0.05bp, as
  ``tests/test_torch_oos.py`` holds ``european_oos``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu import api as japi
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train.backward import BackwardConfig as JBackwardConfig
from orp_tpu.train.backward import backward_induction as jbackward_induction
from orp_tpu_torch import api as tapi
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.qmc import heston_qe_plain
from orp_tpu_torch.serve import policy_from_numpy
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.train import BackwardConfig, backward_induction

KW = dict(s0=100.0, mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
SIM = dict(n_paths=1024, T=1.0, dt=1 / 16, rebalance_every=2, engine="pallas")
GN = dict(dual_mode="mse_only", optimizer="gauss_newton")


def jax_init(n_features: int, dtype=jnp.float32, bias=(0.1, 0.0), seed: int = 1234) -> dict:
    """The JAX walk's cold-start params: ``model.init`` on ``split(key(seed))[0]``."""
    k1 = jax.random.split(jax.random.key(seed), 3)[0]
    p = JHedgeMLP(n_features=n_features, dtype=dtype).init(k1, bias_init=bias)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def walk_inputs():
    """Heston QE paths, 1,024 x 16 steps stored every 2 (8 dates), in f64."""
    tr = heston_qe_plain(1024, 16, dt=1 / 16, seed=5, store_every=2, **KW)
    s = tr["S"].double().numpy() / 100.0
    v = tr["v"].double().numpy()
    b = np.exp(0.08 * np.linspace(0.0, 1.0, 9)) / 100.0
    return np.stack([s, v], -1), s, b, np.maximum(s[:, -1] - 1.0, 0.0)


@pytest.mark.parametrize("final_solve, block_rows", [(False, None), (True, None),
                                                     (False, 256)])
def test_walk_matches_jax_in_f64(walk_inputs, final_solve, block_rows):
    feats, s, b, term = walk_inputs
    init = jax_init(2, jnp.float64)
    cfg = dict(GN, gn_iters_first=12, gn_iters_warm=6, final_solve=final_solve,
               gn_block_rows=block_rows)
    want = jbackward_induction(JHedgeMLP(n_features=2, dtype=jnp.float64),
                               *(jnp.asarray(a) for a in (feats, s, b, term)),
                               JBackwardConfig(**cfg), initial_params=(init, None))
    got = backward_induction(HedgeMLP(n_features=2, dtype=torch.float64),
                             *(torch.tensor(a) for a in (feats, s, b, term)),
                             BackwardConfig(**cfg), initial_params=(init, None))
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
    for k, v in want.params1_by_date.items():
        np.testing.assert_allclose(got.params1_by_date[k].numpy(), np.asarray(v), rtol=1e-7,
                                   atol=1e-10, err_msg=k)
    for k in ("train_loss", "train_mae", "train_mape"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got.epochs_ran, want.epochs_ran)
    assert got.epochs_ran.dtype == np.int64 and got.params2_by_date is None


def test_walk_in_f32_from_seeded_init(walk_inputs):
    """The port's own init (no ``initial_params``): the walk runs, its ledgers
    have the JAX shapes and the first fitted date takes ``gn_iters_first``."""
    feats, s, b, term = (torch.tensor(a, dtype=torch.float32) for a in walk_inputs)
    res = backward_induction(HedgeMLP(n_features=2), feats, s, b, term,
                             BackwardConfig(**GN, gn_iters_first=7, gn_iters_warm=3),
                             bias_init=(0.1, 0.0))
    assert res.values.shape == (1024, 9) and res.phi.shape == (1024, 8)
    assert res.params1_by_date["w1"].shape == (8, 8, 8)
    assert res.epochs_ran[-1] <= 7 and res.epochs_ran[:-1].max() <= 3
    assert np.isfinite(res.train_loss).all() and torch.isfinite(res.values).all()
    torch.testing.assert_close(res.values[:, -1], term)


ADAM_SMALL = dict(epochs_first=8, epochs_warm=4, batch_size=256, shuffle=False)


@pytest.mark.parametrize("cfg, match", [
    (dict(ADAM_SMALL, dual_mode="mse_only"), None),             # optimizer="adam": runs
    (dict(GN, **ADAM_SMALL, dual_mode="separate", gn_quantile=False), None),  # Adam quantile leg
    (dict(GN, fused=True), "fused=True"),
    (dict(GN, checkpoint_dir="ckpt"), "checkpoint_dir"),
    (dict(GN, nan_guard=True), "nan_guard=True"),
])
def test_walk_refuses_what_is_not_ported(walk_inputs, cfg, match, tmp_path):
    """Each walk that was once refused runs. Adam and the Adam quantile leg: the
    walk in f64 from the JAX walk's two initial param sets matches JAX's at
    ``rtol=1e-7`` with the same epochs per date (``tests/test_torch_adam_walk.py``
    holds every dual mode and shuffle), and ``european_hedge`` runs with them.
    ``fused=True``, ``checkpoint_dir`` (in ``tmp_path``) and ``nan_guard=True``
    (ROADMAP A3): the walk in f64 matches JAX's same walk at ``rtol=1e-7`` with
    the same iterations, is bitwise the port's plain host loop, and
    ``european_hedge`` runs with it."""
    jcfg = cfg
    if match == "checkpoint_dir":  # each package in a directory of its own
        cfg, jcfg = (dict(cfg, checkpoint_dir=str(tmp_path / d)) for d in ("ckpt", "jax"))
    sim = tapi.SimConfig(n_paths=64, T=1.0, dt=0.25, rebalance_every=1)
    feats, s, b, term = walk_inputs
    ks = jax.random.split(jax.random.key(1234), 3)
    init = tuple({k: np.asarray(v) for k, v in JHedgeMLP(n_features=2, dtype=jnp.float64)
                  .init(ks[i], bias_init=(0.1, 0.0)).items()} for i in (0, 1))
    want = jbackward_induction(JHedgeMLP(n_features=2, dtype=jnp.float64),
                               *(jnp.asarray(a) for a in (feats, s, b, term)),
                               JBackwardConfig(**jcfg), initial_params=init)
    model = HedgeMLP(n_features=2, dtype=torch.float64)
    got = backward_induction(model, *(torch.tensor(a) for a in (feats, s, b, term)),
                             BackwardConfig(**cfg), initial_params=init)
    for k in ("values", "phi", "psi"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(got.epochs_ran, want.epochs_ran)
    if match is not None:
        plain = {k: v for k, v in cfg.items() if k not in ("fused", "checkpoint_dir", "nan_guard")}
        host = backward_induction(model, *(torch.tensor(a) for a in (feats, s, b, term)),
                                  BackwardConfig(**plain), initial_params=init)
        for k in ("values", "phi", "psi", "var_residuals"):
            assert torch.equal(getattr(got, k), getattr(host, k)), k
        np.testing.assert_array_equal(got.train_loss, host.train_loss)
        if match == "checkpoint_dir":
            cfg = dict(cfg, checkpoint_dir=str(tmp_path / "pipeline"))
    rep = tapi.european_hedge(tapi.EuropeanConfig(), sim, tapi.TrainConfig(**cfg),
                              device="cpu").report
    assert np.isfinite([rep.v0, rep.v0_cv, rep.v0_acv]).all()


def _assert_prices(got, want, bp: float = 0.5):
    for k in ("v0_cv", "v0_acv"):
        a, b = getattr(got.report, k), getattr(want.report, k)
        assert abs(a - b) / b * 1e4 <= bp, (k, a, b)
    np.testing.assert_allclose(got.report.v0, want.report.v0, rtol=1e-3)
    np.testing.assert_allclose(got.report.v0_plain, want.report.v0_plain, rtol=1e-5)


@pytest.fixture(scope="module")
def heston_runs():
    warm = (jax_init(2), None)
    want = japi.heston_hedge(None, japi.SimConfig(**SIM), japi.TrainConfig(**GN),
                             warm_start=warm)
    got = tapi.heston_hedge(None, tapi.SimConfig(**SIM), tapi.TrainConfig(**GN),
                            warm_start=warm, device="cpu")
    return want, got


def test_heston_hedge_matches_jax(heston_runs):
    want, got = heston_runs
    _assert_prices(got, want)
    assert got.backward.values.shape == (1024, 9) and got.sim_seed == want.sim_seed
    np.testing.assert_allclose(got.times, want.times, rtol=1e-6)
    assert got.model.n_features == 2 and got.dual_mode == "mse_only"


def test_heston_oos_matches_jax(heston_runs):
    """The JAX-trained policy replayed by both packages on fresh paths (tight),
    and each package's own trained policy (the 0.5bp band)."""
    want, got = heston_runs
    sim = dict(SIM, seed_fund=4321)
    meta = {"model": model_meta(HedgeMLP(n_features=2)), "times": want.times.tolist(),
            "adjustment_factor": 100.0, "dual_mode": "mse_only", "holdings_combine": "single",
            "cost_of_capital": 0.1, "sim_seed": want.sim_seed}
    jpolicy = policy_from_numpy(meta, {k: np.asarray(v, np.float32) for k, v in
                                       want.backward.params1_by_date.items()})
    jsim, tsim = japi.SimConfig(**sim), tapi.SimConfig(**sim)
    jtrain, ttrain = japi.TrainConfig(**GN), tapi.TrainConfig(**GN)
    want_oos = japi.heston_oos(want, None, jsim, jtrain)
    got_oos = tapi.heston_oos(jpolicy, None, tsim, ttrain, device="cpu")
    for k in ("v0", "phi0", "v0_plain", "v0_cv", "cv_std", "acv_std"):
        np.testing.assert_allclose(getattr(got_oos.report, k), getattr(want_oos.report, k),
                                   rtol=1e-4, err_msg=k)
    assert abs(got_oos.report.v0_acv - want_oos.report.v0_acv) / want_oos.report.v0_acv \
        * 1e4 <= 0.05
    _assert_prices(tapi.heston_oos(got, None, tsim, ttrain, device="cpu"), want_oos)
    with pytest.raises(ValueError, match="TRAINING seed"):
        tapi.heston_oos(got, None, dataclasses.replace(tsim, seed_fund=got.sim_seed), ttrain,
                        device="cpu")


@pytest.mark.parametrize("constrain", [False, True])
def test_european_hedge_matches_jax(constrain):
    bias = (0.1,) if constrain else (0.1, 0.0)
    k1 = jax.random.split(jax.random.key(1234), 3)[0]
    init = {k: np.asarray(v) for k, v in JHedgeMLP(
        n_features=1, constrain_self_financing=constrain).init(k1, bias_init=bias).items()}
    want = japi.european_hedge(japi.EuropeanConfig(constrain_self_financing=constrain),
                               japi.SimConfig(**SIM), japi.TrainConfig(**GN),
                               warm_start=(init, None))
    got = tapi.european_hedge(tapi.EuropeanConfig(constrain_self_financing=constrain),
                              tapi.SimConfig(**SIM), tapi.TrainConfig(**GN),
                              warm_start=(init, None), device="cpu")
    _assert_prices(got, want)
    assert got.backward.phi.shape == (1024, 8) and got.model.n_features == 1
