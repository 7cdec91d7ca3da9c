"""Port parity: the Adam backward walk (``orp_tpu_torch/train/backward.py`` with
``optimizer="adam"``, and the Gauss-Newton walk with the Adam quantile leg,
``gn_quantile=False``) and the Adam-trained pipelines against the JAX package,
from the same JAX-initialised params and on JAX's epoch orders (each fit's
``_epoch_order`` replaced by the permutations of its JAX key, as
``tests/test_torch_fit.py`` does for one fit).

Tolerances and why:
- the walk in float64: values, holdings and per-date params at ``rtol=1e-7``
  with ``atol=1e-9`` on ledgers and ``1e-7`` on params (as the GN walks,
  ``tests/test_torch_dual_walk.py``), per-date metrics at ``rtol=1e-7``, and
  ``epochs_ran`` equal on every date (the early stop on the same epoch);
- the pipelines in float32 on JAX's orders: Adam has no accept/reject branch,
  so the f32 runs part only by roundoff that the steps carry on. The pins
  are the network's V0 (pension) or the hedged-CV / OLS prices (European);
  their bands are about twice the largest gap of the port's runs with every
  stored knot of the risky price moved by -1, 0 or +1 ulp
  (``tools/torch_walk_spread.py``'s method; the numbers at each test).
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
from orp_tpu_torch.api import pipelines as tpipe
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import BackwardConfig, backward_induction
from orp_tpu_torch.train.backward import _fit_generator
from test_torch_fit import inject_jax_orders

SIM = dict(n_paths=256, T=2.0, dt=0.25, rebalance_every=2, engine="pallas",
           binomial_mode="inversion")
ADAM = dict(epochs_first=6, epochs_warm=6, patience_first=3, patience_warm=1, batch_size=64)
MODES = {
    "mse_only": dict(dual_mode="mse_only"),
    "separate": dict(dual_mode="separate"),
    "shared": dict(dual_mode="shared", holdings_combine="py"),
    "hybrid": dict(dual_mode="separate", optimizer="gauss_newton", gn_quantile=False,
                   gn_iters_first=4, gn_iters_warm=2),
}


def walk_keys(seed: int, n_dates: int, epochs_first: int, epochs_warm: int) -> dict:
    """Each fit's JAX epoch keys by the initial seed of the port's generator for
    that fit: the JAX walk splits ``kfit`` into ``(kfit, ka, kb)`` per date (``ka``
    the MSE fit, ``kb`` the quantile fit), and each fit its key into one per epoch."""
    kfit = jax.random.split(jax.random.key(seed), 3)[2]
    keys = {}
    for step_i in range(n_dates):
        kfit, ka, kb = jax.random.split(kfit, 3)
        n_epochs = epochs_first if step_i == 0 else epochs_warm
        for leg, k in ((0, ka), (1, kb)):
            keys[_fit_generator(seed, step_i, leg).initial_seed()] = jax.random.split(k, n_epochs)
    return keys


def jax_walk_init(dtype, bias, n_features: int = 3) -> tuple[dict, dict]:
    """The JAX walk's cold-start draws: ``model.init`` on keys 0 and 1 of ``split(key(1234))``."""
    ks = jax.random.split(jax.random.key(1234), 3)
    m = JHedgeMLP(n_features=n_features, dtype=dtype)
    return tuple({k: np.asarray(v) for k, v in m.init(ks[i], bias_init=bias).items()}
                 for i in (0, 1))


@pytest.fixture(scope="module")
def walk_inputs():
    """Pension paths (the kernel's plain twin), 256 x 8 steps stored every 2 (4
    dates), as the pipeline builds them, in f64."""
    inp = tpipe.pension_inputs(tapi.HedgeRunConfig(sim=tapi.SimConfig(**SIM)), "t",
                               torch.device("cpu"))
    arrays = tuple(t.double().numpy() for t in (inp.features, inp.y, inp.b, inp.terminal))
    return arrays, inp.bias_init


# lr=None: the schedule on the first date, warm_lr after; 5e-2 makes the fits stop early
@pytest.mark.parametrize("shuffle, lr", [(False, None), (True, 1e-1), ("blocks", 1e-1)])
@pytest.mark.parametrize("mode", list(MODES))
def test_adam_walk_matches_jax_in_f64(walk_inputs, monkeypatch, mode, shuffle, lr):
    arrays, bias = walk_inputs
    init = jax_walk_init(jnp.float64, bias)
    cfg = dict(ADAM, **MODES[mode], shuffle=shuffle, lr=lr)
    want = jbackward_induction(JHedgeMLP(n_features=3, dtype=jnp.float64),
                               *(jnp.asarray(a) for a in arrays), JBackwardConfig(**cfg),
                               initial_params=init)
    inject_jax_orders(monkeypatch, walk_keys(1234, 4, ADAM["epochs_first"],
                                             ADAM["epochs_warm"]))
    got = backward_induction(HedgeMLP(n_features=3, dtype=torch.float64),
                             *(torch.tensor(a) for a in arrays), BackwardConfig(**cfg),
                             initial_params=init)
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-9, err_msg=k)
    for which in ("params1_by_date", "params2_by_date"):
        w = getattr(want, which)
        assert (w is None) == (getattr(got, which) is None)
        for k, v in (w or {}).items():
            np.testing.assert_allclose(getattr(got, which)[k].numpy(), np.asarray(v),
                                       rtol=1e-7, atol=1e-7, err_msg=f"{which} {k}")
    for k in ("train_loss", "train_mae", "train_mape"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got.epochs_ran, want.epochs_ran)
    adam_eps = [got.quantile_epochs_ran] if mode != "mse_only" else []
    if mode != "hybrid":
        adam_eps.append(got.epochs_ran)
    for eps in adam_eps:  # Adam's epochs, within each date's budget
        assert eps[-1] <= ADAM["epochs_first"] and eps[:-1].max() <= ADAM["epochs_warm"]
    if mode != "mse_only":
        assert np.isfinite(got.quantile_loss).all()


def test_fit_generators_depend_on_seed_date_and_leg_alone():
    seeds = {(s, i, leg): _fit_generator(s, i, leg).initial_seed()
             for s in (1234, 7) for i in range(40) for leg in (0, 1)}
    assert len(set(seeds.values())) == len(seeds)
    assert _fit_generator(1234, 3, 1).initial_seed() == seeds[(1234, 3, 1)]


def test_walk_config_carries_the_reference_defaults():
    """``TrainConfig()`` and ``BackwardConfig()`` hold the JAX package's Adam
    fields and defaults, and the pipelines carry them into the walk."""
    jt, tt = japi.TrainConfig(), tapi.TrainConfig()
    for f in dataclasses.fields(tt):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    jb, tb = JBackwardConfig(), BackwardConfig()
    for f in dataclasses.fields(tb):
        assert getattr(tb, f.name) == getattr(jb, f.name), f.name
    t = tapi.TrainConfig(epochs_first=9, epochs_warm=3, patience_first=4, patience_warm=2,
                         batch_size=128, lr=2e-3, shuffle="blocks")
    b = tpipe._backward_cfg(t)
    assert (b.epochs_first, b.epochs_warm, b.patience_first, b.patience_warm, b.batch_size,
            b.lr, b.shuffle, b.warm_lr) == (9, 3, 4, 2, 128, 2e-3, "blocks", 5e-4)
    with pytest.raises(ValueError, match="optimizer"):
        BackwardConfig(optimizer="sgd")


def test_warm_dates_train_at_warm_lr(monkeypatch):
    """The first fitted date trains on the schedule (``lr=None``), the warm dates
    at ``warm_lr``; a set ``lr`` holds on every date (``orp_tpu/train/backward.py:951``)."""
    from orp_tpu_torch.train import backward

    seen = []
    real = backward.fit_core

    def spy(*a, cfg, **kw):
        seen.append((cfg.n_epochs, cfg.patience, cfg.lr))
        return real(*a, cfg=cfg, **kw)

    monkeypatch.setattr(backward, "fit_core", spy)
    n, d = 64, 3
    rng = np.random.default_rng(0)
    y = torch.tensor(np.exp(0.1 * rng.standard_normal((n, d + 1))))
    b = torch.linspace(1.0, 1.03, d + 1)
    for lr, want in ((None, [None, 5e-4, 5e-4]), (3e-3, [3e-3] * 3)):
        seen.clear()
        backward_induction(HedgeMLP(n_features=1, dtype=torch.float64), y[:, :, None], y, b,
                           torch.clamp(y[:, -1] - 1, min=0),
                           BackwardConfig(**ADAM, dual_mode="mse_only", lr=lr))
        assert [s[2] for s in seen] == want
        assert [s[:2] for s in seen] == [(6, 3), (6, 1), (6, 1)]


EURO_SIM = dict(n_paths=1024, T=1.0, dt=1 / 16, rebalance_every=2, engine="pallas")
EURO_TRAIN = dict(dual_mode="mse_only", epochs_first=40, epochs_warm=10, patience_first=10,
                  patience_warm=3, batch_size=256)
PENSION_SIM = dict(n_paths=1024, T=2.0, dt=0.25, rebalance_every=2, engine="pallas",
                   binomial_mode="inversion")
PENSION_TRAIN = dict(dual_mode="shared", holdings_combine="py", epochs_first=40, epochs_warm=10,
                     patience_first=10, patience_warm=3, batch_size=256)


def euro_init() -> dict:
    """The JAX walk's cold-start params of the constrained European head."""
    k1 = jax.random.split(jax.random.key(1234), 3)[0]
    p = JHedgeMLP(n_features=1, constrain_self_financing=True).init(k1, bias_init=(0.1,))
    return {k: np.asarray(v) for k, v in p.items()}


def euro_pair(monkeypatch):
    """``european_hedge`` with Adam in f32: the JAX pipeline, and the port's on JAX's
    orders from the same initial params."""
    n_dates = tapi.SimConfig(**EURO_SIM).n_rebalance
    warm = (euro_init(), None)
    want = japi.european_hedge(japi.EuropeanConfig(), japi.SimConfig(**EURO_SIM),
                               japi.TrainConfig(**EURO_TRAIN), warm_start=warm)
    inject_jax_orders(monkeypatch, walk_keys(1234, n_dates, EURO_TRAIN["epochs_first"],
                                             EURO_TRAIN["epochs_warm"]))
    got = tapi.european_hedge(tapi.EuropeanConfig(), tapi.SimConfig(**EURO_SIM),
                              tapi.TrainConfig(**EURO_TRAIN), warm_start=warm, device="cpu")
    return want, got


def pension_pair(monkeypatch):
    """``pension_hedge`` with the Adam dual walk (``shared`` + ``py``) in f32: the JAX
    pipeline, and the port's walk on its pipeline inputs from the JAX walk's initial
    params on JAX's orders (``pension_hedge`` itself starts from the port's own init)."""
    jcfg = japi.HedgeRunConfig(sim=japi.SimConfig(**PENSION_SIM),
                               train=japi.TrainConfig(**PENSION_TRAIN))
    tcfg = tapi.HedgeRunConfig(sim=tapi.SimConfig(**PENSION_SIM),
                               train=tapi.TrainConfig(**PENSION_TRAIN))
    want = japi.pension_hedge(jcfg)
    inp = tpipe.pension_inputs(tcfg, "pension_hedge", torch.device("cpu"))
    inject_jax_orders(monkeypatch, walk_keys(1234, tcfg.sim.n_rebalance,
                                             PENSION_TRAIN["epochs_first"],
                                             PENSION_TRAIN["epochs_warm"]))
    res = backward_induction(HedgeMLP(n_features=3), inp.features, inp.y, inp.b, inp.terminal,
                             tpipe._backward_cfg(tcfg.train),
                             initial_params=jax_walk_init(jnp.float32, inp.bias_init))
    return want, tpipe._pension_result(tcfg, inp, res, HedgeMLP(n_features=3), "sort")


def test_european_hedge_with_adam_matches_jax(monkeypatch):
    """Band: the hedged-CV price within 0.005bp, the OLS price within 0.12bp and
    the network's V0 at 3e-6 (16 one-ulp-perturbed runs: at most 0.0018bp /
    0.0587bp / 1.3e-6; unperturbed 0 / 0.0073bp / 8.9e-7)."""
    want, got = euro_pair(monkeypatch)
    for k, bp in (("v0_cv", 0.005), ("v0_acv", 0.12)):
        a, b = getattr(got.report, k), getattr(want.report, k)
        assert abs(a - b) / b * 1e4 <= bp, (k, a, b)
    np.testing.assert_allclose(got.report.v0, want.report.v0, rtol=3e-6)
    np.testing.assert_allclose(got.report.v0_plain, want.report.v0_plain, rtol=1e-5)
    np.testing.assert_array_equal(got.backward.epochs_ran, want.backward.epochs_ran)


def test_pension_hedge_with_adam_matches_jax(monkeypatch):
    """Band: V0 at 3e-3, phi0 and psi0 within 0.8% of V0 (16 one-ulp-perturbed
    runs: at most 1.42e-3 / 0.38% / 0.35%; unperturbed 1.41e-3 / 0.15% / 0.35%:
    Adam's step ``m / (sqrt(v) + eps)`` carries the two packages' f32 roundings
    of near-zero gradients further than a one-ulp change of the paths does)."""
    want, got = pension_pair(monkeypatch)
    v0 = want.report.v0
    np.testing.assert_allclose(got.report.v0, v0, rtol=3e-3)
    for k in ("phi0", "psi0"):
        assert abs(getattr(got.report, k) - getattr(want.report, k)) <= 8e-3 * v0, k
    np.testing.assert_allclose(got.report.discounted_payoff, want.report.discounted_payoff,
                               rtol=1e-5)
