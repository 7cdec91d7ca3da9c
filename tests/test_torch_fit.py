"""Port parity: minibatch Adam with the reference's schedule and early stopping
(``orp_tpu_torch/train/fit.py``) against the JAX package's ``fit``
(``orp_tpu/train/fit.py``), from the same params and data.

Each epoch's order comes from JAX's keys: the port's ``_epoch_order`` is
replaced by the permutations (and the block offset) that JAX draws from
``jax.random.split(key, n_epochs)``, since threefry cannot be reproduced by
a ``torch.Generator``.

Tolerances and why:
- in float64 the two run the same Adam steps on the same minibatches and
  differ only in reduction order: params, ``loss_history``, ``best_loss``,
  ``final_loss`` and the metrics at ``rtol=1e-9`` (measured at most 8e-14 on
  the params, 2e-11 after the readout solve), ``n_epochs_ran`` and the
  position of every ``inf`` equal;
- in float32 (the walk's dtype) the roundings differ in their last bit and
  Adam's division by ``sqrt(nu)`` carries them on: params at ``rtol=1e-4``
  after 20 epochs of 4 steps, as ``tests/test_torch_gn.py`` holds the warm
  f32 Gauss-Newton fit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train import losses as JL
from orp_tpu.train.fit import FitConfig as JFitConfig
from orp_tpu.train.fit import fit as jfit
from orp_tpu.train.fit import reference_lr_schedule as jreference_lr_schedule
from orp_tpu.train.fit import validate_shuffle as jvalidate_shuffle
from orp_tpu_torch import api as tapi
from orp_tpu_torch import train as ttrain
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import fit as tfit
from orp_tpu_torch.train import losses

N = 300


def jax_epoch_order(ekey, n: int, bs: int, shuffle):
    """The order JAX's ``fit_core`` draws from one epoch key, as ``_epoch_order`` returns it."""
    nb = max(n // bs, 1)
    nu = nb * bs
    if shuffle == "blocks":
        order = np.asarray(jax.random.permutation(ekey, nb)).astype(np.int64)
        off = (int(jax.random.randint(jax.random.fold_in(ekey, 1), (), 0, n - nu + 1))
               if nu < n else 0)
        return None, torch.from_numpy(order), off
    perm = np.asarray(jax.random.permutation(ekey, n))[:nu].astype(np.int64)
    return torch.from_numpy(perm), torch.arange(nb), 0


def inject_jax_orders(monkeypatch, keys_by_seed: dict) -> None:
    """Replace the port's ``_epoch_order``: a fit whose generator has initial seed
    ``s`` draws its epochs' orders from the JAX keys ``keys_by_seed[s]``, in turn."""
    streams = {s: iter(list(ks)) for s, ks in keys_by_seed.items()}
    monkeypatch.setattr(tfit, "_epoch_order",
                        lambda gen, n, bs, shuffle: jax_epoch_order(
                            next(streams[gen.initial_seed()]), n, bs, shuffle))


def data(dtype=np.float64, n: int = N, seed: int = 0):
    """A Heston-like date: features ``(S, v)``, prices ``(S, B)``, target a call payoff."""
    rng = np.random.default_rng(seed)
    s = np.exp(0.2 * rng.standard_normal(n))
    v = rng.uniform(0.01, 0.05, n)
    feats = np.stack([s, v], 1).astype(dtype)
    prices = np.stack([s, np.full(n, 1.01)], 1).astype(dtype)
    target = (np.maximum(s - 1.0, 0.0) + 0.01 * rng.standard_normal(n)).astype(dtype)
    return feats, prices, target


def jax_params(dtype=jnp.float64, seed: int = 1) -> dict:
    p = JHedgeMLP(n_features=2, dtype=dtype).init(jax.random.key(seed), bias_init=(0.1, 0.0))
    return {k: np.asarray(v) for k, v in p.items()}


def both_fits(monkeypatch, cfg: dict, loss: str = "mse", solve: bool = False,
              dtype=np.float64, n: int = N):
    """The same fit through JAX's ``fit`` and the port's ``fit_core``, on JAX's orders."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32,
                                                                          torch.float32)
    arrays = data(dtype, n)
    p0 = jax_params(jdt)
    jm, tm = JHedgeMLP(n_features=2, dtype=jdt), HedgeMLP(n_features=2, dtype=tdt)
    key = jax.random.key(7)
    jloss = JL.mse if loss == "mse" else JL.make_loss(loss, q=0.9)
    tloss = losses.mse if loss == "mse" else losses.make_loss(loss, q=0.9)
    want_p, want = jfit(p0, *(jnp.asarray(a) for a in arrays), key, value_fn=jm.value,
                        loss_fn=jloss, cfg=JFitConfig(**cfg), metric_fns=(JL.mae, JL.mape),
                        solve_fn=(lambda p, f, pr, t: jm.solve_readout(p, f, pr, t))
                        if solve else None)
    gen = torch.Generator().manual_seed(11)
    inject_jax_orders(monkeypatch, {11: jax.random.split(key, cfg["n_epochs"])})
    got_p, got = tfit.fit_core(tm, {k: torch.tensor(v) for k, v in p0.items()},
                               *(torch.tensor(a) for a in arrays), gen, loss_fn=tloss,
                               cfg=tfit.FitConfig(**cfg), metric_fns=(losses.mae, losses.mape),
                               solve_fn=tm.solve_readout if solve else None)
    return (want_p, want), (got_p, got)


def assert_fit_equal(want_p, want, got_p, got, rtol: float) -> None:
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(v), rtol=rtol, atol=rtol * 1e-2,
                                   err_msg=k)
    hj, ht = np.asarray(want["loss_history"]), got["loss_history"].numpy()
    np.testing.assert_array_equal(np.isfinite(ht), np.isfinite(hj))
    np.testing.assert_allclose(ht[np.isfinite(hj)], hj[np.isfinite(hj)], rtol=rtol)
    assert int(got["n_epochs_ran"]) == int(want["n_epochs_ran"])
    for k in ("best_loss", "final_loss", "mae", "mape"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("epoch", [0, 99, 100, 199, 200, 1000])
def test_reference_lr_schedule_matches_jax(epoch):
    want = float(jreference_lr_schedule()(epoch))
    assert tfit.reference_lr_schedule()(epoch) == pytest.approx(want, rel=1e-9)
    assert ttrain.reference_lr_schedule is tapi.reference_lr_schedule


def test_validate_shuffle_matches_jax():
    for s in (True, False, "full", "blocks"):
        assert tfit.validate_shuffle(s) == jvalidate_shuffle(s)
    assert tfit.FitConfig(shuffle="full").shuffle is True
    assert tapi.TrainConfig(shuffle="full").shuffle is True
    for bad in ("rows", "FULL"):
        with pytest.raises(ValueError, match="shuffle"):
            tfit.FitConfig(shuffle=bad)
        with pytest.raises(ValueError, match="shuffle"):
            tapi.TrainConfig(shuffle=bad)
    assert tfit.FitConfig() == tfit.FitConfig(n_epochs=100, batch_size=512, patience=7,
                                              min_delta=0.0, shuffle=True, lr=None)


@pytest.mark.parametrize("case", [
    dict(shuffle=False, lr=1e-2),
    dict(shuffle=True, lr=1e-2),
    dict(shuffle="blocks", lr=1e-2),
    dict(shuffle=True, lr=1e-2, batch_size=70),      # 4 batches of 70: 20 rows left over
    dict(shuffle="blocks", lr=1e-2, batch_size=70),  # the block window slides
    dict(shuffle=False, lr=1e-2, batch_size=512),    # one batch of all 300 rows
    dict(shuffle=True, lr=None, n_epochs=104, batch_size=100),  # the schedule's first step
    dict(shuffle=False, lr=5e-2, n_epochs=60, patience=2),      # stops early
    dict(shuffle=False, lr=1e-2, min_delta=1e-3, patience=3),   # min_delta
])
def test_fit_core_matches_jax_in_f64(monkeypatch, case):
    cfg = dict(dict(n_epochs=12, batch_size=64, patience=100), **case)
    (wp, w), (gp, g) = both_fits(monkeypatch, cfg)
    assert_fit_equal(wp, w, gp, g, rtol=1e-9)
    if cfg["patience"] < 100:  # the early-stopping cases do stop
        assert int(w["n_epochs_ran"]) < cfg["n_epochs"]


@pytest.mark.parametrize("loss, solve", [("mse", True), ("pinball", False),
                                         ("smoothed_pinball", False)])
def test_fit_core_losses_and_readout_solve_match_jax_in_f64(monkeypatch, loss, solve):
    cfg = dict(n_epochs=12, batch_size=64, patience=100, shuffle=True, lr=1e-2)
    (wp, w), (gp, g) = both_fits(monkeypatch, cfg, loss=loss, solve=solve)
    assert_fit_equal(wp, w, gp, g, rtol=1e-9)
    if solve:  # best_loss is the final (post-solve) loss, never worse than the epochs'
        assert float(g["best_loss"]) == float(g["final_loss"])
        assert float(g["best_loss"]) <= float(g["loss_history"].min()) * (1 + 1e-12)


def test_fit_core_matches_jax_in_f32(monkeypatch):
    cfg = dict(n_epochs=20, batch_size=64, patience=100, shuffle=True, lr=1e-2)
    (wp, w), (gp, g) = both_fits(monkeypatch, cfg, dtype=np.float32, n=256)
    for k, v in wp.items():
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(g["loss_history"].numpy(), np.asarray(w["loss_history"]),
                               rtol=1e-4)
    assert g["loss_history"].dtype == torch.float32


def test_fit_early_stopping_and_best_restore():
    """``tests/test_train.py``'s early-stopping pin on the port: the tail past the
    stop is ``inf``, ``best_loss`` is the least epoch loss, and the returned
    params are that epoch's (their loss on all rows, one batch, equals it)."""
    m = HedgeMLP(n_features=1)
    n = 256
    s = torch.linspace(0.5, 2.0, n)
    prices = torch.stack([s, torch.ones(n)], dim=-1)
    target = 0.5 * s + 0.5
    p, aux = tfit.fit_core(m, m.init(torch.Generator().manual_seed(1)), s[:, None], prices,
                           target, torch.Generator().manual_seed(0), loss_fn=losses.mse,
                           cfg=tfit.FitConfig(n_epochs=400, batch_size=256, patience=3,
                                              lr=1e-2))
    hist = aux["loss_history"].numpy()
    ran = int(aux["n_epochs_ran"])
    assert ran < 400 and not np.isfinite(hist[ran:]).any() and np.isfinite(hist[:ran]).all()
    np.testing.assert_allclose(float(aux["best_loss"]), hist[:ran].min(), rtol=1e-6)
    best = int(np.argmin(hist[:ran]))
    assert best == ran - 1 - 3  # the stop: patience 3 epochs without a gain
    # one batch of all rows: an epoch's loss is that of the params entering it, so
    # the restored params (those that left the best epoch) score the next epoch's
    np.testing.assert_allclose(float(aux["final_loss"]), hist[best + 1], rtol=1e-6)


def test_fit_learns_linear_hedge():
    """``tests/test_train.py``'s convergence pin: a target inside the model class."""
    m = HedgeMLP(n_features=1)
    n = 2048
    gen = torch.Generator().manual_seed(2)
    s = torch.exp(torch.randn(n, generator=gen) * 0.2)
    prices = torch.stack([s, torch.full((n,), 1.01)], dim=-1)
    target = 0.7 * s + 0.3 * 1.01
    _, aux = tfit.fit_core(m, m.init(torch.Generator().manual_seed(1)), s[:, None], prices,
                           target, torch.Generator().manual_seed(3), loss_fn=losses.mse,
                           cfg=tfit.FitConfig(n_epochs=300, batch_size=512, patience=50),
                           metric_fns=(losses.mae,))
    assert float(aux["final_loss"]) < 1e-4 and float(aux["mae"]) < 1e-2


def test_an_epoch_entered_stopped_changes_nothing():
    """The host's once-an-epoch read of ``stopped`` only ends the loop: an epoch
    run with ``stopped`` set leaves every tensor of the fit as it was and records
    ``inf``, so a fit that ran on past its stop returns the same result."""
    m = HedgeMLP(n_features=2, dtype=torch.float64)
    feats, prices, target = (torch.tensor(a) for a in data())
    cfg = tfit.FitConfig(n_epochs=5, batch_size=64, patience=1, shuffle=True, lr=1e-2)
    prog = tfit._EpochProgram(m, losses.mse, cfg, N, 64, feats, prices, target)
    theta = m.flatten({k: torch.tensor(v) for k, v in jax_params().items()})
    prog.load(theta, feats, prices, target)
    gen = torch.Generator().manual_seed(3)
    prog.set_order(*tfit._epoch_order(gen, N, 64, True))
    prog.run_epoch()
    assert not bool(prog.stopped) and int(prog.count) == 4
    prog.stopped.fill_(True)
    names = ("theta", "mu", "nu", "count", "best_theta", "best_loss", "wait", "stopped")
    before = {k: getattr(prog, k).clone() for k in names}
    prog.set_order(*tfit._epoch_order(gen, N, 64, True))
    prog.run_epoch()
    for k in names:
        assert torch.equal(getattr(prog, k), before[k]), k
    assert float(prog.epoch_loss) == float("inf")


@pytest.mark.parametrize("shuffle", [True, "blocks"])
def test_epoch_order_is_the_generators(shuffle):
    """Orders come from the generator alone (one seed, one stream), cover the rows
    the batches use, and a ``"blocks"`` window stays inside the rows."""
    draw = lambda seed: [tfit._epoch_order(g, 300, 70, shuffle)  # noqa: E731
                         for g in [torch.Generator().manual_seed(seed)] for _ in range(5)]
    a, b, c = draw(4), draw(4), draw(5)
    for (pa, oa, fa), (pb, ob, fb) in zip(a, b):
        assert torch.equal(oa, ob) and fa == fb
        assert (pa is None and pb is None) or torch.equal(pa, pb)
    assert any(not torch.equal(x[1], y[1]) or x[2] != y[2] or (
        x[0] is not None and not torch.equal(x[0], y[0])) for x, y in zip(a, c))
    for perm, order, off in a:
        assert sorted(order.tolist()) == [0, 1, 2, 3]
        if shuffle is True:
            assert perm.shape == (280,) and len(set(perm.tolist())) == 280 and off == 0
            assert perm.max() < 300
        else:
            assert perm is None and 0 <= off <= 20


def test_fit_core_runs_in_full_f32_without_tf32(monkeypatch):
    """``fit_core`` pins full-f32 products before its first minibatch (the
    counterpart of ``@highest_matmul_precision``)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    m = HedgeMLP(n_features=2)
    feats, prices, target = (torch.tensor(a) for a in data(np.float32))
    tfit.fit_core(m, m.init(torch.Generator().manual_seed(0)), feats, prices, target,
                  torch.Generator().manual_seed(0), loss_fn=losses.mse,
                  cfg=tfit.FitConfig(n_epochs=1, batch_size=64))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_adam_walk_tool_runs_on_the_cpu(capsys):
    """``tools/torch_adam_walk.py`` on the CPU (the op-by-op epoch alone, tiny):
    one JSON line with the step count of the fit it timed."""
    import json
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
    import torch_adam_walk

    assert torch_adam_walk.main(["--device", "cpu", "--paths", "2048", "--epochs", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mode"] == "eager" and rec["batch_size"] == 32 and rec["steps"] == 2 * 64
    assert rec["ms_per_step"] > 0 and rec["kernels_per_step"] == 0
