"""Port parity: the fused backward walk (``BackwardConfig(fused=True)``,
``orp_tpu_torch/train/backward.py``) against the port's host loop and against
the JAX package's fused walk (``_fused_walk_core``), from the same
JAX-initialised params (``tests/test_torch_adam_walk.py``'s inputs: pension
paths, 256 x 8 steps stored every 2, 4 dates, 3 features).

Tolerances and why:
- fused against the host loop, in the port, in float32: bitwise (ledgers,
  per-date params, metrics, epochs or accepted iterations). Both run the same
  date body with the same kernels; the fused walk's GN programs read
  contiguous copies of the date's inputs, which changes no bit (the products'
  operands are the same numbers, the first layer's is at most 3 wide), and
  its Adam fits run the epochs past the early stop, which change nothing;
- the port's fused walk against JAX's fused walk in float64: ``rtol=1e-7``
  on ledgers and per-date params and equal ``epochs_ran``, as the host-loop
  walks (``tests/test_torch_walk.py``, ``tests/test_torch_adam_walk.py``),
  Adam on JAX's epoch orders (injected).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train.backward import BackwardConfig as JBackwardConfig
from orp_tpu.train.backward import backward_induction as jbackward_induction
from orp_tpu_torch import api as tapi
from orp_tpu_torch.api import pipelines as tpipe
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import BackwardConfig, backward_induction, gn
from orp_tpu_torch.train import fit as tfit
from orp_tpu_torch.train.losses import mse
from test_torch_adam_walk import ADAM, SIM, jax_walk_init, walk_keys
from test_torch_fit import inject_jax_orders

GN = dict(optimizer="gauss_newton", gn_iters_first=8, gn_iters_warm=4)
GN_MODES = {
    "mse_only": dict(GN, dual_mode="mse_only"),
    "separate": dict(GN, dual_mode="separate"),
    "shared": dict(GN, dual_mode="shared", holdings_combine="py"),
}
# at lr 1e-1 the quantile fits stop early, so the fused walk runs masked epochs
ADAM_MODES = {f"separate-{shuffle}": dict(ADAM, dual_mode="separate", shuffle=shuffle, lr=1e-1)
              for shuffle in (False, True, "blocks")}


@pytest.fixture(scope="module")
def inputs():
    inp = tpipe.pension_inputs(tapi.HedgeRunConfig(sim=tapi.SimConfig(**SIM)), "t",
                               torch.device("cpu"))
    arrays = tuple(t.double().numpy() for t in (inp.features, inp.y, inp.b, inp.terminal))
    return arrays, inp.bias_init


def _port(arrays, cfg: dict, dtype, init, **kw):
    model = HedgeMLP(n_features=3, dtype=dtype)
    return backward_induction(model, *(torch.tensor(a, dtype=dtype) for a in arrays),
                              BackwardConfig(**cfg, **kw), initial_params=init)


def _assert_bitwise(got, want):
    for k in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for which in ("params1_by_date", "params2_by_date"):
        w = getattr(want, which)
        assert (w is None) == (getattr(got, which) is None)
        for k, v in (w or {}).items():
            assert torch.equal(getattr(got, which)[k], v), (which, k)
    for k in ("train_loss", "train_mae", "train_mape", "epochs_ran", "quantile_loss",
              "quantile_epochs_ran"):
        w = getattr(want, k)
        assert (w is None) == (getattr(got, k) is None), k
        if w is not None:
            np.testing.assert_array_equal(getattr(got, k), w, err_msg=k)
    for k, v in want.params1.items():
        assert torch.equal(got.params1[k], v), k


@pytest.mark.parametrize("mode", list(GN_MODES) + list(ADAM_MODES))
def test_fused_walk_is_the_host_loop(inputs, mode):
    arrays, bias = inputs
    cfg = {**GN_MODES, **ADAM_MODES}[mode]
    init = jax_walk_init(jnp.float32, bias)
    host = _port(arrays, cfg, torch.float32, init)
    fused = _port(arrays, cfg, torch.float32, init, fused=True)
    _assert_bitwise(fused, host)
    if mode in ADAM_MODES:  # the early stop fired: the fused fits ran masked epochs
        assert host.quantile_epochs_ran.min() < ADAM["epochs_warm"]


@pytest.mark.parametrize("cfg", [dict(GN_MODES["separate"], gn_block_rows=64, final_solve=True),
                                 dict(GN_MODES["mse_only"], gn_quantile=False),
                                 dict(GN_MODES["separate"], gn_quantile=False, **ADAM)])
def test_fused_walk_is_the_host_loop_blocked_solved_and_hybrid(inputs, cfg):
    """Blocked Gram accumulation with the readout solve, and the GN + Adam
    quantile leg, fused: bitwise the host loop."""
    arrays, bias = inputs
    init = jax_walk_init(jnp.float32, bias)
    _assert_bitwise(_port(arrays, cfg, torch.float32, init, fused=True),
                    _port(arrays, cfg, torch.float32, init))


@pytest.mark.parametrize("cfg", [GN_MODES["separate"], ADAM_MODES["separate-False"]])
def test_fused_single_date_walk(inputs, cfg):
    """``n_dates == 1``: the first date alone, fused and host loop bitwise, with
    the JAX package's ledger shapes."""
    (feats, y, b, term), bias = inputs
    arrays = (feats[:, -2:], y[:, -2:], b[-2:], term)
    init = jax_walk_init(jnp.float32, bias)
    fused = _port(arrays, cfg, torch.float32, init, fused=True)
    _assert_bitwise(fused, _port(arrays, cfg, torch.float32, init))
    assert fused.values.shape == (256, 2) and fused.phi.shape == (256, 1)
    assert fused.params1_by_date["w0"].shape == (1, 3, 8)


def _assert_matches_jax(got, want, dual: bool):
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
    assert (got.quantile_loss is not None) == dual


@pytest.mark.parametrize("mode", list(GN_MODES) + ["separate-blocks", "separate-True"])
def test_fused_walk_matches_jax_fused_in_f64(inputs, monkeypatch, mode):
    arrays, bias = inputs
    cfg = {**GN_MODES, **ADAM_MODES}[mode]
    init = jax_walk_init(jnp.float64, bias)
    want = jbackward_induction(JHedgeMLP(n_features=3, dtype=jnp.float64),
                               *(jnp.asarray(a) for a in arrays),
                               JBackwardConfig(**cfg, fused=True), initial_params=init)
    if mode in ADAM_MODES:
        inject_jax_orders(monkeypatch, walk_keys(1234, 4, ADAM["epochs_first"],
                                                 ADAM["epochs_warm"]))
    got = _port(arrays, cfg, torch.float64, init, fused=True)
    _assert_matches_jax(got, want, cfg["dual_mode"] != "mse_only")


def test_gn_program_refits_date_after_date(inputs):
    """One ``gn_program`` refilled by ``refit`` per date gives each date's
    ``fit_gn`` result bitwise, with its own iteration count (fewer than the
    program's history holds) and no state carried between fits."""
    (feats, y, b, term), _ = inputs
    model = HedgeMLP(n_features=3)
    f = torch.tensor(feats, dtype=torch.float32)
    p = torch.stack([torch.tensor(y, dtype=torch.float32),
                     torch.tensor(b, dtype=torch.float32).expand(y.shape)], -1)
    target = torch.tensor(term, dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(3), bias_init=(0.5, 0.5))
    prog = gn.gn_program(model, f[:, 3], p[:, 4], target, gn.GNConfig(n_iters=9))
    for t, n_iters in ((3, 9), (2, 4), (1, 4)):
        want_p, want = gn.fit_gn(model, params, f[:, t], p[:, t + 1], target,
                                 cfg=gn.GNConfig(n_iters=n_iters))
        got_p, got = gn.refit(prog, params, f[:, t], p[:, t + 1], target, n_iters=n_iters)
        for k, v in want_p.items():
            assert torch.equal(got_p[k], v), (t, k)
        for k, v in want.items():
            assert torch.equal(got[k], v), (t, k)
        assert got["loss_history"].shape == (n_iters,)
    with pytest.raises(ValueError, match="exceeds the program's cfg.n_iters=9"):
        gn.refit(prog, params, f[:, 0], p[:, 1], target, n_iters=10)


def test_lm_iterations_past_the_history_keep_its_last_entry(inputs):
    """Iterations past ``cfg.n_iters`` (a timing loop with no restart) write the
    history's last entry and go on: the state is a longer problem's, bitwise,
    and the counter stops at the last entry."""
    (feats, y, b, term), _ = inputs
    model = HedgeMLP(n_features=3)
    f = torch.tensor(feats[:, 2], dtype=torch.float32)
    p = torch.stack([torch.tensor(y[:, 3], dtype=torch.float32),
                     torch.full((y.shape[0],), float(b[3]), dtype=torch.float32)], -1)
    target = torch.tensor(term, dtype=torch.float32)
    theta = model.flatten(model.init(torch.Generator().manual_seed(3), bias_init=(0.5, 0.5)))
    short = gn._GNProblem(model, f, p, target, gn.GNConfig(n_iters=2))
    long = gn._GNProblem(model, f, p, target, gn.GNConfig(n_iters=6))
    for prob in (short, long):
        prob.start(theta)
        for _ in range(6):
            prob.iterate()
    assert torch.equal(short.theta, long.theta) and torch.equal(short.takes, long.takes)
    assert torch.equal(short.hist, torch.stack([long.hist[0], long.hist[5]]))
    assert int(short.it) == 1 and int(long.it) == 5


@pytest.mark.parametrize("fused", [False, True])
def test_fused_loop_scope_wraps_only_the_fused_date_loop(inputs, monkeypatch, fused):
    """``backward.fused_loop_scope`` is entered once, around the fused walk's
    date loop (every date body inside it), and never by the host loop."""
    import contextlib

    from orp_tpu_torch.train import backward

    arrays, bias = inputs
    events = []
    body = backward._date_body

    @contextlib.contextmanager
    def scope(device):
        events.append(("enter", device.type))
        yield
        events.append("exit")

    monkeypatch.setattr(backward, "fused_loop_scope", scope)
    monkeypatch.setattr(backward, "_date_body",
                        lambda *a, **kw: events.append("date") or body(*a, **kw))
    _port(arrays, GN_MODES["mse_only"], torch.float32, jax_walk_init(jnp.float32, bias),
          fused=fused)
    dates = ["date"] * 4
    assert events == ([("enter", "cpu"), *dates, "exit"] if fused else dates)


def test_sync_free_fit_is_the_host_fit(monkeypatch):
    """``fit_core(sync_free=True)`` runs every epoch (those past the early stop
    masked) and draws every epoch's order, with the host fit's result."""
    rng = np.random.default_rng(0)
    n = 300
    s = np.exp(0.2 * rng.standard_normal(n))
    feats = torch.tensor(np.stack([s, s * s], 1), dtype=torch.float32)
    prices = torch.tensor(np.stack([s, np.full(n, 1.01)], 1), dtype=torch.float32)
    target = torch.tensor(np.maximum(s - 1.0, 0.0), dtype=torch.float32)
    model = HedgeMLP(n_features=2)
    params = model.init(torch.Generator().manual_seed(1), bias_init=(0.1, 0.0))
    cfg = tfit.FitConfig(n_epochs=40, batch_size=64, patience=2, lr=5e-2, shuffle=True)
    draws = []
    order = tfit._epoch_order
    monkeypatch.setattr(tfit, "_epoch_order", lambda *a: draws.append(1) or order(*a))
    outs = []
    for sync_free in (False, True):
        draws.clear()
        outs.append(tfit.fit_core(model, params, feats, prices, target,
                                  torch.Generator().manual_seed(5), loss_fn=mse,
                                  cfg=cfg, sync_free=sync_free) + (len(draws),))
    (hp, ha, h_draws), (fp, fa, f_draws) = outs
    assert int(ha["n_epochs_ran"]) < 40 and h_draws == int(ha["n_epochs_ran"]) < f_draws == 40
    for k, v in hp.items():
        assert torch.equal(fp[k], v), k
    for k, v in ha.items():
        assert torch.equal(fa[k], v), k


def test_fused_pipeline_runs_and_equals_host():
    """``european_hedge(fused=True)`` through the entry point: the host loop's
    report."""
    sim = tapi.SimConfig(n_paths=256, T=1.0, dt=0.25, rebalance_every=1)
    train = tapi.TrainConfig(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=6,
                             gn_iters_warm=3)
    host = tapi.european_hedge(tapi.EuropeanConfig(), sim, train, device="cpu")
    fused = tapi.european_hedge(tapi.EuropeanConfig(), sim,
                                dataclasses.replace(train, fused=True), device="cpu")
    for k in ("v0", "v0_cv", "v0_acv", "phi0", "psi0"):
        assert getattr(fused.report, k) == getattr(host.report, k), k


def test_fused_walk_tool_on_cpu(capsys):
    """``tools/torch_fused_walk.py --device cpu`` at a tiny size: host loop,
    fused, fused, host loop, each bitwise the first run, no census on the CPU."""
    import importlib.util
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "torch_fused_walk.py"
    spec = importlib.util.spec_from_file_location("torch_fused_walk", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--device", "cpu", "--paths", "256", "--turns", "1", "--iters-first", "4",
                      "--iters-warm", "2", "--block", "64"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    runs = [json.loads(x) for x in lines[:-1]]
    assert [r["mode"] for r in runs] == ["host loop", "fused", "fused", "host loop"]
    assert all(r["bitwise_first_run"] and r["lm_iterations"] == 4 + 51 * 2 for r in runs)
    assert lines[-1].endswith("not measured (CPU run)")
    assert tool.idle_share([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == pytest.approx(1 / 3)
