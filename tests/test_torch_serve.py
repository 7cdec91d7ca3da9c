"""Port parity: the served forward (``orp_tpu_torch/models``, ``train/backward``,
``serve``) against the JAX package.

Tolerance ``rtol=1e-5, atol=1e-6`` throughout: the same f32 operations, but
PyTorch's CPU matmul and the JAX/XLA dot (and, on the card, the kernel's
FMAs) sum in different orders, so results agree to a few ulps, not bitwise.
(The JAX package pins its own megakernel bitwise to ``loop_of_buckets``,
which holds inside one XLA backend only.)"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.serve import HedgeEngine as JHedgeEngine
from orp_tpu.serve.bundle import PolicyBundle as JPolicyBundle
from orp_tpu.serve.megakernel import mixed_head_forward as jmixed_head_forward
from orp_tpu.train.backward import BackwardResult as JBackwardResult
from orp_tpu.train.backward import _date_outputs_core as j_date_outputs_core
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.serve import (HedgeEngine, load_bundle, loop_of_buckets,
                                 mixed_head_forward, next_bucket, policy_from_numpy,
                                 save_bundle)
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.serve import megakernel
from orp_tpu_torch.serve.megakernel import check_head_shape, mixed_head_plain
from orp_tpu_torch.train.backward import _date_outputs_core

TOL = dict(rtol=1e-5, atol=1e-6)
METRICS = ("train_loss", "train_mae", "train_mape", "epochs_ran")


def _params(sizes, n_dates, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = (0.5 * rng.standard_normal((n_dates, a, b))).astype(np.float32)
        p[f"b{i}"] = (0.1 * rng.standard_normal((n_dates, b))).astype(np.float32)
    return p


def _pair(n_features=1, hidden=(8, 8), constrain=False, n_hedge_assets=1, n_dates=4,
          dual_mode="mse_only", holdings_combine="single", seed=0, params1=None,
          params2=None, sim_seed=None):
    """The same policy as a JAX PolicyBundle and as the port's (numpy carried)."""
    jm = JHedgeMLP(n_features=n_features, hidden=hidden, constrain_self_financing=constrain,
                   n_hedge_assets=n_hedge_assets, dtype=jnp.float32)
    tm = HedgeMLP(n_features=n_features, hidden=hidden, constrain_self_financing=constrain,
                  n_hedge_assets=n_hedge_assets)
    sizes = tm.layer_sizes
    if params1 is None:
        params1 = _params(sizes, n_dates, seed)
        if dual_mode != "mse_only":
            params2 = _params(sizes, n_dates, seed + 1)
    n_dates = params1["w0"].shape[0]
    times = np.linspace(0.0, 1.0, n_dates + 1)
    metrics = {k: np.zeros(n_dates) for k in METRICS}
    state = {"params1_by_date": {k: jnp.asarray(v) for k, v in params1.items()}, **metrics}
    if params2 is not None:
        state["params2_by_date"] = {k: jnp.asarray(v) for k, v in params2.items()}
    jpol = JPolicyBundle(model=jm, backward=JBackwardResult.from_policy_state(state),
                         times=times, adjustment_factor=100.0, dual_mode=dual_mode,
                         holdings_combine=holdings_combine, cost_of_capital=0.1,
                         sim_seed=sim_seed, fingerprint="")
    meta = {"model": model_meta(tm), "times": times.tolist(), "adjustment_factor": 100.0,
            "dual_mode": dual_mode, "holdings_combine": holdings_combine,
            "cost_of_capital": 0.1, "sim_seed": sim_seed}
    return jpol, policy_from_numpy(meta, params1, params2)


def _rows(n, n_features, n_instruments, seed=5):
    rng = np.random.default_rng(seed)
    states = (1.0 + 0.05 * rng.standard_normal((n, n_features))).astype(np.float32)
    prices = np.concatenate([states[:, :1].repeat(n_instruments - 1, axis=1),
                             np.full((n, 1), 0.97, np.float32)], axis=1)
    return states, prices


@pytest.fixture(scope="module")
def trained():
    """A policy trained by the JAX package (``test_precision_tiers.py``'s config)."""
    res = european_hedge(EuropeanConfig(),
                         SimConfig(n_paths=512, T=1.0, dt=1 / 8, rebalance_every=2),
                         TrainConfig(dual_mode="mse_only", epochs_first=20, epochs_warm=10))
    p1 = {k: np.asarray(v, np.float32) for k, v in res.backward.params1_by_date.items()}
    jpol, tpol = _pair(constrain=True, params1=p1, sim_seed=res.sim_seed)
    return res, tpol


HEADS = [
    dict(n_features=1, hidden=(8, 8)),
    dict(n_features=1, hidden=(8, 8), constrain=True),
    dict(n_features=3, hidden=(8, 8), n_hedge_assets=2),
    dict(n_features=2, hidden=(16, 4, 8)),
]


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("dual_mode, combine", [("mse_only", "single"),
                                                ("separate", "single"),
                                                ("separate", "py"), ("shared", "single")])
def test_forward_and_date_outputs_match_jax(head, dual_mode, combine):
    jpol, tpol = _pair(dual_mode=dual_mode, holdings_combine=combine, seed=3, **head)
    m, jm = tpol.model, jpol.model
    p1 = {k: v[2] for k, v in tpol.backward.params1_by_date.items()}
    p2 = p1 if tpol.backward.params2_by_date is None else {
        k: v[2] for k, v in tpol.backward.params2_by_date.items()}
    jp1 = {k: jnp.asarray(v.numpy()) for k, v in p1.items()}
    jp2 = {k: jnp.asarray(v.numpy()) for k, v in p2.items()}
    k = 2 if m.constrain_self_financing else m.n_outputs
    feats, prices = _rows(257, m.n_features, k)
    _, prices1 = _rows(257, m.n_features, k, seed=9)
    target = np.random.default_rng(1).standard_normal(257).astype(np.float32)
    np.testing.assert_allclose(m.holdings(p1, torch.from_numpy(feats)).numpy(),
                               np.asarray(jm.holdings(jp1, jnp.asarray(feats))), **TOL)
    np.testing.assert_allclose(
        m.value(p1, torch.from_numpy(feats), torch.from_numpy(prices)).numpy(),
        np.asarray(jm.value(jp1, jnp.asarray(feats), jnp.asarray(prices))), **TOL)
    g_pre = m.value(p1, torch.from_numpy(feats), torch.from_numpy(prices))
    got = _date_outputs_core(m, p1, p2, torch.from_numpy(feats), torch.from_numpy(prices),
                             torch.from_numpy(prices1), torch.from_numpy(target), 0.1, g_pre,
                             dual_mode=dual_mode, holdings_combine=combine)
    want = j_date_outputs_core(jm, jp1, jp2, jnp.asarray(feats), jnp.asarray(prices),
                               jnp.asarray(prices1), jnp.asarray(target), 0.1,
                               jnp.asarray(g_pre.numpy()), dual_mode=dual_mode,
                               holdings_combine=combine)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("head", HEADS)
def test_mixed_head_plain_matches_pallas_kernel(head):
    jpol, tpol = _pair(n_dates=6, seed=11, **head)
    m = tpol.model
    n = 300
    rng = np.random.default_rng(2)
    dates = rng.integers(0, 6, n).astype(np.int32)
    feats, _ = _rows(n, m.n_features, 2)
    got = mixed_head_plain(m, tpol.backward.params1_by_date, torch.from_numpy(dates),
                           torch.from_numpy(feats))
    want = jmixed_head_forward(jpol.model, jpol.backward.params1_by_date,
                               jnp.asarray(dates)[:, None], jnp.asarray(feats), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    wrapped = mixed_head_forward(m, tpol.backward.params1_by_date, torch.from_numpy(dates),
                                 torch.from_numpy(feats))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    assert mixed_head_forward.launches == 0


def test_engine_matches_jax_engine_on_trained_policy(trained):
    res, tpol = trained
    jeng = JHedgeEngine(res, use_aot=False)
    eng = HedgeEngine(tpol, device="cpu")
    states, prices = _rows(37, 1, 2)
    for d in range(4):
        got = eng.evaluate(d, states, prices)
        want = jeng.evaluate(d, states, prices)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    dates = np.random.default_rng(4).integers(-4, 4, 37)
    got = eng.evaluate_mixed_async(dates, states, prices).result()
    want = jeng.evaluate_mixed_async(dates, states, prices).result()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    # without prices: holdings only
    phi, psi, v = eng.evaluate_mixed_async(dates, states).result()
    assert v is None and phi.shape == psi.shape == (37,)


@pytest.mark.parametrize("dual_mode, combine", [("separate", "single"), ("separate", "py"),
                                                ("shared", "single")])
def test_engine_dual_modes_match_jax_engine(dual_mode, combine):
    jpol, tpol = _pair(n_dates=5, dual_mode=dual_mode, holdings_combine=combine, seed=21)
    jeng, eng = JHedgeEngine(jpol, use_aot=False), HedgeEngine(tpol, device="cpu")
    states, prices = _rows(50, 1, 2, seed=8)
    dates = np.random.default_rng(6).integers(0, 5, 50)
    for got, want in ((eng.evaluate(3, states, prices), jeng.evaluate(3, states, prices)),
                      (eng.evaluate_mixed_async(dates, states, prices).result(),
                       jeng.evaluate_mixed_async(dates, states, prices).result())):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_mixed_equals_loop_of_buckets(trained):
    """The mixed-date path against the port's loop of per-date buckets: on the
    CPU both are plain PyTorch, equal to f32 rounding of the per-bucket matmuls."""
    _, tpol = trained
    eng = HedgeEngine(tpol, device="cpu")
    states, prices = _rows(200, 1, 2, seed=12)
    dates = np.random.default_rng(13).integers(0, 4, 200)
    mixed = eng.evaluate_mixed_async(dates, states, prices).result()
    loop = loop_of_buckets(eng, dates, states, prices)
    for a, b in zip(mixed, loop):
        np.testing.assert_allclose(a, b, **TOL)


def test_engine_buckets_and_validation(trained):
    _, tpol = trained
    eng = HedgeEngine(tpol, device="cpu", max_bucket=64)
    assert [next_bucket(n) for n in (1, 7, 8, 9, 1000)] == [8, 8, 8, 16, 1024]
    with pytest.raises(ValueError, match="never dispatches"):
        next_bucket(0)
    s1, p1 = _rows(7, 1, 2)
    eng.evaluate(0, s1, p1)
    eng.evaluate(-1, s1[:3], p1[:3])
    assert eng.cache_info()["buckets"] == [8] and (eng.hits, eng.misses) == (1, 1)
    with pytest.raises(IndexError, match="out of range"):
        eng.evaluate(4, s1)
    with pytest.raises(IndexError, match="out of range"):
        eng.evaluate_mixed_async(np.array([0, 1, 2, 3, 4, 0, 0]), s1)
    with pytest.raises(ValueError, match="features"):
        eng.evaluate(0, np.ones((3, 2), np.float32))
    with pytest.raises(ValueError, match="one rebalance-date index per row"):
        eng.evaluate_mixed_async(np.zeros(3), s1)
    with pytest.raises(ValueError, match="prices shape"):
        eng.evaluate(0, s1, p1[:, :1])
    with pytest.raises(ValueError, match="max_bucket"):
        eng.evaluate(0, np.ones((65, 1), np.float32))
    for out in (eng.evaluate(0, np.zeros((0, 1), np.float32)),
                eng.evaluate_mixed_async([], np.zeros((0, 1), np.float32)).result()):
        assert out[0].shape == (0,) and out[2] is None
    assert (eng.hits, eng.misses) == (1, 1)  # empty requests launch nothing


def test_head_shape_caps():
    check_head_shape(HedgeMLP(n_features=3, hidden=(8, 8), n_hedge_assets=2), 52)
    with pytest.raises(ValueError, match="layers of width"):
        check_head_shape(HedgeMLP(n_features=1, hidden=(32,)), 4)
    with pytest.raises(ValueError, match="layers of width"):
        check_head_shape(HedgeMLP(n_features=1, hidden=(4, 4, 4, 4)), 4)
    with pytest.raises(ValueError, match="shared memory"):
        check_head_shape(HedgeMLP(n_features=1, hidden=(16, 16, 16)), 200)


def _staged_index(plan, i):
    """Where the kernel's staging loop puts packed element ``i`` (date-major)."""
    d, e = divmod(i, plan["per_date"])
    layer = max(m for m in range(plan["n_layers"]) if e >= plan["src_off"][m])
    e -= plan["src_off"][layer]
    fin, fout = plan["sizes"][layer], plan["sizes"][layer + 1]
    if e < fin * fout:
        k, j = divmod(e, fout)
        return d * plan["stride"] + plan["w_off"][layer] + k * plan["ld"][layer] + j
    return d * plan["stride"] + plan["b_off"][layer] + e - fin * fout


# (layer sizes, dates): the served heads, a deep one, one layer of one unit,
# many dates (buckets of two dates and more), and params that fill shared memory
PLAN_HEADS = [((1, 8, 8, 2), 52), ((3, 8, 8, 2), 40), ((2, 16, 4, 8, 3), 52), ((1, 1), 1),
              ((1, 8, 8, 2), 300), ((1, 8, 8, 2), 548), ((16, 16, 16, 16, 16), 10)]


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes, n_dates", PLAN_HEADS)
def test_head_plan_layout(sizes, n_dates, elem):
    """The kernel's plan: every packed param lands in its own place, where the
    forward reads it (row k of layer l at ``w_off + k * ld``, the bias at
    ``b_off``); staged rows hold whole 16-byte vectors and a date spans an odd
    number of them; the tile and the buckets fit the kernel's shared memory."""
    plan = megakernel.head_plan(sizes, n_dates, elem)
    vec = 16 // elem
    assert plan["smem"] <= megakernel.MAX_SMEM_BYTES
    assert plan["tile"] % 32 == 0 and 32 <= plan["tile"] <= megakernel.TILE_ROWS
    assert plan["n_bins"] == ((n_dates - 1) >> plan["shift"]) + 2 <= 256
    assert plan["shift"] == 0 or ((n_dates - 1) >> (plan["shift"] - 1)) + 2 > 256
    assert plan["o_cnt"] == (n_dates * plan["stride"] * elem if plan["staged"] else 0)
    assert all(plan[k] % 16 == 0 for k in ("o_cnt", "o_perm", "o_dates", "o_feats", "o_out"))
    n_layers = len(sizes) - 1
    if plan["staged"]:
        assert plan["stride"] % vec == 0 and (plan["stride"] // vec) % 2 == 1
        for layer in range(n_layers):
            assert plan["w_off"][layer] % vec == plan["ld"][layer] % vec == 0
            assert plan["b_off"][layer] % vec == 0 and plan["ld"][layer] >= sizes[layer + 1]
        places = [_staged_index(plan, i) for i in range(n_dates * plan["per_date"])]
        assert len(set(places)) == len(places) and max(places) < n_dates * plan["stride"]
    else:
        assert plan["stride"] == plan["per_date"]
        places = list(range(n_dates * plan["per_date"]))
    assert plan["per_date"] == sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    where = dict(zip(places, range(len(places))))
    for d in range(n_dates):
        base = d * plan["stride"]
        for layer in range(n_layers):
            fin, fout = sizes[layer], sizes[layer + 1]
            src = d * plan["per_date"] + plan["src_off"][layer]
            for k in range(fin):
                for j in range(fout):
                    at = base + plan["w_off"][layer] + k * plan["ld"][layer] + j
                    assert where[at] == src + k * fout + j
            for j in range(fout):
                assert where[base + plan["b_off"][layer] + j] == src + fin * fout + j


def test_head_plan_tile_shrinks_then_params_stay_in_device_memory():
    """As dates are added, the tile shrinks beside the staged params; past the
    point where a 32-row tile no longer fits, the params are read from device
    memory and the tile is whole again, up to the most dates the caps take."""
    sizes, elem = (1, 8, 8, 2), 4
    n_max = megakernel.MAX_SMEM_BYTES // (106 * elem)
    check_head_shape(HedgeMLP(n_features=1), n_max)
    plans = [megakernel.head_plan(sizes, n, elem) for n in range(52, n_max + 1)]
    staged = [p["staged"] for p in plans]
    assert staged[0] and not staged[-1] and staged == sorted(staged, reverse=True)
    last = max(i for i, s in enumerate(staged) if s)
    assert plans[0]["tile"] == megakernel.TILE_ROWS > plans[last]["tile"] >= 32
    assert all(a["tile"] >= b["tile"] for a, b in zip(plans[:last], plans[1:last + 1]))
    assert plans[last + 1]["tile"] == plans[-1]["tile"] == megakernel.TILE_ROWS


def test_bundle_roundtrip_and_shape_guard(tmp_path, trained):
    _, tpol = trained
    p1 = {k: v.numpy() for k, v in tpol.backward.params1_by_date.items()}
    meta = {"model": model_meta(tpol.model), "times": list(tpol.times),
            "adjustment_factor": 100.0, "dual_mode": "mse_only",
            "holdings_combine": "single", "cost_of_capital": 0.1, "sim_seed": 1235}
    save_bundle(tmp_path / "b", meta, p1, metrics={"train_loss": np.arange(4.0)})
    back = load_bundle(tmp_path / "b")
    assert back.model == tpol.model and back.n_dates == 4 and back.sim_seed == 1235
    np.testing.assert_array_equal(back.backward.train_loss, np.arange(4.0))
    for k, v in p1.items():
        np.testing.assert_array_equal(back.backward.params1_by_date[k].numpy(), v)
    with pytest.raises(ValueError, match="do not match"):
        policy_from_numpy({**meta, "times": [0.0, 0.5, 1.0]}, p1)
    with pytest.raises(ValueError, match="not a policy bundle"):
        load_bundle(tmp_path)
