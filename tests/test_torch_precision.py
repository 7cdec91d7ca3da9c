"""Port parity: the serving precision tiers (``orp_tpu_torch/serve/precision.py``,
the bf16 and int8 branches of ``serve/engine`` and ``serve/megakernel``, the
tier phases of ``serve/bench``) against the JAX package.

Tolerances:
- tier preparation (``quantize_tensor``, ``prepare_params``,
  ``dequantize_params``): bitwise, the same f32 operations in both packages;
- the bf16 tier against the JAX package's bf16 engine: ``BF16_RULE``, at
  least 99.9% of elements bitwise equal and every element within 4 bf16
  spacings (a CPU bf16 matmul and XLA's bf16 dot sum their f32 partials in
  different orders, so a tie can round apart);
- the int8 tier: the port's f32 serve tolerance (rtol 1e-5, atol 1e-6), as it
  runs the f32 forward on bitwise-equal dequantized weights;
- f32 and f64: bitwise against the formula without the bf16 scalar rounding
  (the slope and the cost of capital as Python scalars)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.serve import HedgeEngine as JHedgeEngine
from orp_tpu.serve.bundle import PolicyBundle as JPolicyBundle
from orp_tpu.serve.precision import dequantize_params as jdequantize_params
from orp_tpu.serve.precision import prepare_params as jprepare_params
from orp_tpu.serve.precision import quantize_tensor as jquantize_tensor
from orp_tpu.train.backward import BackwardResult as JBackwardResult
from orp_tpu_torch import NORTH_STAR_POLICY, PENSION_WALK
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.serve import (TIERS, HedgeEngine, PrecisionPolicy, load_bundle,
                                 normalize_precision, policy_from_numpy)
from orp_tpu_torch.serve.bench import PRECISION_BANDS, megakernel_phase, precision_phase
from orp_tpu_torch.serve.bundle import model_meta
from orp_tpu_torch.serve.megakernel import (mixed_head_bf16_order, mixed_head_plain,
                                            serve_outputs)
from orp_tpu_torch.serve.precision import (BF16_RULE, bf16_agreement, dequantize_params,
                                           gather_date, prepare_params, quantize_tensor)
from orp_tpu_torch.train.backward import _date_outputs_core

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_policy(tpol) -> JPolicyBundle:
    """The port's policy as the JAX package's PolicyBundle, from the same numpy params."""
    m = tpol.model
    jm = JHedgeMLP(n_features=m.n_features, hidden=m.hidden, negative_slope=m.negative_slope,
                   constrain_self_financing=m.constrain_self_financing,
                   init_scale=m.init_scale, dtype=jnp.float32, n_hedge_assets=m.n_hedge_assets)
    bw = tpol.backward
    state = {"params1_by_date": {k: jnp.asarray(v.numpy()) for k, v in
                                 bw.params1_by_date.items()},
             **{k: np.zeros(tpol.n_dates) for k in ("train_loss", "train_mae",
                                                    "train_mape", "epochs_ran")}}
    if bw.params2_by_date is not None:
        state["params2_by_date"] = {k: jnp.asarray(v.numpy())
                                    for k, v in bw.params2_by_date.items()}
    return JPolicyBundle(model=jm, backward=JBackwardResult.from_policy_state(state),
                         times=np.asarray(tpol.times), adjustment_factor=tpol.adjustment_factor,
                         dual_mode=tpol.dual_mode, holdings_combine=tpol.holdings_combine,
                         cost_of_capital=tpol.cost_of_capital, sim_seed=tpol.sim_seed,
                         fingerprint="")


@pytest.fixture(scope="module")
def trained():
    """A policy trained by the JAX package (``test_precision_tiers.py``'s config),
    as the port's policy."""
    res = european_hedge(EuropeanConfig(),
                         SimConfig(n_paths=512, T=1.0, dt=1 / 8, rebalance_every=2),
                         TrainConfig(dual_mode="mse_only", epochs_first=20, epochs_warm=10))
    p1 = {k: np.asarray(v, np.float32) for k, v in res.backward.params1_by_date.items()}
    model = HedgeMLP(n_features=1, constrain_self_financing=True)
    meta = {"model": model_meta(model), "times": np.asarray(res.times).tolist(),
            "adjustment_factor": 100.0, "dual_mode": "mse_only",
            "holdings_combine": "single", "cost_of_capital": 0.1,
            "sim_seed": res.sim_seed}
    return policy_from_numpy(meta, p1)


POLICIES = {"mse_only": "trained", "shared": "pension"}


@pytest.fixture(scope="module")
def pension():
    """The committed JAX pension walk's per-date params (``shared`` + ``py``, 3
    features, 40 dates)."""
    return load_bundle(PENSION_WALK)


def _rows(n, n_features, n_instruments, seed):
    rng = np.random.default_rng(seed)
    states = (1.0 + 0.1 * rng.standard_normal((n, n_features))).astype(np.float32)
    prices = np.concatenate([states[:, :1].repeat(n_instruments - 1, axis=1),
                             np.full((n, 1), 0.97, np.float32)], axis=1)
    return states, prices


def _random_params(sizes, n_dates, seed, zero_date=None):
    rng = np.random.default_rng(seed)
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = (0.5 * rng.standard_normal((n_dates, a, b))).astype(np.float32)
        p[f"b{i}"] = (0.1 * rng.standard_normal((n_dates, b))).astype(np.float32)
        if zero_date is not None:
            p[f"w{i}"][zero_date] = 0.0
    return p


def _bits(x):
    """Raw bits of a numpy / JAX / torch array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.dtype(f"u{x.element_size()}"))
    a = np.asarray(x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


# -- tier plumbing --------------------------------------------------------------


def test_precision_policy_validation():
    assert TIERS == ("f32", "bf16", "int8")
    assert PrecisionPolicy().is_f32
    assert normalize_precision("bf16").tier == "bf16"
    p = PrecisionPolicy("int8")
    assert normalize_precision(p) is p
    model = HedgeMLP(n_features=1)
    assert PrecisionPolicy("bf16").eval_dtype(model) == torch.bfloat16
    assert PrecisionPolicy("int8").eval_dtype(model) == torch.float32
    with pytest.raises(ValueError, match="tier"):
        PrecisionPolicy("fp4")
    with pytest.raises(ValueError, match="tier"):
        normalize_precision("f64")
    with pytest.raises(ValueError, match="tier"):
        prepare_params({"w0": np.ones((2, 1, 1), np.float32)}, "fp4")
    with pytest.raises(ValueError, match="tier"):
        HedgeEngine(load_bundle(NORTH_STAR_POLICY), device="cpu", precision="fp4")


# -- tier preparation, bitwise across packages ------------------------------------


@pytest.mark.parametrize("shape", [(4, 8, 3), (5, 1, 8), (3, 8), (6,)])
def test_quantize_tensor_bitwise_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32) * rng.choice([1e-3, 1.0, 40.0], shape)
    w[0] = 0.0  # an all-zero date: scale 1, no division by zero
    got, want = quantize_tensor(w), jquantize_tensor(w, accum_dtype=jnp.float32)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    for k in ("q", "scale"):
        assert got[k].shape == tuple(np.asarray(want[k]).shape)
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    deq = dequantize_params({"w": got})["w"]
    np.testing.assert_array_equal(_bits(deq), _bits(jdequantize_params({"w": want})["w"]))
    # the closed-form round-trip bound: half a step per element
    assert (np.abs(deq.numpy() - w) <= got["scale"].numpy() / 2 + 1e-7).all()


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("source", ["trained", "random"])
def test_prepare_params_bitwise_equals_jax(tier, source, trained):
    if source == "trained":
        params = {k: v.numpy() for k, v in trained.backward.params1_by_date.items()}
    else:
        params = _random_params((3, 8, 8, 2), 6, seed=4, zero_date=2)
    got = prepare_params(params, tier)
    want = jprepare_params({k: jnp.asarray(v) for k, v in params.items()}, tier,
                           model_dtype=jnp.float32)
    assert sorted(got) == sorted(want)
    for k in params:
        if tier == "int8" and k.startswith("w"):
            assert got[k]["q"].dtype == torch.int8 and got[k]["scale"].dtype == torch.float32
            for n in ("q", "scale"):
                np.testing.assert_array_equal(_bits(got[k][n]), _bits(want[k][n]))
        else:
            dt = torch.bfloat16 if tier == "bf16" else torch.float32
            assert got[k].dtype == dt
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    deq, jdeq = dequantize_params(got), jdequantize_params(want)
    for k in params:
        np.testing.assert_array_equal(_bits(deq[k]), _bits(jdeq[k]))
    # the date gather of a quantized node, then dequantize: the same bits
    one = dequantize_params(gather_date(got, 3))
    for k in params:
        np.testing.assert_array_equal(_bits(one[k]), _bits(deq[k][3]))


# -- f32 and f64 bits after the scalar-rounding repair ----------------------------


def _plain_forward(model, params, feats):
    """The forward with the slope as a Python scalar (the formula before the repair)."""
    x = feats
    for i in range(len(model.hidden)):
        z = x @ params[f"w{i}"] + params[f"b{i}"]
        x = torch.where(z >= 0, z, model.negative_slope * z)
    last = len(model.hidden)
    return x @ params[f"w{last}"] + params[f"b{last}"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dual_mode, combine", [("mse_only", "single"), ("separate", "single"),
                                                ("separate", "py"), ("shared", "single")])
@pytest.mark.parametrize("constrain", [False, True])
def test_f32_f64_bits_unchanged(dtype, dual_mode, combine, constrain):
    model = HedgeMLP(n_features=2, constrain_self_financing=constrain, dtype=dtype)
    rng = np.random.default_rng(7)
    p1, p2 = ({k: torch.from_numpy(v[1]).to(dtype)
               for k, v in _random_params(model.layer_sizes, 2, seed=s).items()}
              for s in (1, 2))
    feats = torch.from_numpy(1.0 + 0.1 * rng.standard_normal((300, 2))).to(dtype)
    prices = torch.from_numpy(np.stack([1.0 + 0.1 * rng.standard_normal(300),
                                        np.full(300, 0.97)], 1)).to(dtype)
    prices1 = prices.flip(0)
    target = torch.from_numpy(rng.standard_normal(300)).to(dtype)
    coc = 0.1

    def hold(raw):
        if constrain:
            return torch.stack([raw[:, 0], 1.0 - raw[:, 0]], dim=-1)
        return raw

    raw1, raw2 = _plain_forward(model, p1, feats), _plain_forward(model, p2, feats)
    h1, h2 = hold(raw1), hold(raw2)
    g, h = torch.sum(h1 * prices, -1), torch.sum(h2 * prices, -1)
    if dual_mode == "mse_only":
        v, comb = g, h1
    elif dual_mode == "shared":
        v, comb = g + coc * (h - g), h2
    else:
        v = g + coc * (h - g)
        comb = h1 + coc * (h1 - h2) if combine == "py" else h1 + coc * (h2 - h1)
    resid = target - torch.sum(comb * prices1, -1)
    np.testing.assert_array_equal(_bits(model.holdings(p1, feats)), _bits(h1))
    np.testing.assert_array_equal(_bits(model.value(p1, feats, prices)), _bits(g))
    got = _date_outputs_core(model, p1, p2, feats, prices, prices1, target, coc, g,
                             dual_mode=dual_mode, holdings_combine=combine)
    for a, b in zip(got, (v, comb, resid)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the served block: the walk's combines at prices_t1 = 0, bit for bit
    served = serve_outputs(model, raw1, raw2, prices, coc, dual_mode=dual_mode,
                           holdings_combine=combine)
    for a, b in zip(served, (comb[:, 0], comb[:, -1], v)):
        assert a.dtype == dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_served_f32_block_bits_unchanged(trained):
    """``HedgeEngine`` f32 (both paths) against the plain formula, bitwise."""
    eng = HedgeEngine(trained, device="cpu")
    states, prices = _rows(37, 1, 2, seed=5)
    p = trained.backward.params1_by_date
    dates = np.random.default_rng(4).integers(0, 4, 37)
    for d in range(4):
        raw = _plain_forward(trained.model, {k: v[d] for k, v in p.items()},
                             torch.from_numpy(states))[:, 0]
        want = (raw, 1.0 - raw, torch.sum(torch.stack([raw, 1.0 - raw], -1)
                                          * torch.from_numpy(prices), -1))
        for a, b in zip(eng.evaluate(d, states, prices), want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        m = dates == d
        for a, b in zip(eng.evaluate_mixed_async(dates, states, prices).result(), want):
            np.testing.assert_array_equal(_bits(a[m]), _bits(b[m]))


# -- the reduced tiers against the JAX package's engine --------------------------


def _policy(name, trained, pension):
    return trained if name == "trained" else pension


@pytest.mark.parametrize("dual_mode", sorted(POLICIES))
def test_bf16_tier_matches_jax_engine(dual_mode, trained, pension):
    tpol = _policy(POLICIES[dual_mode], trained, pension)
    assert tpol.dual_mode == dual_mode
    jeng = JHedgeEngine(_jax_policy(tpol), use_aot=False, precision="bf16")
    eng = HedgeEngine(tpol, device="cpu", precision="bf16")
    assert eng.cache_info()["precision"] == "bf16"
    m = tpol.model
    states, prices = _rows(1000, m.n_features, eng.n_instruments, seed=8)
    dates = np.random.default_rng(6).integers(0, tpol.n_dates, 1000)
    for path, got, want in (
            ("evaluate", eng.evaluate(3, states, prices), jeng.evaluate(3, states, prices)),
            ("mixed", eng.evaluate_mixed_async(dates, states, prices).result(),
             jeng.evaluate_mixed_async(dates, states, prices).result())):
        for name, a, b in zip(("phi", "psi", "v"), got, want):
            assert a.dtype == np.float32
            agree = bf16_agreement(a, np.asarray(b))
            print(f"{dual_mode} {path} {name}: {agree['equal_share']:.4%} bitwise equal, "
                  f"{agree['n_differ']} differ, max {agree['max_ulps']:.2f} bf16 spacings")
            assert agree["ok"], (path, name, agree, BF16_RULE)


@pytest.mark.parametrize("dual_mode", sorted(POLICIES))
def test_int8_tier_matches_jax_engine(dual_mode, trained, pension):
    tpol = _policy(POLICIES[dual_mode], trained, pension)
    jeng = JHedgeEngine(_jax_policy(tpol), use_aot=False, precision="int8")
    eng = HedgeEngine(tpol, device="cpu", precision="int8")
    m = tpol.model
    states, prices = _rows(500, m.n_features, eng.n_instruments, seed=9)
    dates = np.random.default_rng(3).integers(0, tpol.n_dates, 500)
    for got, want in ((eng.evaluate(2, states, prices), jeng.evaluate(2, states, prices)),
                      (eng.evaluate_mixed_async(dates, states, prices).result(),
                       jeng.evaluate_mixed_async(dates, states, prices).result())):
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)


def test_bf16_plain_head_rounds_like_the_reference():
    """The bf16 head rounds the slope to bf16 (0.3 -> 0.30078125) and rounds after
    each operation: an emulation in float64 with explicit roundings gives the
    same bits, and the unrounded slope does not."""
    model = HedgeMLP(n_features=2, hidden=(8, 8)).with_dtype(torch.bfloat16)
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in _random_params(model.layer_sizes, 3, seed=5).items()}
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((4000, 2)).astype(np.float32)).bfloat16()
    dates = torch.from_numpy(rng.integers(0, 3, 4000))

    def rnd(x):
        return x.to(torch.bfloat16).double()

    def emulate(slope):
        out = torch.empty(4000, model.n_outputs, dtype=torch.float64)
        for d in range(3):
            x = feats.double()
            for i in range(3):
                z = rnd(rnd(x @ params[f"w{i}"][d].double()) + params[f"b{i}"][d].double())
                x = torch.where(z >= 0, z, rnd(slope * z)) if i < 2 else z
            out[dates == d] = x[dates == d]
        return out

    got = mixed_head_plain(model, params, dates, feats)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.double().numpy(), emulate(0.30078125).numpy())
    assert not np.array_equal(got.double().numpy(), emulate(0.3).numpy())


def _bf16_head_f64(model, params, dates, feats):
    """A bf16 head with every dot summed exactly (float64) and each operation
    rounded to bf16 as the kernel documents."""
    def rnd(x):
        return x.to(torch.bfloat16).double()

    slope = rnd(torch.tensor(model.negative_slope, dtype=torch.float64))
    n_layers = len(model.hidden) + 1
    out = torch.empty(feats.shape[0], model.n_outputs, dtype=torch.float64)
    for d in range(int(params["w0"].shape[0])):
        x = feats.double()
        for i in range(n_layers):
            z = rnd(rnd(x @ params[f"w{i}"][d].double()) + params[f"b{i}"][d].double())
            x = torch.where(z >= 0, z, rnd(slope * z)) if i < n_layers - 1 else z
        out[dates == d] = x[dates == d]
    return out


@pytest.mark.parametrize("model", [HedgeMLP(n_features=1), HedgeMLP(n_features=3,
                                                                     n_hedge_assets=2),
                                   HedgeMLP(n_features=5), HedgeMLP(n_features=5,
                                                                     n_hedge_assets=5)],
                         ids=["north-star", "pension", "basket", "vector"])
def test_k2_bf16_order_is_the_plain_head_where_sums_are_exact(model):
    """``mixed_head_bf16_order`` (the bf16 kernel's arithmetic) and
    ``mixed_head_plain`` in bf16 round each operation alike and differ only in
    the order of a dot's f32 sum: on params and features that are multiples of
    1/8 every such sum is exact (the float64 head agrees), and the two are
    bitwise equal."""
    bf = model.with_dtype(torch.bfloat16)
    params = {k: torch.from_numpy(np.round(8 * v) / 8).to(torch.bfloat16)
              for k, v in _random_params(model.layer_sizes, 4, seed=6).items()}
    rng = np.random.default_rng(2)
    n = 3000
    feats = torch.from_numpy(np.round(8 + 4 * rng.standard_normal((n, model.n_features)))
                             / 8).to(torch.bfloat16)
    dates = torch.from_numpy(rng.integers(0, 4, n))
    got = mixed_head_bf16_order(bf, params, dates, feats)
    assert got.dtype == torch.bfloat16 and got.shape == (n, model.n_outputs)
    exact = _bf16_head_f64(bf, params, dates, feats)
    np.testing.assert_array_equal(got.double().numpy(), exact.numpy())
    np.testing.assert_array_equal(mixed_head_plain(bf, params, dates, feats).double().numpy(),
                                  exact.numpy())


def test_k2_bf16_order_sums_in_input_order():
    """A dot of products ``1, 2^-25, -1`` in that order sums to 0 in f32 (``1 +
    2^-25`` rounds to 1), where the exact sum is ``2^-25``: the order is the
    features' order, as the kernel's FMA chain runs."""
    model = HedgeMLP(n_features=3, hidden=(1, 1)).with_dtype(torch.bfloat16)
    one = dict(dtype=torch.bfloat16)
    params = {"w0": torch.tensor([[[1.0], [2.0 ** -13], [-1.0]]], **one),
              "b0": torch.zeros(1, 1, **one), "w1": torch.ones(1, 1, 1, **one),
              "b1": torch.zeros(1, 1, **one), "w2": torch.ones(1, 1, 2, **one),
              "b2": torch.zeros(1, 2, **one)}
    dates = torch.zeros(2, dtype=torch.int64)
    feats = torch.tensor([[1.0, 2.0 ** -12, 1.0], [1.0, 2.0 ** -12, 0.0]], **one)
    got = mixed_head_bf16_order(model, params, dates, feats).double()
    np.testing.assert_array_equal(got.numpy(), [[0.0, 0.0], [1.0, 1.0]])
    exact = _bf16_head_f64(model, params, dates, feats)
    np.testing.assert_array_equal(exact[0].numpy(), [2.0 ** -25] * 2)


def test_reduced_tiers_inside_their_bands(trained):
    """As ``tests/test_precision_tiers.py``: bf16 and int8 serve different bits
    from f32, within ``PRECISION_BANDS``, and f32 outputs."""
    f32 = HedgeEngine(trained, device="cpu")
    states, prices = _rows(128, 1, 2, seed=5)
    for tier in ("bf16", "int8"):
        eng = HedgeEngine(trained, device="cpu", precision=tier)
        worst = 0.0
        for d in range(f32.n_dates):
            phi0, psi0, _ = f32.evaluate(d, states, prices)
            phi1, psi1, v1 = eng.evaluate(d, states, prices)
            assert phi1.dtype == np.float32 and v1.dtype == np.float32
            worst = max(worst, np.abs(phi1 - phi0).max(), np.abs(psi1 - psi0).max())
        assert 0.0 < worst <= PRECISION_BANDS[tier], f"{tier}: {worst}"


@pytest.mark.parametrize("which", ["north_star", "pension"])
def test_committed_policies_deviate_from_f32_as_the_reference_does(which):
    """On the committed JAX-trained policies the reduced tiers serve as far from
    f32 as the JAX package's own tiers do, on every date. The reference's
    absolute bands assume holdings of order one; the north-star policy's psi
    is ~125 (bond units), so the deviations are printed beside the bands."""
    tpol = load_bundle(NORTH_STAR_POLICY if which == "north_star" else PENSION_WALK)
    jpol = _jax_policy(tpol)
    feats = (1.0 + 0.1 * np.random.default_rng(0).standard_normal(
        (512, tpol.model.n_features))).astype(np.float32)
    port = {t: HedgeEngine(tpol, device="cpu", precision=t) for t in TIERS}
    ref = {t: JHedgeEngine(jpol, use_aot=False, precision=t) for t in TIERS}
    worst = {}
    for d in range(tpol.n_dates):
        got = {t: port[t].evaluate(d, feats)[:2] for t in TIERS}
        want = {t: tuple(np.asarray(x) for x in ref[t].evaluate(d, feats)[:2]) for t in TIERS}
        for tier in ("bf16", "int8"):
            for who, out in (("port", got), ("jax", want)):
                dev = max(float(np.abs(a - b).max()) for a, b in zip(out[tier], out["f32"]))
                worst[who, tier] = max(worst.get((who, tier), 0.0), dev)
    for tier in ("bf16", "int8"):
        print(f"{which} {tier}: max |dphi|, |dpsi| vs f32: port {worst['port', tier]:.4g}, "
              f"JAX {worst['jax', tier]:.4g} (band {PRECISION_BANDS[tier]:g})")
        np.testing.assert_allclose(worst["port", tier], worst["jax", tier], rtol=1e-3)


# -- the bench phases -----------------------------------------------------------


def test_precision_phase_runs_and_gates(trained):
    rec = precision_phase(trained, rows=64, repeats=3, seed=0, device="cpu")
    tiers = {lv["tier"]: lv for lv in rec["tiers"]}
    assert list(tiers) == list(TIERS)
    # the promotion drill: refused under bits, then skipped (no baked validation set)
    assert [(d["tier"], d["outcome"], d["refused_under_bitwise"])
            for d in rec["promotion_drill"]] == [("bf16", "skipped", True),
                                                 ("int8", "skipped", True)]
    assert tiers["f32"]["bitwise_equal_to_f32"]
    for tier in ("bf16", "int8"):
        lv = tiers[tier]
        assert 0 < max(lv["max_abs_dphi_vs_f32"], lv["max_abs_dpsi_vs_f32"]) <= lv["band"]
        assert lv["rows_per_s"] > 0 and tier in rec["speedup_vs_f32"]
    # a broken bf16 engine (sign-flipped last layer) trips the band
    broken = HedgeEngine(trained, device="cpu", precision="bf16")
    broken._p1 = {**broken._p1, "w2": -broken._p1["w2"]}
    engines = {"f32": HedgeEngine(trained, device="cpu"), "bf16": broken,
               "int8": HedgeEngine(trained, device="cpu", precision="int8")}
    with pytest.raises(RuntimeError, match="precision band violated: tier 'bf16'"):
        precision_phase(trained, rows=64, repeats=1, seed=0, engines=engines)


def test_megakernel_phase_runs_and_gates(trained):
    rec = megakernel_phase(trained, rows=64, repeats=2, seed=0, device="cpu")
    assert [lv["tier"] for lv in rec["tiers"]] == list(TIERS)
    for lv in rec["tiers"]:
        assert lv["distinct_dates"] == lv["dispatches_off"] == 4
        assert lv["kernel_launches_on"] == 0  # the CPU runs the plain version
        assert lv["on_rows_per_s"] > 0 and lv["off_rows_per_s"] > 0
    # a broken mixed path (int8 weights not dequantized the same) trips the gate
    broken = HedgeEngine(trained, device="cpu", precision="int8")
    p1, p2, k1, k2 = broken._mixed_params()
    broken._mixed = ({**p1, "b0": p1["b0"] + 0.05}, p2, k1, k2)
    engines = {"f32": HedgeEngine(trained, device="cpu"),
               "bf16": HedgeEngine(trained, device="cpu", precision="bf16"), "int8": broken}
    with pytest.raises(RuntimeError, match="disagree on phi in tier 'int8'"):
        megakernel_phase(trained, rows=64, repeats=1, seed=0, engines=engines)
