"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is false
(decided inside the fixture, never at import). This file imports neither JAX
nor ``orp_tpu``, so it runs on a machine without them::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from orp_tpu_torch import NORTH_STAR_POLICY
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.qmc import fused_gbm, fused_mf
from orp_tpu_torch.sde import TimeGrid, simulate_pension
from orp_tpu_torch.train import BackwardConfig, backward_induction, fit, losses
from orp_tpu_torch.train.gn import GNConfig, fit_gn
from orp_tpu_torch.serve import HedgeEngine, load_bundle, loop_of_buckets, megakernel
from orp_tpu_torch.serve.precision import bf16_agreement

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


# the path kernels (K1 and K3, one template) form each Sobol word from a warp
# part (index bits 5-31, shared through __shfl_sync) and a lane part (bits
# 0-4): sizes with a partial last warp, one lane in the second warp (33), and
# index bits above 2^21
FUSED_MF_SIZES = [(1, 28, 7), (1000, 28, 1), (4097, 364, 7), (33, 40, 10), (2_097_185, 16, 8)]


@pytest.mark.parametrize("n_paths, n_steps, store", FUSED_MF_SIZES)
def test_fused_gbm_matches_plain(cuda, n_paths, n_steps, store):
    kw = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / n_steps, seed=1235,
              store_every=store, device=cuda)
    before = fused_gbm.gbm_log_fused.launches
    got = fused_gbm.gbm_log_fused(n_paths, n_steps, **kw)
    torch.cuda.synchronize()
    assert fused_gbm.gbm_log_fused.launches == before + 1
    want = fused_gbm.gbm_log_plain(n_paths, n_steps, **kw)
    assert got.shape == (n_paths, n_steps // store + 1)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=0.0)


def test_fused_gbm_dense_grid_matches_plain(cuda):
    """365 knots, past the reference's 256-knot single-call cap, where it
    chains ``_gbm_kernel_chunk`` calls: K1 is one launch at any knot count."""
    kw = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / 364, seed=1235, store_every=1,
              device=cuda)
    before = fused_gbm.gbm_log_fused.launches
    got = fused_gbm.gbm_log_fused(65_536, 364, **kw)
    torch.cuda.synchronize()
    assert fused_gbm.gbm_log_fused.launches == before + 1
    want = fused_gbm.gbm_log_plain(65_536, 364, **kw)
    assert got.shape == (65_536, 365)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=0.0)


def test_fused_gbm_validates_on_card(cuda):
    with pytest.raises(ValueError, match="must divide"):
        fused_gbm.gbm_log_fused(128, 10, s0=1.0, drift=0.0, sigma=0.1, dt=0.1,
                                store_every=3, device=cuda)


def _params(model, n_dates, seed, device):
    g = torch.Generator().manual_seed(seed)
    sizes = model.layer_sizes
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = (0.5 * torch.randn(n_dates, a, b, generator=g)).to(device)
        p[f"b{i}"] = (0.1 * torch.randn(n_dates, b, generator=g)).to(device)
    return p


@pytest.mark.parametrize("model", [
    HedgeMLP(n_features=1),
    HedgeMLP(n_features=1, constrain_self_financing=True),
    HedgeMLP(n_features=3, n_hedge_assets=2),
    HedgeMLP(n_features=2, hidden=(16, 4, 8)),
])
@pytest.mark.parametrize("n_rows", [1, 257, 100_003])
def test_mixed_head_matches_plain(cuda, model, n_rows):
    p = _params(model, 52, 3, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    dates = torch.randint(0, 52, (n_rows,), device=cuda, generator=g, dtype=torch.int32)
    feats = 1.0 + 0.1 * torch.randn(n_rows, model.n_features, device=cuda, generator=g)
    got = megakernel.mixed_head_forward(model, p, dates, feats)
    torch.cuda.synchronize()
    want = megakernel.mixed_head_plain(model, p, dates, feats)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


HEADS = [HedgeMLP(n_features=1), HedgeMLP(n_features=1, constrain_self_financing=True),
         HedgeMLP(n_features=3, n_hedge_assets=2), HedgeMLP(n_features=2, hidden=(16, 4, 8))]


@pytest.mark.parametrize("model", HEADS)
@pytest.mark.parametrize("n_rows", [1, 33, 4097, 1_048_576])
def test_mixed_head_bf16_matches_plain(cuda, model, n_rows):
    """The bf16 kernel against ``mixed_head_plain`` in bf16 (cuBLAS, f32
    reduction): bitwise except where the two sum a dot's f32 partials in
    another order and round apart, at most 1e-3 of the elements, each within 4
    bf16 spacings."""
    bf = model.with_dtype(torch.bfloat16)
    p = {k: v.to(torch.bfloat16) for k, v in _params(model, 52, 3, cuda).items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    dates = torch.randint(0, 52, (n_rows,), device=cuda, generator=g, dtype=torch.int32)
    feats = (1.0 + 0.1 * torch.randn(n_rows, model.n_features, device=cuda,
                                      generator=g)).to(torch.bfloat16)
    fn = megakernel.mixed_head_forward
    before = (fn.launches, fn.launches_bf16)
    got = fn(bf, p, dates, feats)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (n_rows, model.n_outputs)
    want = megakernel.mixed_head_plain(bf, p, dates, feats)
    agree = bf16_agreement(got, want)
    print(f"{model.layer_sizes} {n_rows} rows: {agree}")
    assert agree["ok"], agree


def _edge_dates(case, n_dates, device):
    """The dates of one of ``K2_EDGES``' cases."""
    g = torch.Generator(device=device).manual_seed(11)
    t = megakernel.TILE_ROWS
    if case.startswith("rows_"):
        # enough rows that every block takes whole tiles of TILE_ROWS (the kernel
        # cuts smaller tiles only while the rows leave a block's slot empty)
        n = 600 * t + {"rows_tile_minus_1": -1, "rows_tile": 0, "rows_tile_plus_1": 1}[case]
        return torch.randint(0, n_dates, (n,), device=device, generator=g,
                             dtype=torch.int32)
    n = 3 * t + 5
    if case == "one_date":
        return torch.full((n,), n_dates // 2, device=device, dtype=torch.int32)
    if case == "descending":
        return (n_dates - 1 - torch.arange(n, device=device) * n_dates // n).to(torch.int32)
    if case == "bad_dates":  # in- and out-of-range dates mixed in every tile
        return torch.randint(-3, n_dates + 3, (n,), device=device, generator=g,
                             dtype=torch.int32)
    if case == "offset_views":  # contiguous views 4 bytes past a 16-byte start
        return torch.randint(0, n_dates, (n + 1,), device=device, generator=g,
                             dtype=torch.int32)[1:]
    return torch.randint(0, n_dates, (n,), device=device, generator=g, dtype=torch.int32)


def _near_full_dates(model, elem, staged):
    """Dates whose params fill shared memory: the most ``check_head_shape``
    accepts (the plan keeps them in device memory), or the most whose padded
    layout still stages beside a tile that has to shrink."""
    n = megakernel.MAX_SMEM_BYTES // (model.n_params() * elem)
    if staged:
        while not megakernel.head_plan(model.layer_sizes, n, elem)["staged"]:
            n -= 1
    return n


# the redesign's edges: rows around a tile's end; one date; dates sorted
# descending; NaN rows beside good rows in every tile; inputs that are views off
# a 16-byte start (the tile copies go element by element); one date in all;
# params nearly filling shared memory (the tile shrinks), and filling it (no
# staging)
K2_EDGES = ["rows_tile_minus_1", "rows_tile", "rows_tile_plus_1", "one_date", "descending",
            "bad_dates", "offset_views", "n_dates_1", "near_full_staged",
            "near_full_unstaged"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K2_EDGES)
def test_mixed_head_edges_match_plain(cuda, case, dtype):
    """f32 at rtol 1e-5 / atol 1e-6, bf16 by ``BF16_RULE``, NaN rows equal."""
    model = HedgeMLP(n_features=1).with_dtype(dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    n_dates = {"n_dates_1": 1,
               "near_full_staged": _near_full_dates(model, elem, True),
               "near_full_unstaged": _near_full_dates(model, elem, False)}.get(case, 52)
    plan = megakernel.head_plan(model.layer_sizes, n_dates, elem)
    if case == "near_full_staged":
        assert plan["staged"] and plan["tile"] < megakernel.TILE_ROWS, plan
    if case == "near_full_unstaged":
        assert not plan["staged"] and n_dates * model.n_params() * elem > (
            megakernel.MAX_SMEM_BYTES - model.n_params() * elem)
    p = {k: v.to(dtype) for k, v in _params(model, n_dates, 5, cuda).items()}
    dates = _edge_dates(case, n_dates, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    skip = int(case == "offset_views")
    feats = (1.0 + 0.1 * torch.randn(dates.shape[0] + skip, 1, device=cuda,
                                     generator=g)).to(dtype)[skip:]
    if skip:
        assert dates.data_ptr() % 16 and feats.data_ptr() % 16
    got = megakernel.mixed_head_forward(model, p, dates, feats)
    torch.cuda.synchronize()
    want = megakernel.mixed_head_plain(model, p, dates, feats)
    bad = (dates < 0) | (dates >= n_dates)
    assert bool(torch.isnan(got[bad]).all()) and bool(torch.isfinite(got[~bad]).all())
    if case == "bad_dates":
        assert 0 < int(bad.sum()) < dates.shape[0]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        agree = bf16_agreement(got, want)
        assert agree["ok"], agree


def test_mixed_head_bf16_nan_rows_and_refusals(cuda):
    model = HedgeMLP(n_features=1).with_dtype(torch.bfloat16)
    p = {k: v.to(torch.bfloat16) for k, v in _params(model, 4, 0, cuda).items()}
    feats = torch.ones(3, 1, device=cuda, dtype=torch.bfloat16)
    out = megakernel.mixed_head_forward(model, p, torch.tensor([0, 4, -1], device=cuda,
                                                               dtype=torch.int32), feats)
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1:]).all())
    dates = torch.zeros(3, dtype=torch.int32, device=cuda)
    p32 = {k: v.float() for k, v in p.items()}
    with pytest.raises(ValueError, match="params must be"):
        megakernel.mixed_head_forward(model, p32, dates, feats)
    with pytest.raises(ValueError, match="params must be"):
        megakernel.mixed_head_forward(model, p, dates, feats.float())
    with pytest.raises(ValueError, match="computes in"):
        megakernel.mixed_head_forward(model, p, dates, feats.half())


def test_engine_tiers_on_card_bucketed_vs_mixed(cuda):
    """Each tier's bucketed path (cuBLAS) against its mixed path (the kernel) on
    the north-star policy's stored rows: f32 and int8 at the f32 tolerance,
    bf16 by the bf16 rule; outputs f32 in every tier."""
    policy = load_bundle(NORTH_STAR_POLICY)
    with np.load(NORTH_STAR_POLICY / "reference.npz") as z:
        dates, states, prices = z["dates"], z["states"], z["prices"]
    for tier in ("f32", "bf16", "int8"):
        engine = HedgeEngine(policy, precision=tier)
        counter = "launches_bf16" if tier == "bf16" else "launches"
        before = getattr(megakernel.mixed_head_forward, counter)
        mixed = engine.evaluate_mixed_async(dates, states, prices).result()
        assert getattr(megakernel.mixed_head_forward, counter) == before + 1
        loop = loop_of_buckets(engine, dates, states, prices)
        for name, a, b in zip(("phi", "psi", "v"), mixed, loop):
            assert a.dtype == np.float32 and b.dtype == np.float32
            if tier == "bf16":
                agree = bf16_agreement(a, b)
                print(f"{tier} {name}: {agree}")
                assert agree["ok"], (name, agree)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def test_mixed_head_refuses_bad_inputs(cuda):
    model = HedgeMLP(n_features=1)
    p = _params(model, 4, 0, cuda)
    feats = torch.ones(8, 1, device=cuda)
    with pytest.raises(ValueError, match="dates must be"):
        megakernel.mixed_head_forward(model, p, torch.zeros(8, dtype=torch.int64,
                                                            device=cuda), feats)
    with pytest.raises(ValueError, match="feats must be"):
        megakernel.mixed_head_forward(model, p, torch.zeros(4, dtype=torch.int32, device=cuda),
                                      torch.ones(1, 8, device=cuda).T[::2])
    with pytest.raises(ValueError, match="layers of width"):
        big = HedgeMLP(n_features=1, hidden=(32,))
        megakernel.mixed_head_forward(big, _params(big, 4, 0, cuda),
                                      torch.zeros(8, dtype=torch.int32, device=cuda), feats)


def test_engine_on_card_mixed_equals_loop_of_buckets(cuda):
    engine = HedgeEngine(load_bundle(NORTH_STAR_POLICY))
    assert engine.device.type == "cuda"
    with np.load(NORTH_STAR_POLICY / "reference.npz") as z:
        dates, states, prices = z["dates"], z["states"], z["prices"]
    mixed = engine.evaluate_mixed_async(dates, states, prices).result()
    loop = loop_of_buckets(engine, dates, states, prices)
    for a, b in zip(mixed, loop):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


HESTON = dict(s0=100.0, mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
# A > 0 (strongly positive rho): QE's uncorrected-drift branch
HESTON_POS_RHO = dict(HESTON, rho=0.9)


@pytest.mark.parametrize("n_paths, n_steps, store", FUSED_MF_SIZES)
@pytest.mark.parametrize("scheme", ["euler", "qe", "qe_uncorrected"])
def test_fused_heston_matches_plain(cuda, n_paths, n_steps, store, scheme):
    """Tolerances of tests/test_pallas.py: Euler S and v at rtol 3e-5, atol
    3e-6; QE S at rtol 3e-5, v at rtol 2e-3, atol 1e-6 (the AS241 tail and
    FMA contraction move the variance's quadratic branch)."""
    fused = fused_mf.heston_log_fused if scheme == "euler" else fused_mf.heston_qe_fused
    plain = fused_mf.heston_log_plain if scheme == "euler" else fused_mf.heston_qe_plain
    kw = dict(HESTON_POS_RHO if scheme == "qe_uncorrected" else HESTON,
              dt=1.0 / n_steps, seed=1235, store_every=store)
    before = fused.launches
    got = fused(n_paths, n_steps, device=cuda, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    want = plain(n_paths, n_steps, device=cuda, **kw)
    for k in ("S", "v"):
        assert got[k].shape == (n_paths, n_steps // store + 1)
    torch.testing.assert_close(got["S"], want["S"], rtol=3e-5, atol=3e-6 if scheme == "euler"
                               else 0.0)
    torch.testing.assert_close(got["v"], want["v"], rtol=3e-5 if scheme == "euler" else 2e-3,
                               atol=3e-6 if scheme == "euler" else 1e-6)


def test_fused_heston_validates_on_card(cuda):
    with pytest.raises(ValueError, match="must divide"):
        fused_mf.heston_qe_fused(128, 10, dt=0.1, store_every=3, device=cuda, **HESTON)
    with pytest.raises(ValueError, match="direction table"):
        fused_mf.heston_log_fused(128, 8193, dt=0.1, device=cuda, **HESTON)


def test_fit_gn_on_card_matches_cpu(cuda):
    """The same fit on the card and on the CPU in float64, where the two run
    the same LM iterations (in f32 the trajectories can part on a borderline
    accept/reject): final loss at rtol 1e-9, history at rtol 1e-8. The CPU
    side is held to the JAX package the same way (tests/test_torch_gn.py)."""
    rng = np.random.default_rng(5)
    model = HedgeMLP(n_features=2, dtype=torch.float64)
    n = 4096
    feats = np.stack([np.exp(0.2 * rng.standard_normal(n)), 0.02 + 0.01 * rng.random(n)], 1)
    prices = np.stack([feats[:, 0], np.full(n, 1.08)], 1)
    y = np.maximum(feats[:, 0] - 1.0, 0.0) + 0.01 * rng.standard_normal(n)
    params = model.init(torch.Generator().manual_seed(3), bias_init=(0.1, 0.0))
    out = {}
    for dev in ("cpu", cuda):
        t = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (feats, prices, y)]
        _, aux = fit_gn(model, {k: v.to(dev) for k, v in params.items()}, *t,
                        cfg=GNConfig(n_iters=30))
        out[str(dev)] = {k: aux[k].cpu().numpy() for k in ("final_loss", "loss_history")}
    np.testing.assert_allclose(out["cuda"]["final_loss"], out["cpu"]["final_loss"], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"]["loss_history"], out["cpu"]["loss_history"],
                               rtol=1e-8)


PENSION = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0)
# the CIR-vol fund at StochVolConfig()'s values (v is vol)
PENSION_SV = dict(PENSION, sigma=None, sv=True, v0=0.15, cir_a=0.00336, cir_b=0.15431,
                  cir_c=0.01583)


@pytest.mark.parametrize("n_paths, n_steps, store", [(1, 40, 10), (1000, 40, 1),
                                                     (4097, 1000, 25), (33, 40, 10),
                                                     (2_097_185, 16, 8)])
@pytest.mark.parametrize("mode", ["normal", "inversion"])
@pytest.mark.parametrize("sv", [False, True])
def test_fused_pension_matches_plain(cuda, n_paths, n_steps, store, mode, sv):
    """The kernel and its plain version on one card agree bitwise: Y, v and
    lambda, and the survivors N on every knot (the pension step rounds each
    operation on its own, in the plain version's order). Inside the
    tolerances of tests/test_pallas.py (rtol 3e-5; N on >= 99.9% of knots),
    which hold the plain version to the JAX package."""
    kw = dict(PENSION_SV if sv else PENSION, dt=10.0 / n_steps, seed=1234, store_every=store,
              binomial_mode=mode)
    before = fused_mf.pension_fused.launches
    got = fused_mf.pension_fused(n_paths, n_steps, device=cuda, **kw)
    torch.cuda.synchronize()
    assert fused_mf.pension_fused.launches == before + 1
    want = fused_mf.pension_plain(n_paths, n_steps, device=cuda, **kw)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.shape == (n_paths, n_steps // store + 1), k
    for k in got:
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


def test_fused_pension_validates_on_card(cuda):
    with pytest.raises(ValueError, match="engine='pallas' supports binomial_mode"):
        fused_mf.pension_fused(128, 8, dt=0.25, binomial_mode="exact", device=cuda, **PENSION)
    with pytest.raises(ValueError, match="sigma is required"):
        fused_mf.pension_fused(128, 8, dt=0.25, device=cuda, **dict(PENSION, sigma=None))
    with pytest.raises(ValueError, match="direction table"):
        fused_mf.pension_fused(128, 4097, dt=0.01, device=cuda, **PENSION)


def _fit_data(n: int, dtype, seed: int = 5):
    rng = np.random.default_rng(seed)
    s = np.exp(0.2 * rng.standard_normal(n))
    feats = np.stack([s, 0.02 + 0.01 * rng.random(n)], 1)
    prices = np.stack([s, np.full(n, 1.08)], 1)
    y = np.maximum(s - 1.0, 0.0) + 0.01 * rng.standard_normal(n)
    return [torch.as_tensor(a, dtype=dtype) for a in (feats, prices, y)]


@pytest.mark.parametrize("shuffle", [False, True, "blocks"])
def test_fit_core_on_card_matches_cpu(cuda, shuffle):
    """Adam on the card (each epoch a CUDA graph) and on the CPU in float64, on
    the same orders (both draw them on the host from one seed): params and loss
    history at rtol 1e-9, the same epochs run. The CPU side is held to the JAX
    package the same way (tests/test_torch_fit.py)."""
    model = HedgeMLP(n_features=2, dtype=torch.float64)
    params = model.init(torch.Generator().manual_seed(3), bias_init=(0.1, 0.0))
    cfg = fit.FitConfig(n_epochs=30, batch_size=500, patience=3, shuffle=shuffle, lr=2e-2)
    out = {}
    for dev in ("cpu", cuda):
        p, aux = fit.fit_core(model, {k: v.to(dev) for k, v in params.items()},
                              *(t.to(dev) for t in _fit_data(4100, torch.float64)),
                              torch.Generator().manual_seed(9), loss_fn=losses.mse, cfg=cfg)
        out[str(dev)] = (model.flatten(p).cpu(), aux["loss_history"].cpu(),
                         int(aux["n_epochs_ran"]))
    (pc, hc, nc), (pg, hg, ng) = out["cpu"], out["cuda"]
    assert nc == ng
    torch.testing.assert_close(pg, pc, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(hg, hc, rtol=1e-9, atol=0.0)


def test_fit_core_graph_equals_eager_on_card(cuda, monkeypatch):
    """One epoch captured as a CUDA graph and replayed gives the eager epochs'
    result (f32, at the north star's batch shape)."""
    model = HedgeMLP(n_features=1)
    params = model.init(torch.Generator().manual_seed(3), bias_init=(0.1, 0.0))
    feats, prices, y = (t.to(cuda) for t in _fit_data(1 << 16, torch.float32))
    cfg = fit.FitConfig(n_epochs=6, batch_size=1 << 14, patience=50, shuffle="blocks", lr=1e-3)
    out = []
    for graphs in (True, False):
        monkeypatch.setattr(fit, "CUDA_GRAPHS", graphs)
        p, aux = fit.fit_core(model, {k: v.to(cuda) for k, v in params.items()}, feats[:, :1],
                              prices, y, torch.Generator().manual_seed(1), loss_fn=losses.mse,
                              cfg=cfg)
        out.append((model.flatten(p), aux["loss_history"]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("mode", [dict(dual_mode="mse_only"),
                                  dict(dual_mode="shared", holdings_combine="py"),
                                  dict(dual_mode="separate", optimizer="gauss_newton",
                                       gn_quantile=False, gn_iters_first=4, gn_iters_warm=2)])
def test_adam_walk_on_card_matches_cpu(cuda, mode):
    """The Adam walk (and the hybrid) in float64 on the card and on the CPU, same
    inputs and orders: values, holdings and per-date params at rtol 1e-7, the
    same epochs on every date (the CPU walk is held to JAX's the same way,
    tests/test_torch_adam_walk.py)."""
    rng = np.random.default_rng(2)
    n, d = 1024, 4
    y = np.exp(np.cumsum(0.05 * rng.standard_normal((n, d + 1)), 1))
    y[:, 0] = 1.0
    feats = np.stack([y, 1.0 - 0.01 * rng.random((n, d + 1)), 0.01 + 1e-4 * rng.random((n, d + 1))],
                     -1)
    b = np.exp(0.03 * np.linspace(0, 1, d + 1))
    term = np.maximum(y[:, -1], 1.0)
    cfg = BackwardConfig(**mode, epochs_first=6, epochs_warm=4, patience_warm=2,
                         batch_size=256, shuffle=True, lr=2e-2)
    out = {}
    for dev in ("cpu", cuda):
        res = backward_induction(HedgeMLP(n_features=3, dtype=torch.float64),
                                 *(torch.as_tensor(a, dtype=torch.float64, device=dev)
                                   for a in (feats, y, b, term)), cfg, bias_init=(0.6, 0.4))
        out[str(dev)] = res
    c, g = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(g.epochs_ran, c.epochs_ran)
    for k in ("values", "phi", "psi"):
        np.testing.assert_allclose(getattr(g, k).cpu().numpy(), getattr(c, k).numpy(),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
    for k, v in c.params1_by_date.items():
        np.testing.assert_allclose(g.params1_by_date[k].cpu().numpy(), v.numpy(), rtol=1e-7,
                                   atol=1e-9, err_msg=k)


def test_exact_thinning_law_on_card(cuda):
    """``binomial_mode="exact"`` on the card (threefry-addressed by ``(seed,
    step, path index)``): the reference's multi-step law at 65,536 x 1,000
    steps; the last 16,384 paths drawn alone are the same paths of the whole
    run, bitwise."""
    kw = dict(PENSION, store_every=25, binomial_mode="exact", seed=1234)
    a = simulate_pension(torch.arange(1 << 16, device=cuda), TimeGrid(10.0, 1000), **kw)
    b = simulate_pension(torch.arange(3 << 14, 1 << 16, device=cuda), TimeGrid(10.0, 1000),
                         **kw)
    n_t = a["N"][:, -1].double()
    assert abs(float(n_t.mean()) - 8616) < 40 and abs(float(n_t.std()) - 132) < 30
    for k in a:
        assert torch.equal(a[k][3 << 14:], b[k]), k


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A 1-rank NCCL group over a ``FileStore`` and its paths mesh; the group
    is destroyed after the test."""
    import torch.distributed as dist

    from orp_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_walk_captures_its_all_reduce(nccl_mesh, monkeypatch):
    """The fused GN walk on a 1-rank NCCL mesh: each LM iteration captured with
    its ``all_reduce``, the date loop under ``no_host_sync``; host loop and
    fused bitwise the same walks without a mesh (a 1-rank sum is the identity)."""
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.train import backward
    from orp_tpu_torch.utils import measure

    monkeypatch.setattr(backward, "fused_loop_scope", measure.no_host_sync)
    sim = SimConfig(n_paths=1 << 14, T=1.0, dt=1 / 52, rebalance_every=1)
    for fused in (False, True):
        train = TrainConfig(dual_mode="separate", optimizer="gauss_newton", gn_iters_first=6,
                            gn_iters_warm=3, fused=fused)
        want = european_hedge(EuropeanConfig(), sim, train)
        got = european_hedge(EuropeanConfig(), sim, train, mesh=nccl_mesh)
        assert got.report.v0_cv == want.report.v0_cv and got.report.v0_acv == want.report.v0_acv
        assert torch.equal(got.backward.values, want.backward.values), fused


def test_one_rank_nccl_adam_walk_fused(nccl_mesh, monkeypatch):
    """Adam on a 1-rank NCCL mesh: each epoch captured with its per-step
    ``all_reduce`` (gradient and batch loss), the date loop under
    ``no_host_sync``; fused bitwise the mesh's host loop, and ``v0_cv`` within
    the reference's mesh band (``rtol=1e-5``) of the walk without a mesh (the
    mesh's batch loss sums weighted per-row terms, another rounding)."""
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.train import backward
    from orp_tpu_torch.utils import measure

    monkeypatch.setattr(backward, "fused_loop_scope", measure.no_host_sync)
    sim = SimConfig(n_paths=1 << 14, T=1.0, dt=1 / 52, rebalance_every=1)
    train = TrainConfig(dual_mode="separate", epochs_first=12, epochs_warm=6, batch_size=2048,
                        lr=1e-3, shuffle="blocks")
    want = european_hedge(EuropeanConfig(), sim, train)
    host = european_hedge(EuropeanConfig(), sim, train, mesh=nccl_mesh)
    fused = european_hedge(EuropeanConfig(), sim, dataclasses.replace(train, fused=True),
                           mesh=nccl_mesh)
    assert torch.equal(fused.backward.values, host.backward.values)
    np.testing.assert_allclose(host.report.v0_cv, want.report.v0_cv, rtol=1e-5)


def test_one_rank_nccl_sharded_engine_bitwise(nccl_mesh):
    """The engine on a 1-rank NCCL mesh serves the committed north-star policy
    bitwise the unsharded engine, 1 to 1,048,576 rows."""
    policy = load_bundle(NORTH_STAR_POLICY)
    whole, sharded = HedgeEngine(policy), HedgeEngine(policy, mesh=nccl_mesh)
    assert sharded.cache_info()["mesh_devices"] == 1
    rng = np.random.default_rng(5)
    for n in (1, 7, 33, 4096, 65537, 1 << 20):
        states = rng.uniform(0.7, 1.3, (n, 1)).astype(np.float32)
        prices = np.column_stack([states[:, 0], np.full(n, 0.97)]).astype(np.float32)
        for x, y in zip(whole.evaluate(3, states, prices), sharded.evaluate(3, states, prices)):
            np.testing.assert_array_equal(x, y)


def _walk_data(dev, n: int = 2048, d: int = 5, n_features: int = 3):
    """A small pension-like walk on ``dev``: features (Y, ~N/N0, ~lambda), prices Y."""
    rng = np.random.default_rng(4)
    y = np.exp(np.cumsum(0.05 * rng.standard_normal((n, d + 1)), 1))
    y[:, 0] = 1.0
    cols = [y, 1.0 - 0.01 * rng.random((n, d + 1)), 0.01 + 1e-4 * rng.random((n, d + 1))]
    feats = np.stack(cols[:n_features], -1)
    b = np.exp(0.03 * np.linspace(0, 1, d + 1))
    term = np.maximum(y[:, -1], 1.0)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (feats, y, b, term))


FUSED_MODES = [dict(optimizer="gauss_newton", dual_mode="mse_only", gn_iters_first=8,
                    gn_iters_warm=4),
               dict(optimizer="gauss_newton", dual_mode="separate", gn_iters_first=8,
                    gn_iters_warm=4, gn_block_rows=512),
               dict(optimizer="gauss_newton", dual_mode="shared", holdings_combine="py",
                    gn_iters_first=8, gn_iters_warm=4),
               dict(dual_mode="separate", epochs_first=8, epochs_warm=4, patience_warm=1,
                    batch_size=256, shuffle="blocks", lr=5e-2),
               dict(dual_mode="mse_only", epochs_first=8, epochs_warm=4, patience_warm=1,
                    batch_size=256, shuffle=True, lr=5e-2)]


def _bitwise(a, b):
    for k in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k, v in b.params1_by_date.items():
        assert torch.equal(a.params1_by_date[k], v), k
    np.testing.assert_array_equal(a.epochs_ran, b.epochs_ran)
    np.testing.assert_array_equal(a.train_loss, b.train_loss)


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_walk_equals_host_loop_on_card(cuda, mode):
    """The fused walk on the card (GN iterations and Adam epochs as replayed CUDA
    graphs, nothing read back between dates) is bitwise the host loop."""
    data = _walk_data(cuda)
    model = HedgeMLP(n_features=3)
    host = backward_induction(model, *data, BackwardConfig(**mode), bias_init=(0.6, 0.4))
    fused = backward_induction(model, *data, BackwardConfig(**mode, fused=True),
                               bias_init=(0.6, 0.4))
    _bitwise(fused, host)
    if mode.get("dual_mode") != "mse_only":
        np.testing.assert_array_equal(fused.quantile_epochs_ran, host.quantile_epochs_ran)


@pytest.mark.parametrize("mode", [FUSED_MODES[1], FUSED_MODES[3]])
def test_fused_date_loop_runs_under_sync_debug_error(cuda, mode, monkeypatch):
    """With ``utils/measure.no_host_sync`` as the fused walk's loop scope, every
    fused date body runs with ``set_sync_debug_mode("error")`` in force (a host
    sync there raises), and the mode is restored after the walk; the library's
    own scope leaves the mode alone."""
    from orp_tpu_torch.train import backward
    from orp_tpu_torch.utils.measure import no_host_sync

    seen = []
    body = backward._date_body

    def spy(*args, **kw):
        seen.append(torch.cuda.get_sync_debug_mode())
        return body(*args, **kw)

    monkeypatch.setattr(backward, "_date_body", spy)
    data = _walk_data(cuda)
    backward_induction(HedgeMLP(n_features=3), *data, BackwardConfig(**mode, fused=True),
                       bias_init=(0.6, 0.4))
    assert seen == [0] * 5
    seen.clear()
    monkeypatch.setattr(backward, "fused_loop_scope", no_host_sync)
    backward_induction(HedgeMLP(n_features=3), *data, BackwardConfig(**mode, fused=True),
                       bias_init=(0.6, 0.4))
    assert seen == [2] * 5  # "error", once per date
    assert torch.cuda.get_sync_debug_mode() == 0
    with pytest.raises(RuntimeError):
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.zeros(1, device=cuda).item()
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("kill_after", [0, 2])
def test_kill_and_resume_bitwise_on_card(cuda, kill_after, tmp_path):
    from orp_tpu_torch import guard

    data = _walk_data(cuda)
    model = HedgeMLP(n_features=3)
    mode = dict(FUSED_MODES[2])
    full = backward_induction(model, *data, BackwardConfig(**mode), bias_init=(0.6, 0.4))
    cfg = BackwardConfig(**mode, checkpoint_dir=str(tmp_path / "walk"))
    with guard.faults(guard.FaultPlan(kill_after_step=kill_after)):
        with pytest.raises(guard.WalkKilled):
            backward_induction(model, *data, cfg, bias_init=(0.6, 0.4))
    _bitwise(backward_induction(model, *data, cfg, bias_init=(0.6, 0.4)), full)


BASKET_CORR = np.full((5, 5), 0.3) + 0.7 * np.eye(5)


@pytest.mark.parametrize("store", [1, 4])
def test_basket_paths_on_card_match_cpu(cuda, store):
    """The basket's plain recurrence on the card against the CPU, both with the
    factor ``sde.basket_factor`` computes on the host: ``z @ chol.T`` at full
    f32 (TF32 off), ``rtol=3e-5``; no path kernel launches."""
    from orp_tpu_torch.sde import simulate_gbm_basket

    kw = dict(s0=[100.0] * 5, drift=[0.08] * 5, sigma=[0.1, 0.12, 0.15, 0.18, 0.2],
              corr=BASKET_CORR, seed=1235, store_every=store)
    before = (fused_gbm.gbm_log_fused.launches, fused_mf.heston_qe_fused.launches)
    got = simulate_gbm_basket(torch.arange(65_536, device=cuda), TimeGrid(1.0, 52), **kw)
    torch.cuda.synchronize()
    assert (fused_gbm.gbm_log_fused.launches, fused_mf.heston_qe_fused.launches) == before
    want = simulate_gbm_basket(torch.arange(65_536), TimeGrid(1.0, 52), **kw)
    assert got.shape == (65_536, 52 // store + 1, 5) and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=3e-5, atol=0.0)


@pytest.mark.parametrize("n_hedge_assets", [1, 5], ids=["basket", "assets"])
@pytest.mark.parametrize("n_rows", [1, 4097, 1_048_576])
def test_mixed_head_basket_shapes_match_plain(cuda, n_hedge_assets, n_rows):
    """K2's ``Runtime<8>`` instance at the basket heads (5 features, 2 or 6
    outputs): f32 against ``mixed_head_plain`` at ``rtol=1e-5, atol=1e-6``;
    bf16 bitwise against ``mixed_head_bf16_order``, the kernel's documented
    arithmetic (the plain version's bf16 matmul sums a dot in an order of its
    own, and a vector head's holdings are small differences of terms as large
    as its bond holding, so one hidden unit rounded apart moves them by many of
    their own spacings: its agreement is printed)."""
    model = HedgeMLP(n_features=5, n_hedge_assets=n_hedge_assets)
    p = _params(model, 52, 5, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    dates = torch.randint(0, 52, (n_rows,), device=cuda, generator=g, dtype=torch.int32)
    feats = 1.0 + 0.1 * torch.randn(n_rows, 5, device=cuda, generator=g)
    fn = megakernel.mixed_head_forward
    before = (fn.launches, fn.launches_bf16)
    got = fn(model, p, dates, feats)
    torch.cuda.synchronize()
    assert got.shape == (n_rows, n_hedge_assets + 1)
    torch.testing.assert_close(got, megakernel.mixed_head_plain(model, p, dates, feats),
                               rtol=1e-5, atol=1e-6)
    bf = model.with_dtype(torch.bfloat16)
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    fb = feats.to(torch.bfloat16)
    got = fn(bf, pb, dates, fb)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, megakernel.mixed_head_bf16_order(bf, pb, dates, fb))
    print(f"{model.layer_sizes} {n_rows} rows, vs mixed_head_plain: "
          f"{bf16_agreement(got, megakernel.mixed_head_plain(bf, pb, dates, fb))}")


@pytest.mark.parametrize("model", HEADS)
@pytest.mark.parametrize("n_rows", [33, 1_048_576])
def test_mixed_head_bf16_equals_documented_order(cuda, model, n_rows):
    """The bf16 kernel's compile-time instances (1 and 3 features) and its
    runtime one (hidden 16, 4, 8) bitwise ``mixed_head_bf16_order``: each dot
    the f32 sum of exact products in input order, rounded once."""
    bf = model.with_dtype(torch.bfloat16)
    p = {k: v.to(torch.bfloat16) for k, v in _params(model, 52, 3, cuda).items()}
    g = torch.Generator(device=cuda).manual_seed(4)
    dates = torch.randint(0, 52, (n_rows,), device=cuda, generator=g, dtype=torch.int32)
    feats = (1.0 + 0.1 * torch.randn(n_rows, model.n_features, device=cuda,
                                      generator=g)).to(torch.bfloat16)
    got = megakernel.mixed_head_forward(bf, p, dates, feats)
    torch.cuda.synchronize()
    assert torch.equal(got, megakernel.mixed_head_bf16_order(bf, p, dates, feats))


def test_engine_bf16_tier_equals_documented_order(cuda):
    """The north-star policy's bf16 tier through ``evaluate_mixed_async`` on its
    stored rows: bitwise ``serve_outputs`` of ``mixed_head_bf16_order`` under
    the policy's params cast to bf16."""
    policy = load_bundle(NORTH_STAR_POLICY)
    with np.load(NORTH_STAR_POLICY / "reference.npz") as z:
        dates, states, prices = z["dates"], z["states"], z["prices"]
    got = HedgeEngine(policy, precision="bf16").evaluate_mixed_async(
        dates, states, prices).result()
    m = policy.model.with_dtype(torch.bfloat16)
    p = {k: torch.as_tensor(v).to(cuda, torch.bfloat16)
         for k, v in policy.backward.params1_by_date.items()}
    raw = megakernel.mixed_head_bf16_order(
        m, p, torch.from_numpy(dates.astype(np.int64)).to(cuda),
        torch.from_numpy(states.astype(np.float32)).to(cuda).to(torch.bfloat16))
    want = megakernel.serve_outputs(m, raw, raw, torch.from_numpy(prices.astype(np.float32)).to(
        cuda), policy.cost_of_capital, dual_mode=policy.dual_mode,
        holdings_combine=policy.holdings_combine)
    for name, a, b in zip(("phi", "psi", "v"), got, want):
        np.testing.assert_array_equal(a, b.cpu().numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_european_greeks_on_card_match_cpu(cuda, kind):
    """The greeks' recurrence on the card against the CPU at 4,096 paths: in
    float64 every greek at ``rtol=1e-10`` (gamma too), in float32 the first
    order greeks at ``rtol=1e-5`` (the CPU port's band against the JAX package,
    ``tests/test_torch_greeks.py``)."""
    from orp_tpu_torch.risk import european_greeks

    cfg = dict(s0=100.0, k=100.0, r=0.08, sigma=0.15, T=1.0, kind=kind, n_steps=52, seed=77)
    for dtype, tol, names in ((torch.float64, 1e-10, None),
                              (torch.float32, 1e-5, ("price", "delta", "vega", "rho",
                                                     "theta"))):
        got = european_greeks(4096, **cfg, dtype=dtype).as_dict()
        want = european_greeks(4096, **cfg, dtype=dtype, device="cpu").as_dict()
        for name in names or got:
            np.testing.assert_allclose(got[name], want[name], rtol=tol, err_msg=name)


# the option-analytics pricers: chip_smoke.py [exotics]'s configurations at 4,096 paths
EXOTICS = {
    "asian": ("asian_call_qmc", (100.0, 100.0, 0.08, 0.15, 1.0), {}),
    "barrier": ("down_and_out_call_qmc", (100.0, 100.0, 90.0, 0.08, 0.25, 1.0),
                dict(n_monitor=13, seed=5)),
    "barrier-naive": ("down_and_out_call_qmc", (100.0, 100.0, 90.0, 0.08, 0.25, 1.0),
                      dict(n_monitor=13, bridge=False, seed=5)),
    "lookback": ("lookback_call_qmc", (100.0, 110.0, 0.08, 0.25, 1.0), dict(n_monitor=13, seed=5)),
    "floating": ("lookback_floating_qmc", (100.0, 0.08, 0.25, 1.0), dict(n_monitor=13, seed=5)),
}
SURFACES = {
    "flat": ("price_surface", (100.0, 0.08, 0.15, [80.0, 90.0, 95.0, 100.0, 105.0, 110.0, 120.0],
                               1.0), {}),
    "heston": ("heston_price_surface", (100.0, 0.08, [85.0, 95.0, 100.0, 105.0, 115.0], 1.0),
               dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6, seed=7)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(EXOTICS))
def test_exotic_pricer_on_card_matches_cpu(cuda, name, dtype):
    """Card vs CPU on the same indices: every float of the result within 1e-4
    relative in float32 (the scan's knots agree at ``rtol=3e-5``), 1e-10 in
    float64; no kernel launches."""
    from orp_tpu_torch import risk

    fn, args, kw = EXOTICS[name]
    before = (fused_gbm.gbm_log_fused.launches, fused_mf.heston_qe_fused.launches)
    got = getattr(risk, fn)(4096, *args, **kw, dtype=dtype)
    want = getattr(risk, fn)(4096, *args, **kw, dtype=dtype, device="cpu")
    assert (fused_gbm.gbm_log_fused.launches, fused_mf.heston_qe_fused.launches) == before
    assert set(got) == set(want)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=tol, atol=0.0, err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(SURFACES))
def test_surface_on_card_matches_cpu(cuda, name, dtype):
    """The surface on the card against the CPU: prices within 1e-4 of the
    largest node in float32 (``rtol=1e-10`` in float64), the NaN masks equal,
    the IVs within 3e-4 (float64 ``rtol=1e-10``); results on the card."""
    from orp_tpu_torch import risk

    fn, args, kw = SURFACES[name]
    kw = dict(kw, n_maturities=13, steps_per_maturity=4, dtype=dtype)
    got = getattr(risk, fn)(4096, *args, **kw)
    want = getattr(risk, fn)(4096, *args, **kw, device="cpu")
    assert got["prices"].device.type == "cuda" and got["iv"].device.type == "cuda"
    gp, wp = got["prices"].cpu().numpy(), want["prices"].numpy()
    gi, wi = got["iv"].cpu().numpy(), want["iv"].numpy()
    np.testing.assert_array_equal(np.isnan(gi), np.isnan(wi))
    if dtype == torch.float32:
        assert np.abs(gp - wp).max() < 1e-4 * np.abs(wp).max()
        np.testing.assert_allclose(gi, wi, rtol=0.0, atol=3e-4)
    else:
        np.testing.assert_allclose(gp, wp, rtol=1e-10, atol=0.0)
        np.testing.assert_allclose(gi, wi, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("heston", [False, True], ids=["gbm", "heston"])
def test_lsm_on_card_matches_cpu(cuda, heston):
    """The LSM walk on the card: float64 at ``rtol=1e-9`` of the CPU (the
    exercise decisions are the same away from roundoff ties), float32 within
    2 of the CPU run's standard errors (a tie can flip a path's decision)."""
    from orp_tpu_torch.train import bermudan_lsm, bermudan_lsm_heston

    if heston:
        call = lambda **kw: bermudan_lsm_heston(  # noqa: E731
            4096, 36.0, 40.0, 0.06, 1.0, v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6,
            n_exercise=25, seed=9, **kw)
    else:
        call = lambda **kw: bermudan_lsm(4096, 36.0, 40.0, 0.06, 0.2, 1.0, n_exercise=50,  # noqa: E731
                                         seed=9, **kw)
    got, want = call(dtype=torch.float64), call(dtype=torch.float64, device="cpu")
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-9, atol=1e-12, err_msg=key)
    got, want = call(), call(device="cpu")
    assert abs(got["price"] - want["price"]) < 2 * want["se"]
    np.testing.assert_allclose(got["european"], want["european"], rtol=1e-4)


def test_lookback_dims_overflow_raises_and_the_context_lives(cuda):
    """Too many bridge dims raise the ValueError before any device op (a
    gather past the direction table would be a device-side assert that
    poisons the context); the card keeps working afterwards."""
    from orp_tpu_torch.risk import lookback_call_qmc, lookback_floating_qmc

    with pytest.raises(ValueError, match="16384-dimension Sobol table"):
        lookback_call_qmc(64, 100.0, 110.0, 0.08, 0.25, 1.0, n_monitor=4096,
                          steps_per_monitor=4)
    with pytest.raises(ValueError, match="16384-dimension Sobol table"):
        lookback_floating_qmc(64, 100.0, 0.08, 0.25, 1.0, n_monitor=4096, steps_per_monitor=4,
                              indices=torch.arange(64, device=cuda))
    torch.cuda.synchronize()
    res = lookback_call_qmc(1024, 100.0, 110.0, 0.08, 0.25, 1.0, n_monitor=13)
    assert np.isfinite(res["price"]) and res["price"] > 0.0


def test_nan_debug_and_checked_on_card(cuda):
    from orp_tpu_torch.utils.debug import checked, nan_debug

    x = torch.tensor([1.0, -1.0], device=cuda)
    with nan_debug():
        torch.exp(x)
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
    err, out = checked(lambda t: torch.sqrt(t) * 2.0)(x)
    assert out.device.type == "cuda" and "aten.sqrt" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()


def test_obs_span_waits_for_the_card_and_refuses_under_capture(cuda):
    """An obs span's clock stops once the card's stream has finished its
    result (a result queued behind ~0.1 s of card time closes a span of at
    least that wall, with the stream drained); inside a CUDA-graph capture
    the wait raises, naming the span, instead of skipping."""
    from orp_tpu_torch import obs

    x = torch.ones(1 << 20, device=cuda)
    sink = obs.ListSink()
    with obs.active(sink=sink):
        torch.cuda._sleep(int(2e8))  # ~0.1 s of card time at the H100's clocks
        with obs.span("probe") as sp:
            sp.set_result({"y": (x * 2,), "n": 3})
        assert torch.cuda.current_stream().query()
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="'captured'.*CUDA-graph capture"):
            with torch.cuda.graph(graph):
                with obs.span("captured") as sp:
                    sp.set_result(x * 3)
    probe, captured = sink.events
    assert probe["ok"] is True and probe["dur_s"] >= 0.05
    assert captured["name"] == "captured" and captured["ok"] is False


# -- the single-host serve path on the card ------------------------------------

HOST_SIZES = [1, 2, 7, 8, 9, 100, 4096, 65_535, 65_536, 65_537, 1 << 20]


def _host_rows(n, n_features, seed):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.05 * rng.standard_normal((n, n_features))).astype(np.float32)


def test_host_path_bitwise_the_engine_at_every_bucket(cuda):
    """``ServeHost.submit_block`` (and per-request ``evaluate``) serve bitwise
    what the tenant's own ``HedgeEngine`` serves, at buckets 1 to 1,048,576:
    the per-date forward runs in fixed row tiles, so no row depends on the
    bucket it rode in; coalesced blocks too."""
    from orp_tpu_torch.serve import ServeHost

    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy, device=cuda)
    with ServeHost(max_live_engines=2,
                   batcher_kwargs={"mixed_dates": True, "coalesce_blocks": True,
                                   "max_batch": 1 << 20}) as host:
        host.add_tenant("ns", policy)
        for n in HOST_SIZES:
            states = _host_rows(n, 1, n)
            d = n % direct.n_dates
            want = direct.evaluate(d, states)
            got = host.submit_block("ns", d, states).result(timeout=120)
            assert np.array_equal(got.phi, want[0]) and np.array_equal(got.psi, want[1]), n
            assert np.array_equal(host.evaluate("ns", d, states[:3])[0], want[0][:3])
        states = _host_rows(5000, 1, 1)
        want = direct.evaluate(4, states)
        _t, batcher = host._claim_batcher("ns")
        host._release_claim(_t)
        with batcher._cv:  # three blocks queue, then ride one dispatch
            futs = [host.submit_block("ns", 4, states[a:b])
                    for a, b in ((0, 1), (1, 4000), (4000, 5000))]
        got = np.concatenate([f.result(timeout=120).phi for f in futs])
        assert np.array_equal(got, want[0])


def test_host_mixed_lane_launches_k2_and_warm_reactivation(cuda):
    """Single-row requests at many dates fuse into one K2 launch (bitwise the
    engine's own mixed-date dispatch of the same rows, within 1e-5 of the
    per-date lane); an evicted tenant re-activates from the warm tier with
    no build and its params at the same device address; the canary promotes
    the same bundle and rejects a corrupted one with the bits untouched."""
    from orp_tpu_torch.guard import FaultPlan, faults
    from orp_tpu_torch.serve import CanaryRejected, ServeHost
    from orp_tpu_torch.utils import cuda_build

    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy, device=cuda)
    n = 512
    states = _host_rows(n, 1, 3)
    dates = (np.arange(n) * 7) % direct.n_dates
    with ServeHost(max_live_engines=1, batcher_kwargs={"mixed_dates": True}) as host:
        host.add_tenant("ns", policy)
        host.add_tenant("other", policy)
        host.evaluate("ns", 0, states[:1])
        t, batcher = host._claim_batcher("ns")
        host._release_claim(t)
        before = megakernel.mixed_head_forward.launches
        with batcher._cv:
            futs = [host.submit("ns", int(dates[i]), states[i:i + 1]) for i in range(n)]
        got = np.concatenate([f.result(timeout=120)[0] for f in futs])
        torch.cuda.synchronize()
        assert megakernel.mixed_head_forward.launches == before + 1
        want = direct.evaluate_mixed_async(dates, states).result()[0]
        assert np.array_equal(got, want)
        per_date = megakernel.loop_of_buckets(direct, dates, states)[0]
        np.testing.assert_allclose(got, per_date, rtol=1e-5, atol=1e-6)
        ptr = t.engine._p1["w0"].data_ptr()
        packed = t.engine._mixed_params()[2].data_ptr()
        host.evaluate("other", 0, states[:1])  # evicts "ns" to the warm tier
        assert host.stats()["ns"]["tier"] == "warm"
        builds = dict(cuda_build.BUILD_STATS)
        again = host.evaluate("ns", 0, states[:64])
        eng = host._tenants["ns"].engine
        assert eng._p1["w0"].data_ptr() == ptr and eng._mixed_params()[2].data_ptr() == packed
        assert cuda_build.BUILD_STATS == builds
        assert np.array_equal(again[0], direct.evaluate(0, states[:64])[0])
        assert host.reload_tenant("ns")["swapped"]
        with faults(FaultPlan(corrupt_reload=1)), pytest.warns(UserWarning):
            with pytest.raises(CanaryRejected):
                host.reload_tenant("ns")
        assert np.array_equal(host.evaluate("ns", 0, states[:64])[0], again[0])


# -- the network and fleet plane on the card --------------------------------------


def _mixed_frames(address, dates, states, producers, client_cls):
    """Single-row frames at ``dates`` from ``producers`` threads, each its own
    client; the results in row order."""
    import threading

    out = [None] * len(dates)
    per = len(dates) // producers

    def producer(k):
        with client_cls(*address, window=per, timeout_s=60.0) as c:
            idx = range(k * per, (k + 1) * per)
            futs = [c.submit_block_async("ns", int(dates[i]), states[i:i + 1]) for i in idx]
            for i, f in zip(idx, futs):
                out[i] = f.result(timeout=60)

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


@pytest.mark.parametrize("n", [1, 65_536])
def test_gateway_loopback_bitwise_the_engine(cuda, n):
    """TCP v1 and v2 serve bitwise the tenant's own ``HedgeEngine`` on the card."""
    from orp_tpu_torch.serve import (GatewayClient, ResilientGatewayClient, ServeGateway,
                                     ServeHost)

    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy, device=cuda)
    states = _host_rows(n, 1, n + 3)
    want = direct.evaluate(5, states)
    with ServeHost(max_live_engines=1) as host:
        host.add_tenant("ns", policy)
        with ServeGateway(host, port=0) as gw:
            with GatewayClient(*gw.address, timeout_s=60.0) as v1, \
                    ResilientGatewayClient(*gw.address, timeout_s=60.0) as v2:
                for got in (v1.submit_block("ns", 5, states), v2.submit_block("ns", 5, states)):
                    assert np.array_equal(got.phi, want[0]) and np.array_equal(got.psi, want[1])


@pytest.mark.parametrize("n", [1, 65_536])
def test_ring_round_trip_bitwise_the_engine(cuda, n, tmp_path):
    from orp_tpu_torch.serve import ServeHost
    from orp_tpu_torch.serve.shm import RingClient, RingPair, RingServer

    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy, device=cuda)
    states = _host_rows(n, 1, n + 4)
    want = direct.evaluate(6, states)
    with ServeHost(max_live_engines=1) as host:
        host.add_tenant("ns", policy)
        pair = RingPair.create(tmp_path / "r.shm", req_capacity=8 << 20, rep_capacity=8 << 20)
        try:
            with RingServer(host, pair, default_tenant="ns"), \
                    RingClient(pair, timeout_s=60.0) as rc:
                got = rc.submit_block("ns", 6, states)
        finally:
            pair.unlink()
    assert np.array_equal(got.phi, want[0]) and np.array_equal(got.psi, want[1])


@pytest.mark.parametrize("lane", ["gateway", "ring"])
def test_gateway_and_ring_mixed_frames_ride_one_k2_launch(cuda, lane, tmp_path):
    """512 single-row frames at 52 dates fill one batch (``max_batch`` rows) of
    the mixed-date lane: one K2 launch, bitwise the engine's own mixed-date
    dispatch of the rows, within 1e-5 of the per-date lane."""
    from orp_tpu_torch.serve import ResilientGatewayClient, ServeGateway, ServeHost
    from orp_tpu_torch.serve.shm import RingClient, RingPair, RingServer

    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy, device=cuda)
    n = 512
    states = _host_rows(n, 1, 21)
    dates = (np.arange(n) * 7) % direct.n_dates
    kw = {"mixed_dates": True, "max_batch": n, "max_wait_us": 20e6}
    with ServeHost(max_live_engines=1, batcher_kwargs=kw) as host:
        host.add_tenant("ns", policy)
        t, _b = host._claim_batcher("ns")
        host._release_claim(t)
        before = megakernel.mixed_head_forward.launches
        if lane == "gateway":
            with ServeGateway(host, port=0, max_inflight_replies=n, reply_cache=n) as gw:
                out = _mixed_frames(gw.address, dates, states, 8, ResilientGatewayClient)
        else:
            pair = RingPair.create(tmp_path / "r.shm", req_capacity=1 << 20,
                                   rep_capacity=1 << 20)
            try:
                with RingServer(host, pair, default_tenant="ns"), \
                        RingClient(pair, window=n, timeout_s=60.0) as rc:
                    futs = [rc.submit_block_async("ns", int(dates[i]), states[i:i + 1])
                            for i in range(n)]
                    out = [f.result(timeout=60) for f in futs]
            finally:
                pair.unlink()
        torch.cuda.synchronize()
        assert megakernel.mixed_head_forward.launches == before + 1
    got = np.concatenate([r.phi for r in out])
    assert np.array_equal(got, direct.evaluate_mixed_async(dates, states).result()[0])
    np.testing.assert_allclose(got, loop_of_buckets(direct, dates, states)[0],
                               rtol=1e-5, atol=1e-6)


def test_gateway_kill_drill_on_the_card(cuda):
    from orp_tpu_torch.serve import bench

    rec = bench.gateway_drill(load_bundle(NORTH_STAR_POLICY), blocks=32, block_rows=1024,
                              kill_at_frame=10, seed=3, repeats=1, device=cuda)
    assert rec["rows_lost"] == 0 and rec["duplicate_serves"] == 0
    assert rec["replayed_bits_equal"] and rec["reconnects"] >= 1


def test_fleet_phase_on_the_card(cuda):
    from orp_tpu_torch.serve import bench

    rec = bench.fleet_phase(load_bundle(NORTH_STAR_POLICY), replica_counts=(1, 2), gateways=2,
                            tenants=3, blocks_per_tenant=4, block_rows=256, repeats=1,
                            device=cuda)
    assert all(lv["bitwise_equal"] and lv["routing_consistent"] for lv in rec["levels"])
    assert rec["kill_drill"]["rows_lost"] == 0 and rec["kill_drill"]["duplicate_serves"] == 0
    assert rec["coalesce"]["bitwise_equal"]


def test_gateway_ingest_phase_on_the_card(cuda):
    """The ingest lanes bitwise a direct evaluation, the ring against its
    pipelined-TCP twin under the phase's own gate."""
    from orp_tpu_torch.serve import bench

    rec = bench.ingest_phase(load_bundle(NORTH_STAR_POLICY), rows=8192, block_sizes=(64, 1024),
                             seed=0, repeats=3, device=cuda)
    assert rec["bitwise_equal_to_per_request"] and rec["device"].startswith("cuda")
    assert rec["kernel_builds"]["nvcc"] == 0


# -- the compile-and-perf plane: AOT sets, their fresh-process load, demotion,
# the degrade drill (chip_smoke.py [aot] and [degrade] at their full sizes)

AOT_TEST_BUCKETS = (8, 64, 1024, 65_536)


@pytest.fixture(scope="module")
def aot_bundle(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from orp_tpu_torch.aot import export_aot
    from orp_tpu_torch.serve import export_bundle

    d = tmp_path_factory.mktemp("aot") / "bundle"
    policy = export_bundle(load_bundle(NORTH_STAR_POLICY), d)
    for tier in ("f32", "bf16"):
        export_aot(d, policy, buckets=AOT_TEST_BUCKETS, precision=tier)
    return d


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_aot_replay_bitwise_the_eager_engine_at_every_bucket(cuda, aot_bundle, tier):
    policy = load_bundle(aot_bundle)
    aot = HedgeEngine(policy, precision=tier)
    eager = HedgeEngine(policy, precision=tier, use_aot=False)
    assert aot.cache_info()["aot_buckets"] == list(AOT_TEST_BUCKETS)
    rng = np.random.default_rng(4)
    for b in AOT_TEST_BUCKETS:
        states = (1.0 + 0.1 * rng.standard_normal((b - 1, 1))).astype(np.float32)
        prices = np.concatenate([states, np.full((b - 1, 1), 0.0108, np.float32)], 1)
        for date in (0, 25, 51):
            pend = aot.evaluate_async(date, states, prices)
            aot.evaluate(date, states[::-1].copy(), prices)  # the next replay of the graph
            for g, w in zip(pend.result(), eager.evaluate(date, states, prices)):
                assert np.array_equal(g, w)
    assert aot.cache_info()["aot_hits"] == 2 * 3 * len(AOT_TEST_BUCKETS)


def test_aot_fresh_process_on_an_empty_cache_runs_no_nvcc(cuda, aot_bundle, tmp_path):
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "ORP_TORCH_CACHE_DIR": str(tmp_path / "cache")}
    env.pop("ORP_TESTS_NO_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, str(root / "tools" / "torch_aot_child.py"), "serve",
                           "--bundle", str(aot_bundle), "--tiers", "f32,bf16",
                           "--dates", "0,51"], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["nvcc"] == 0 and out["first"]["nvcc"] == 0
    for t in out["tiers"].values():
        assert t["aot_buckets"] == list(AOT_TEST_BUCKETS) and t["mismatches"] == []
        assert t["aot_hits"] == t["requests"] == 2 * len(AOT_TEST_BUCKETS)
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "cache").glob("lib*.so")) == \
        ["libfused_mf", "libmixed_head"]


def test_aot_faults_demote_one_bucket_with_the_bits_unchanged(cuda, aot_bundle):
    import warnings

    from orp_tpu_torch.guard import FaultPlan, faults

    policy = load_bundle(aot_bundle)
    aot = HedgeEngine(policy)
    eager = HedgeEngine(policy, use_aot=False)
    states = np.ones((40, 1), np.float32)
    want = eager.evaluate(9, states)
    with faults(FaultPlan(fail={"serve/aot_dispatch": 3})), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            got = aot.evaluate(9, states)
            assert all(np.array_equal(g, w) for g, w in zip(got, want) if g is not None)
    info = aot.cache_info()
    assert info["aot_circuit_open"] == [64] and 64 not in info["aot_buckets"]
    assert sum("circuit opened" in str(w.message) for w in caught) == 1


def test_degrade_drill_from_the_aot_bundle(cuda, aot_bundle):
    from orp_tpu_torch.serve.bench import _degrade_drill

    drill = _degrade_drill(load_bundle(aot_bundle), degrade_at=4, n_requests=16,
                           survivors=None, mesh=None, seed=0)
    assert drill["failed_during_window"] == 0 and drill["replayed"] >= 1
    assert drill["post_recovery_bitwise_equal"] and drill["rebuild_xla_compiles"] == 0
    assert drill["aot_buckets"] == list(AOT_TEST_BUCKETS) and drill["mttr_ms"] > 0


def test_two_gloo_ranks_capture_their_shards_from_the_n2_set(cuda, tmp_path):
    """Two ``gloo`` ranks share the card: each loads the bundle's 2-rank set
    (a manifest one process wrote, no library) with 0 ``nvcc`` runs and 0
    capture fallbacks, captures one graph per bucket of its shard's forward,
    and serves every size bitwise the eager mesh engine and the unsharded
    one; the mesh path launches no kernel."""
    import importlib.util
    import pathlib

    from orp_tpu_torch.aot import export_aot
    from orp_tpu_torch.serve import export_bundle

    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
                                                  root / "tools" / "torch_mesh_ranks.py")
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    d = tmp_path / "bundle"
    policy = export_bundle(load_bundle(NORTH_STAR_POLICY), d)
    out = export_aot(d, policy, buckets=AOT_TEST_BUCKETS, meshes=(2,))
    [manifest] = out["topologies"].values()
    assert manifest["libraries"] == {} and manifest["topology"]["n_devices"] == 2
    sizes = [1, 7, 64, 1000, 65_536]
    res = ranks.launch(2, {"aot": {"bundle": str(d), "sizes": sizes}}, tmp_path / "ranks",
                       device="cuda", backend="gloo", timeout=600)
    for r in res:
        a = r["aot"]
        assert a["topology"].endswith("-n2") and "covered" in a["status"]
        assert a["nvcc"] == 0 and a["captures"] == len(AOT_TEST_BUCKETS)
        assert a["fallbacks"] == {"capture": 0, "set": 0}
        assert a["cache_info"]["aot_buckets"] == list(AOT_TEST_BUCKETS)
        assert a["cache_info"]["aot_hits"] == len(sizes)
        assert all(a["equal"].values()) and all(a["equal_eager_mesh"].values())
        assert all(v == 0 for v in r["kernel_launches"].values())


def test_aot_tenant_warm_re_activation_captures_no_graph(cuda, aot_bundle):
    from orp_tpu_torch.serve.host import ServeHost
    from orp_tpu_torch.utils import cuda_build

    eager = HedgeEngine(load_bundle(aot_bundle), use_aot=False)
    states = np.ones((900, 1), np.float32)
    want = eager.evaluate(25, states)
    with ServeHost(max_live_engines=1) as host:
        for name in ("a", "b"):
            host.add_tenant(name, str(aot_bundle))
        host.evaluate("a", 25, states)
        host.evaluate("b", 25, states)  # evicts "a" to warm
        assert host.stats()["a"]["live"] is False
        b0 = dict(cuda_build.BUILD_STATS)
        got = host.evaluate("a", 25, states)
        assert {k: cuda_build.BUILD_STATS[k] - b0[k] for k in ("nvcc", "captures")} == \
            {"nvcc": 0, "captures": 0}
        info = host._tenants["a"].engine.cache_info()
        assert info["aot_hits"] == 1 and info["aot_buckets"] == list(AOT_TEST_BUCKETS)
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)


# -- the closed loop, the compile audit and doctor_report on the card
# (chip_smoke.py [pilot] runs the full-width cycle)


def test_pilot_drill_on_the_card(cuda):
    """The reference's drill at its quick size on the card: verdicts reject,
    promote, promote; 0 rows lost; the kill-resumed policy bitwise."""
    import warnings

    from orp_tpu_torch.serve.bench import _pilot_phase

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pl = _pilot_phase(quick=True, seed=0)
    assert pl["chain"]["ok"] and pl["chain"]["verdicts"] == ["reject", "promote", "promote"]
    assert pl["rows_lost"] == 0 and pl["rows_served"] == pl["rows_submitted"] > 0
    assert pl["resume"]["bits_equal"] and pl["reject_left_incumbent"]


def test_compile_audit_counts_one_capture_a_bucket(cuda, aot_bundle):
    """``watch_serve_engine``: an engine on an AOT bundle captures exactly one
    graph a bucket, and serving every bucket afterwards captures none."""
    from orp_tpu_torch.lint import CompileAudit, CompileBudgetExceeded, watch_serve_engine

    audit = watch_serve_engine(CompileAudit(), budget=len(AOT_TEST_BUCKETS))
    with audit:
        engine = HedgeEngine(load_bundle(aot_bundle))
    assert audit.deltas() == {"serve_bucket": len(AOT_TEST_BUCKETS)}
    with watch_serve_engine(CompileAudit(), budget=0):
        for b in AOT_TEST_BUCKETS:
            engine.evaluate(3, np.ones((b, 1), np.float32))
    with pytest.raises(CompileBudgetExceeded, match="serve_bucket"):
        with watch_serve_engine(CompileAudit(), budget=len(AOT_TEST_BUCKETS) - 1):
            HedgeEngine(load_bundle(aot_bundle))


def test_compile_audit_fused_walk_captures_constant_in_dates(cuda):
    """The fused GN walk captures one LM iteration a leg whatever the date
    count (``watch_backward_walk``)."""
    from orp_tpu_torch.lint import CompileAudit, watch_backward_walk

    deltas = []
    for n_dates in (3, 6):
        s = fused_gbm.gbm_log_plain(4096, n_dates, s0=1.0, drift=0.08, sigma=0.15,
                                    dt=1.0 / n_dates, seed=1234, device=cuda).exp()
        b = torch.exp(0.08 * torch.linspace(0.0, 1.0, n_dates + 1, device=cuda))
        cfg = BackwardConfig(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=4,
                             gn_iters_warm=2, fused=True)
        audit = watch_backward_walk(CompileAudit())
        with audit:
            backward_induction(HedgeMLP(n_features=1), s[:, :, None], s, b,
                               torch.clamp(s[:, -1] - 1.0, min=0.0), cfg)
            torch.cuda.synchronize()
        deltas.append(audit.deltas())
    assert deltas[0] == deltas[1] and deltas[0]["gn_iteration"] == 1
    assert deltas[0]["walk_program"] == 1


def test_doctor_report_on_the_card(cuda, tmp_path):
    """On the card ``doctor_report`` is ok, names the card, and the H100's
    peak row covers it."""
    from orp_tpu_torch.obs import perf
    from orp_tpu_torch.serve.health import doctor_report

    led = tmp_path / "ledger.jsonl"
    perf.ledger_append(led, perf.make_record("u", "p", [1.0, 1.0, 1.0]))
    rep = doctor_report(NORTH_STAR_POLICY, perf=str(led), cache_dir=tmp_path / "cache")
    by = {c["check"]: c for c in rep["checks"]}
    assert rep["ok"], rep
    assert torch.cuda.get_device_name(0) in by["devices"]["detail"]
    assert "(gpu)" in by["devices"]["detail"]
    assert "PEAK_TABLE covers" in by["perf_peaks"]["detail"]


# -- the command line (orp_tpu_torch/cli.py) on the card ----------------------------

CLI_PATHS = 65_536
CLI_GN = ["--optimizer", "gauss_newton", "--gn-iters-first", "10", "--gn-iters-warm", "4",
          "--json"]


def _cli_lines(argv) -> list:
    import contextlib
    import io
    import json

    from orp_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def _path_launches() -> dict:
    return {"K1": fused_gbm.gbm_log_fused.launches, "K3b": fused_mf.heston_qe_fused.launches,
            "K3a": fused_mf.heston_log_fused.launches, "K3c": fused_mf.pension_fused.launches}


def _cli_hedge_api(case: str):
    """The configs the command builds, run through the port's API on the card."""
    from orp_tpu_torch import api

    gn = dict(optimizer="gauss_newton", gn_iters_first=10, gn_iters_warm=4)
    train = api.TrainConfig(dual_mode="mse_only", **gn)
    if case.startswith("euro"):
        every = 1 if case == "euro-dense" else 7
        return api.european_hedge(
            api.EuropeanConfig(constrain_self_financing=False),
            api.SimConfig(n_paths=CLI_PATHS, T=1.0, dt=1.0 / 364, rebalance_every=every,
                          engine="pallas"), train)
    if case.startswith("heston"):
        return api.heston_hedge(
            api.HestonConfig(scheme="euler" if case == "heston-euler" else None),
            api.SimConfig(n_paths=CLI_PATHS, T=1.0, dt=1.0 / 364, rebalance_every=7,
                          engine="pallas"), train)
    return api.pension_hedge(api.HedgeRunConfig(
        sim=api.SimConfig(n_paths=CLI_PATHS, T=10.0, dt=10.0 / 1000, rebalance_every=25,
                          engine="pallas", binomial_mode="normal"),
        train=api.TrainConfig(dual_mode="separate", **gn)))


# K1 (and K1 on a dense grid: 365 knots, where the reference chains _gbm_kernel_chunk
# calls), K3b, K3a, K3c
CLI_HEDGES = {
    "euro": (["euro", "--steps", "364", "--rebalance-every", "7", "--unconstrained"], "K1"),
    "euro-dense": (["euro", "--steps", "364", "--rebalance-every", "1", "--unconstrained"],
                   "K1"),
    "heston": (["heston", "--steps", "364", "--rebalance-every", "7"], "K3b"),
    "heston-euler": (["heston", "--steps", "364", "--rebalance-every", "7", "--scheme",
                      "euler"], "K3a"),
    "pension": (["pension", "--steps", "1000", "--rebalance-every", "25"], "K3c"),
}


@pytest.mark.parametrize("case", sorted(CLI_HEDGES))
def test_cli_hedge_launches_its_kernel_once_and_equals_the_api(cuda, case):
    """``<command> --engine pallas`` at 65,536 paths on the card: its kernel
    launches exactly once and no other path kernel does; the JSON line is
    bitwise the port's API on the same configs."""
    from orp_tpu_torch.cli import result_line

    argv, kernel = CLI_HEDGES[case]
    before = _path_launches()
    lines = _cli_lines([*argv, "--paths", str(CLI_PATHS), "--engine", "pallas", *CLI_GN])
    torch.cuda.synchronize()
    after = _path_launches()
    assert {k: after[k] - before[k] for k in after} == {k: int(k == kernel) for k in after}
    rep = _cli_hedge_api(case).report
    extra = None
    if case.startswith("heston"):
        oracle = lines[0]["oracle"]
        extra = {"oracle": oracle, "cv_err_bp": (rep.v0_cv - oracle) / oracle * 1e4}
    assert lines == [result_line(rep, extra=extra)]


def _cli_child(argv, env_extra=None, timeout=900):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root), **(env_extra or {})}
    env.pop("ORP_TESTS_NO_COMPILE_CACHE", None)
    r = subprocess.run([sys.executable, "-m", "orp_tpu_torch.cli", *argv], env=env,
                       cwd=str(root), capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_cli_export_aot_then_serve_bench_in_a_fresh_process_runs_no_nvcc(cuda, tmp_path):
    import json

    b = tmp_path / "bundle"
    line = _cli_lines(["export", "--pipeline", "euro", "--out", str(b), "--paths", "4096",
                       "--steps", "8", "--rebalance-every", "2", "--epochs-first", "20",
                       "--epochs-warm", "10", "--aot", "--json"])[0]
    assert line["aot_buckets"] == [8, 16, 32, 64, 128, 256, 512, 1024]
    assert len(line["aot_topologies"]) == 1
    out = tmp_path / "r.json"
    _cli_child(["serve-bench", "--bundle", str(b), "--quick", "--requests", "16",
                "--batcher-requests", "16", "--sweep-concurrency", "", "--out", str(out)],
               {"ORP_TORCH_CACHE_DIR": str(tmp_path / "empty-cache")})
    rec = json.loads(out.read_text())
    assert rec["nvcc_runs"] == 0 and rec["aot_hits"] > 0, rec


def test_cli_euro_mesh_one_rank_nccl_bitwise_no_mesh(cuda):
    """``euro --mesh 1`` forms a one-rank NCCL group in its process (the scan
    engine: a mesh refuses ``--engine pallas``) and prints the no-mesh line:
    every field bitwise but the standard deviations, which the mesh forms as
    the root of the shards' mean square deviation (``risk/controls.path_std``)
    where one device calls ``torch.std``: those at the mesh's ``rtol=1e-5``
    (PERF.md §2, PR 13; measured 9.8e-8 on ``cv_std``)."""
    import json

    argv = ["euro", "--paths", str(CLI_PATHS), "--steps", "364", "--rebalance-every", "7",
            "--unconstrained", *CLI_GN]
    plain = json.loads(_cli_child(argv))
    meshed = json.loads(_cli_child([*argv, "--mesh", "1"]))
    stds = {"cv_std", "acv_std", "residual_std"}
    assert set(meshed) == set(plain)
    assert {k: v for k, v in meshed.items() if k not in stds} == \
        {k: v for k, v in plain.items() if k not in stds}
    for k in stds:
        np.testing.assert_allclose(meshed[k], plain[k], rtol=1e-5, err_msg=k)


def test_cli_serve_bench_precision_reaches_k2_bf16(cuda, tmp_path):
    p = tmp_path / "p"
    _cli_lines(["export", "--pipeline", "euro", "--out", str(p), "--paths", "512", "--steps",
                "8", "--rebalance-every", "2", "--epochs-first", "20", "--epochs-warm", "10",
                "--json"])
    f32, bf16 = (megakernel.mixed_head_forward.launches,
                 megakernel.mixed_head_forward.launches_bf16)
    rec = _cli_lines(["serve-bench", "--bundle", str(p), "--quick", "--precision",
                      "--requests", "8", "--batcher-requests", "8", "--sweep-concurrency", "",
                      "--out", str(tmp_path / "r.json")])[-1]
    assert megakernel.mixed_head_forward.launches_bf16 > bf16
    assert megakernel.mixed_head_forward.launches > f32
    assert {lv["tier"] for lv in rec["precision_tiers"]["tiers"]} == {"f32", "bf16", "int8"}
