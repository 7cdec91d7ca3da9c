"""Port parity: the pension paths (``orp_tpu_torch/qmc/fused_mf.py`` and
``orp_tpu_torch/sde/kernels.py``) against ``pension_pallas`` in interpret mode
and ``simulate_pension``, at the sizes and tolerances of ``tests/test_pallas.py``:

- Y at ``rtol=3e-5``, lambda at ``rtol=3e-5, atol=3e-8`` and, with the SV
  fund, Y / v / lambda at ``rtol=3e-5, atol=3e-7`` (the Sobol stream is
  bitwise; f32 ``exp`` and accumulation differ at ulp level);
- the survivors N are integers: in ``normal`` mode equal on every knot; in
  ``inversion`` mode equal on >= 99.9% of knots and never more than one
  death apart (a one-ulp change of ``pmf(0)`` or of the uniform can move a
  CDF boundary; the kernel reads factor 3's raw uniform where the scan path
  round-trips ``ndtr(ndtri(u))``);
- ``binomial_inversion_deaths`` elementwise equal to JAX's, the CLT switch
  included (the same f32 operations in the same order);
- ``exact`` thinning, index-addressed as in the JAX package
  (``utils/threefry.py``): threefry's key words, splits and uniforms equal to
  ``jax.random``'s; the sampler's counts equal to ``jax.random.binomial``'s
  path for path in both regimes; a prefix of the paths and shards of them
  bitwise the whole run; the law: E[N_T] within 4 combined standard errors of
  JAX's own exact draws and sd within 10% at PARITY.md's 8,192 paths x
  monthly grid, where >= 99% of the knots' counts equal JAX's (measured
  99.86%: the rest follow one-ulp differences of lambda, which the two
  packages' f32 arithmetic leaves on ~35% of knots); at the single-step grid
  the mean within 4 standard errors and the variance within 3% of the
  binomial's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.special import ndtri

from orp_tpu.qmc.pallas_mf import pension_pallas
from orp_tpu.sde import TimeGrid as JTimeGrid
from orp_tpu.sde import simulate_pension as jsimulate_pension
from orp_tpu.sde.kernels import binomial_inversion_deaths as jbinomial_inversion_deaths
from orp_tpu_torch.api import HedgeRunConfig, SimConfig, StochVolConfig, TrainConfig, pension_hedge
from orp_tpu_torch.api.pipelines import _simulate_pension_paths
from orp_tpu_torch.qmc import pension_fused, pension_plain
from orp_tpu_torch.sde import TimeGrid, binomial_inversion_deaths, simulate_pension
from orp_tpu_torch.utils import threefry

KW = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0)
KW_SV = dict(y0=1.0, mu=0.0962, sigma=None, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0,
             sv=True, v0=0.16679, cir_a=0.00333, cir_b=0.15629, cir_c=0.01583)
N_PATHS, N_STEPS, STORE = 512, 40, 10
VARIANTS = [(mode, sv) for mode in ("normal", "inversion") for sv in (False, True)]


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_pension_close(got: dict, want: dict, mode: str) -> None:
    assert sorted(got) == sorted(want)
    tol = dict(rtol=3e-5, atol=3e-7) if "v" in want else dict(rtol=3e-5)
    np.testing.assert_allclose(got["Y"], want["Y"], **tol)
    np.testing.assert_allclose(got["lam"], want["lam"], rtol=3e-5,
                               atol=3e-7 if "v" in want else 3e-8)
    if "v" in want:
        np.testing.assert_allclose(got["v"], want["v"], **tol)
    if mode == "normal":
        np.testing.assert_array_equal(got["N"], want["N"])
    else:
        diff = got["N"] != want["N"]
        assert diff.mean() < 1e-3, diff.mean()
        assert np.abs(got["N"] - want["N"]).max() <= 1.0


def _kw(sv: bool) -> dict:
    return KW_SV if sv else KW


@pytest.mark.parametrize("mode, sv", VARIANTS)
def test_plain_matches_pallas_kernel(mode, sv):
    kw = dict(_kw(sv), dt=10.0 / N_STEPS, seed=1234, store_every=STORE, binomial_mode=mode)
    want = _np(pension_pallas(N_PATHS, N_STEPS, block_paths=256, interpret=True, **kw))
    got = pension_plain(N_PATHS, N_STEPS, **kw)
    for v in got.values():
        assert v.shape == (N_PATHS, N_STEPS // STORE + 1) and v.dtype == torch.float32
    assert_pension_close({k: v.numpy() for k, v in got.items()}, want, mode)


@pytest.mark.parametrize("mode, sv", VARIANTS)
def test_plain_matches_jax_scan(mode, sv):
    """The kernel's plain twin against JAX's ``simulate_pension``, as
    ``tests/test_pallas.py`` holds the Pallas kernel against it."""
    want = _np(jsimulate_pension(jnp.arange(N_PATHS, dtype=jnp.uint32),
                                 JTimeGrid(10.0, N_STEPS), seed=1234, store_every=STORE,
                                 binomial_mode=mode, dtype=jnp.float32, **_kw(sv)))
    got = pension_plain(N_PATHS, N_STEPS, dt=10.0 / N_STEPS, seed=1234, store_every=STORE,
                        binomial_mode=mode, **_kw(sv))
    assert_pension_close({k: v.numpy() for k, v in got.items()}, want, mode)


@pytest.mark.parametrize("mode, sv", VARIANTS)
def test_scan_matches_jax_scan(mode, sv):
    want = _np(jsimulate_pension(jnp.arange(N_PATHS, dtype=jnp.uint32),
                                 JTimeGrid(10.0, N_STEPS), seed=1234, store_every=STORE,
                                 binomial_mode=mode, dtype=jnp.float32, **_kw(sv)))
    got = simulate_pension(torch.arange(N_PATHS), TimeGrid(10.0, N_STEPS), seed=1234,
                           store_every=STORE, binomial_mode=mode, **_kw(sv))
    assert_pension_close({k: v.numpy() for k, v in got.items()}, want, mode)


def test_scan_in_float64_matches_jax():
    """The scan path in f64, where no rounding boundary is near: every output equal
    to JAX's at f64 tolerance and N bitwise, inversion mode."""
    want = _np(jsimulate_pension(jnp.arange(N_PATHS, dtype=jnp.uint32),
                                 JTimeGrid(10.0, N_STEPS), seed=7, store_every=STORE,
                                 binomial_mode="inversion", dtype=jnp.float64, **KW))
    got = simulate_pension(torch.arange(N_PATHS), TimeGrid(10.0, N_STEPS), seed=7,
                           store_every=STORE, binomial_mode="inversion", dtype=torch.float64,
                           **KW)
    for k in ("Y", "lam"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got["N"].numpy(), want["N"])


def test_binomial_inversion_deaths_matches_jax():
    """Random ``(u, n, q)`` whose mean death counts straddle the CLT switch at
    45, with ``pmf(0) = (1-q)^n`` and the CLT normal ``ndtri(u)``: equal elementwise."""
    rng = np.random.default_rng(3)
    m = 20_000
    u = rng.random(m).astype(np.float32)
    n = rng.integers(0, 10_001, m).astype(np.float32)
    q = np.exp(rng.uniform(np.log(1e-5), np.log(5e-2), m)).astype(np.float32)
    pmf0 = np.exp(n.astype(np.float64) * np.log1p(-q.astype(np.float64))).astype(np.float32)
    z = ndtri(u.astype(np.float64)).astype(np.float32)
    mean = n * q
    assert (mean > 45).mean() > 0.1 and (mean < 2).mean() > 0.1
    want = np.asarray(jbinomial_inversion_deaths(*(jnp.asarray(a) for a in (u, n, q, pmf0, z))))
    got = binomial_inversion_deaths(*(torch.from_numpy(a) for a in (u, n, q, pmf0, z)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and (got <= torch.from_numpy(n)).all()


def test_binomial_inversion_deaths_saturates_as_jax():
    """The samplers' own f32 inputs, ``q = 1 - exp(-lam dt)`` and ``pmf(0) =
    exp(-n lam dt)``, with half the uniforms within 1e-3 of 1: where the cdf
    plateaus below ``u`` both take all 128 trips (the stuck-cdf exit of the
    port's walk), and every count is equal elementwise."""
    rng = np.random.default_rng(5)
    m = 200_000
    n = rng.integers(0, 12_001, m).astype(np.float32)
    lam = rng.uniform(1e-4, 0.2, m).astype(np.float32)
    dt = rng.choice(np.array([0.001, 0.01, 0.1, 0.25], np.float32), m)
    q = (1.0 - np.exp(-lam * dt)).astype(np.float32)
    pmf0 = np.exp(-n * lam * dt).astype(np.float32)
    u = np.where(rng.random(m) < 0.5, 1.0 - 1e-3 * rng.random(m), rng.random(m))
    u = u.astype(np.float32)
    z = ndtri(u.astype(np.float64)).astype(np.float32)
    want = np.asarray(jbinomial_inversion_deaths(*(jnp.asarray(a) for a in (u, n, q, pmf0, z))))
    got = binomial_inversion_deaths(*(torch.from_numpy(a) for a in (u, n, q, pmf0, z)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 128).sum() > 1000


def test_pension_law_at_the_reference_grid():
    """The reference's multi-step pension (T=10, dt=0.01, 4,096 paths, inversion):
    E[N_T] near 8,616 and sd near 132 (``tests/test_golden.py``), E[Y_T] near e^0.8."""
    out = pension_plain(4096, 1000, dt=0.01, store_every=25, binomial_mode="inversion", **KW)
    n_t, y_t = out["N"][:, -1].double(), out["Y"][:, -1].double()
    assert out["N"].shape == (4096, 41)
    assert abs(float(n_t.mean()) - 8616) < 40 and abs(float(n_t.std()) - 132) < 30
    assert abs(float(y_t.mean()) - np.exp(0.8)) < 0.05


def test_fused_wrapper_on_cpu_is_the_plain_version():
    kw = dict(KW, dt=0.25, seed=3, store_every=2, binomial_mode="inversion")
    before = pension_fused.launches
    got, want = pension_fused(256, 8, device="cpu", **kw), pension_plain(256, 8, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert pension_fused.launches == before  # no kernel ran


@pytest.mark.parametrize("fn", [pension_fused, pension_plain])
def test_kernel_paths_refuse(fn):
    base = dict(dt=0.25, device="cpu")
    with pytest.raises(ValueError, match="engine='pallas' supports binomial_mode"):
        fn(64, 8, **KW, **base, binomial_mode="exact")
    with pytest.raises(ValueError, match="sigma is required"):
        fn(64, 8, **dict(KW, sigma=None), **base)
    with pytest.raises(ValueError, match="must divide"):
        fn(64, 10, **KW, **base, store_every=3)
    with pytest.raises(ValueError, match="direction table"):
        fn(64, 4097, **KW, **base)


def test_scan_and_pipelines_refuse_exact_and_missing_sigma():
    """``exact`` thinning (the JAX default) runs on the scan path and is refused
    on the fused kernel's engine with the JAX package's reason; a constant-vol
    fund without ``sigma`` is refused."""
    out = simulate_pension(torch.arange(8), TimeGrid(1.0, 4), **KW)  # the JAX default "exact"
    n = out["N"]
    assert torch.equal(n, torch.round(n)) and (n[:, 1:] <= n[:, :-1]).all() and n.min() > 9e3
    with pytest.raises(ValueError, match="sigma is required"):
        simulate_pension(torch.arange(8), TimeGrid(1.0, 4), binomial_mode="normal",
                         **dict(KW, sigma=None))
    train = TrainConfig(dual_mode="shared", holdings_combine="py", optimizer="gauss_newton",
                        gn_iters_first=4, gn_iters_warm=2)
    for engine in ("scan", "pallas"):
        sim = SimConfig(n_paths=64, T=1.0, dt=0.25, rebalance_every=2, engine=engine)
        cfg = HedgeRunConfig(sim=sim, train=train)
        if engine == "scan":
            res = pension_hedge(cfg, device="cpu")
            assert np.isfinite([res.v0, res.phi0, res.psi0]).all()
            continue
        with pytest.raises(ValueError, match="engine='pallas' supports binomial_mode "
                                             "'normal' or 'inversion'"):
            pension_hedge(cfg, device="cpu")


PARITY_GRID = dict(n_paths=8192, T=10.0, n_steps=120, store=12)  # PARITY.md: monthly
_PARITY_RUNS: dict = {}


def _parity_runs():
    """``(jax N, port N)`` at the parity config, exact thinning, computed once."""
    if not _PARITY_RUNS:
        g = PARITY_GRID
        _PARITY_RUNS["jax"] = np.asarray(jsimulate_pension(
            jnp.arange(g["n_paths"]), JTimeGrid(g["T"], g["n_steps"]), store_every=g["store"],
            binomial_mode="exact", dtype=jnp.float32, **KW)["N"], np.float64)
        _PARITY_RUNS["port"] = simulate_pension(
            torch.arange(g["n_paths"]), TimeGrid(g["T"], g["n_steps"]), store_every=g["store"],
            binomial_mode="exact", **KW)["N"].double().numpy()
    return _PARITY_RUNS["jax"], _PARITY_RUNS["port"]


def test_exact_law_matches_jax_at_the_parity_config():
    """PARITY.md's binomial row (8,192 paths, monthly grid, exact thinning):
    E[N_T] within 4 combined standard errors of the JAX package's own exact
    draws, and sd(N_T) within 10%."""
    want, got = (x[:, -1] for x in _parity_runs())
    se = np.sqrt(want.var() / want.size + got.var() / got.size)
    assert abs(got.mean() - want.mean()) < 4 * se, (got.mean(), want.mean(), se)
    assert abs(got.std() / want.std() - 1) < 0.10, (got.std(), want.std())
    assert abs(got.mean() - 8616) < 40 and abs(got.std() - 132) < 30


def test_exact_law_at_a_large_step_mean():
    """The single-step grid (10 years in one step, ~1,600 deaths a path): given
    each path's intensity, ``N ~ Binomial(n0, p)`` with ``p = exp(-lam dt)``, so
    E[N] = n0 E[p] and Var N = n0 E[p(1-p)] + n0^2 Var p; 65,536 paths, the mean
    within 4 standard errors and the variance within 3%."""
    out = simulate_pension(torch.arange(1 << 16), TimeGrid(10.0, 1), binomial_mode="exact",
                           **KW)
    n = out["N"][:, -1].double().numpy()
    p = np.exp(-out["lam"][:, -1].double().numpy() * 10.0)
    n0 = KW["n0"]
    mean, var = n0 * p.mean(), n0 * (p * (1 - p)).mean() + n0 ** 2 * p.var()
    assert abs(n.mean() - mean) < 4 * np.sqrt(var / n.size), (n.mean(), mean)
    assert abs(n.var() / var - 1) < 0.03, (n.var(), var)
    # thin_exact alone at a fixed p: the binomial's own moments
    from orp_tpu_torch.sde.kernels import thin_exact
    pop, pp = torch.full((1 << 16,), 1e4), torch.full((1 << 16,), 0.84)
    d = thin_exact(pop, pp, threefry.fold_in(threefry.seed_key(3), 1), torch.arange(1 << 16))
    d = d.double().numpy()
    assert abs(d.mean() - 8400) < 4 * np.sqrt(1344 / d.size) and abs(d.var() / 1344 - 1) < 0.03


def test_exact_draws_follow_the_seed():
    """Exact draws are a function of ``(seed, step, path index)``: the same seed
    gives the same survivors, another seed other ones; the other factors are
    untouched."""
    kw = dict(KW, store_every=2, binomial_mode="exact")
    a, b = (simulate_pension(torch.arange(512), TimeGrid(2.0, 8), seed=5, **kw) for _ in range(2))
    c = simulate_pension(torch.arange(512), TimeGrid(2.0, 8), seed=6, **kw)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    assert (a["N"] != c["N"]).float().mean() > 0.5
    inv = simulate_pension(torch.arange(512), TimeGrid(2.0, 8), seed=5,
                           **dict(kw, binomial_mode="inversion"))
    np.testing.assert_array_equal(a["lam"].numpy(), inv["lam"].numpy())
    np.testing.assert_array_equal(a["Y"].numpy(), inv["Y"].numpy())


def test_exact_counts_equal_jax_on_most_knots():
    """At the parity config the port's exact draws equal the JAX package's on
    >= 99% of the knots (the same keys and sampler; the rest sit where the two
    packages' f32 lambda parts by an ulp, which moves ``p``)."""
    want, got = _parity_runs()
    share = float((want == got).mean())
    print(f"exact thinning: {share:.4%} of knots equal to JAX's")
    assert share >= 0.99, share


@pytest.mark.parametrize("seed,t", [(1234, 1), (0, 7), (2 ** 40 + 5, 999)])
def test_threefry_words_equal_jax(seed, t):
    """``seed_key``, ``fold_in`` (a step, then each path index), the splits and
    the float64 uniform: the words of ``jax.random`` (``key_data``)."""
    key = jax.random.key(seed)
    assert tuple(np.asarray(jax.random.key_data(key))) == threefry.seed_key(seed)
    kt = jax.random.fold_in(key, t)
    mine_t = threefry.fold_in(threefry.seed_key(seed), t)
    assert tuple(np.asarray(jax.random.key_data(kt))) == mine_t
    idx = np.arange(0, 1 << 20, 4099, dtype=np.uint32)
    pk = jax.vmap(jax.random.fold_in, (None, 0))(kt, jnp.asarray(idx))
    k0, k1 = threefry.fold_in(mine_t, torch.as_tensor(idx.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(pk)),
                                  np.stack([k0.numpy(), k1.numpy()], 1))
    split = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, 3)))(pk))
    for j, (a, b) in enumerate(threefry._hash_lanes([(k0, k1)] * 3, (0, 1, 2))):
        np.testing.assert_array_equal(split[:, j], np.stack([a.numpy(), b.numpy()], 1))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(pk)
    np.testing.assert_array_equal(np.asarray(u), threefry.uniform64(k0, k1).numpy())


@pytest.mark.parametrize("regime", ["inversion", "btrs", "edges"])
def test_binomial_counts_equal_jax_path_for_path(regime):
    """Given the same counts, probabilities and keys, the sampler's counts are
    ``jax.random.binomial``'s (float64), path for path: inversion (``n q <=
    10``), BTRS, and the edges (no trials, ``p`` of 0 or 1 on either side of
    1/2, a NaN probability, a negative count)."""
    rng = np.random.default_rng({"inversion": 1, "btrs": 2, "edges": 3}[regime])
    n = 2048
    if regime == "inversion":
        count, prob = rng.integers(0, 10000, n).astype(float), rng.uniform(0.999, 1.0, n)
    elif regime == "btrs":
        count, prob = rng.integers(100, 10000, n).astype(float), rng.uniform(0.05, 0.95, n)
    else:
        count = rng.integers(0, 50, n).astype(float)
        prob = rng.choice([0.0, 1.0, 0.3, 0.7, 1e-9, 1 - 1e-9], n)
        count[:8], prob[8:16] = 0.0, np.nan
        count[16:24] = -3.0
    kt = jax.random.fold_in(jax.random.key(1234), 11)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(kt, jnp.arange(n, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(jax.random.binomial)(keys, jnp.asarray(count), jnp.asarray(prob)))
    k0, k1 = threefry.fold_in(threefry.fold_in(threefry.seed_key(1234), 11), torch.arange(n))
    got = threefry.binomial(k0, k1, torch.as_tensor(count), torch.as_tensor(prob)).numpy()
    np.testing.assert_array_equal(got, want)


def test_exact_prefix_and_shards_are_the_whole_run():
    """A path's deaths are a function of ``(seed, step, global index)``: the
    first 1,024 paths of a 4,096-path run are the 1,024-path run, and four
    shards of 1,024 indices, concatenated, are the whole run, bitwise."""
    grid = TimeGrid(10.0, 120)
    kw = dict(KW, store_every=12, binomial_mode="exact")
    whole = simulate_pension(torch.arange(4096), grid, **kw)
    prefix = simulate_pension(torch.arange(1024), grid, **kw)
    for k in whole:
        assert torch.equal(prefix[k], whole[k][:1024]), k
    shards = [simulate_pension(torch.arange(s, s + 1024), grid, **kw)["N"]
              for s in range(0, 4096, 1024)]
    assert torch.equal(torch.cat(shards), whole["N"])


@pytest.mark.parametrize("engine", ["pallas", "scan"])
@pytest.mark.parametrize("sv", [False, True])
def test_pipeline_sim_routes_engine_and_fund(engine, sv):
    sim = SimConfig(n_paths=128, T=2.0, dt=0.25, rebalance_every=4, engine=engine, seed=9,
                    binomial_mode="inversion")
    cfg = HedgeRunConfig(sim=sim, sv=StochVolConfig() if sv else None)
    got = _simulate_pension_paths(cfg, TimeGrid(2.0, 8), "t", torch.device("cpu"))
    kw = dict(KW, seed=9, store_every=4, binomial_mode="inversion")
    if sv:
        s = StochVolConfig()
        kw.update(sigma=None, sv=True, v0=s.v0, cir_a=s.a, cir_b=s.b, cir_c=s.c)
    if engine == "pallas":
        want = pension_plain(128, 8, dt=0.25, **kw)
    else:
        want = simulate_pension(torch.arange(128), TimeGrid(2.0, 8), **kw)
    assert sorted(got) == sorted(want) == sorted(["Y", "lam", "N"] + (["v"] if sv else []))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
