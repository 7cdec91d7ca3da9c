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
- ``exact`` thinning on the scan path and its refusal on the kernel's
  engine; the index-addressed sampler's parity with the JAX package is
  ``tests/test_torch_exact_thinning.py``.
"""

import numpy as np
import pytest

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

KW = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0)
KW_SV = dict(y0=1.0, mu=0.0962, sigma=None, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0,
             sv=True, v0=0.16679, cir_a=0.00333, cir_b=0.15629, cir_c=0.01583)
N_PATHS, N_STEPS, STORE = 512, 40, 10
VARIANTS = [(mode, sv) for mode in ("normal", "inversion") for sv in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: their tensors are a few
    thousand rows, and under the suite's parallel workers every worker's
    default pool (one thread a core) oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
