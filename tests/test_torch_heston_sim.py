"""Port parity: Heston paths (``orp_tpu_torch/qmc/fused_mf.py`` and
``orp_tpu_torch/sde/kernels.py``) against ``heston_log_pallas`` /
``heston_qe_pallas`` in interpret mode and ``simulate_heston_log`` /
``simulate_heston_qe``, at the sizes and tolerances of ``tests/test_pallas.py``:

- Euler: S and v at ``rtol=3e-5, atol=3e-6`` (the Sobol stream is bitwise;
  f32 accumulation differs at ulp level);
- QE-M: S at ``rtol=3e-5``, v at ``rtol=2e-3, atol=1e-6`` (the quadratic
  branch's inverse-normal tail moves v by up to ~1e-3 relative);
- QE-M's exponential branch, in law, on a Feller-violating config.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.qmc.pallas_mf import heston_log_pallas, heston_qe_pallas
from orp_tpu.sde import TimeGrid as JTimeGrid
from orp_tpu.sde import qe_mgf_argument as jqe_mgf_argument
from orp_tpu.sde import simulate_heston_log as jsimulate_heston_log
from orp_tpu.sde import simulate_heston_qe as jsimulate_heston_qe
from orp_tpu.sde.kernels import qe_step_constants as jqe_step_constants
from orp_tpu.utils.heston import heston_call as jheston_call
from orp_tpu_torch.api import HestonConfig, SimConfig, resolve_heston_scheme
from orp_tpu_torch.api.pipelines import _simulate_heston_paths
from orp_tpu_torch.qmc import (heston_log_fused, heston_log_plain, heston_qe_fused,
                               heston_qe_plain)
from orp_tpu_torch.sde import (TimeGrid, qe_mgf_argument, qe_step_constants,
                               simulate_heston_log, simulate_heston_qe)
from orp_tpu_torch.utils import heston_call, heston_put

KW = dict(s0=100.0, mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
FELLER_BAD = dict(s0=100.0, mu=0.05, v0=0.04, kappa=0.5, theta=0.04, xi=1.0, rho=-0.9)
EULER_TOL = dict(rtol=3e-5, atol=3e-6)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_qe(got, want):
    np.testing.assert_allclose(got["S"], want["S"], rtol=3e-5)
    np.testing.assert_allclose(got["v"], want["v"], rtol=2e-3, atol=1e-6)


def test_euler_plain_matches_pallas_kernel():
    n, steps, store = 512, 16, 4
    want = _np(heston_log_pallas(n, steps, dt=1.0 / steps, seed=1235, store_every=store,
                                 block_paths=256, interpret=True, **KW))
    got = heston_log_plain(n, steps, dt=1.0 / steps, seed=1235, store_every=store, **KW)
    for k in ("S", "v"):
        assert got[k].shape == (n, steps // store + 1) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], **EULER_TOL, err_msg=k)


def test_euler_scan_matches_jax_scan():
    n, steps, store = 512, 16, 4
    got = simulate_heston_log(torch.arange(n), TimeGrid(1.0, steps), seed=1235,
                              store_every=store, **KW)
    want = _np(jsimulate_heston_log(jnp.arange(n, dtype=jnp.uint32), JTimeGrid(1.0, steps),
                                    seed=1235, store_every=store, dtype=jnp.float32, **KW))
    for k in ("S", "v"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **EULER_TOL, err_msg=k)


@pytest.mark.parametrize("rho", [-0.6, 0.9])  # A <= 0 (corrected) and A > 0 (plain QE)
def test_qe_plain_matches_pallas_kernel(rho):
    n, steps, store = 2048, 16, 4
    kw = dict(KW, rho=rho)
    want = _np(heston_qe_pallas(n, steps, dt=1.0 / steps, seed=1235, store_every=store,
                                block_paths=512, interpret=True, **kw))
    got = heston_qe_plain(n, steps, dt=1.0 / steps, seed=1235, store_every=store, **kw)
    _assert_qe({k: v.numpy() for k, v in got.items()}, want)
    assert (qe_mgf_argument(1.5, 0.25, rho, 1.0 / steps) <= 0.0) == (rho < 0)


def test_qe_scan_matches_jax_scan():
    n, steps, store = 2048, 16, 4
    got = simulate_heston_qe(torch.arange(n), TimeGrid(1.0, steps), seed=1235,
                             store_every=store, **KW)
    want = _np(jsimulate_heston_qe(jnp.arange(n, dtype=jnp.uint32), JTimeGrid(1.0, steps),
                                   seed=1235, store_every=store, dtype=jnp.float32, **KW))
    _assert_qe({k: v.numpy() for k, v in got.items()}, want)


def test_qe_exponential_branch_in_law():
    """Feller-violating config: the mass-at-zero branch fires on most paths;
    the plain kernel twin and the JAX Pallas kernel agree in law (zero
    fraction within 0.005, mean terminal v and S at rtol 1e-4), as
    ``tests/test_pallas.py`` holds the two JAX engines."""
    n = 1 << 14
    want = _np(heston_qe_pallas(n, 26, dt=1.0 / 26, seed=11, store_every=26,
                                block_paths=1024, interpret=True, **FELLER_BAD))
    got = heston_qe_plain(n, 26, dt=1.0 / 26, seed=11, store_every=26, **FELLER_BAD)
    gv, wv = got["v"][:, -1].numpy(), want["v"][:, -1]
    frac_g, frac_w = (gv == 0.0).mean(), (wv == 0.0).mean()
    assert frac_g > 0.3 and frac_w > 0.3, (frac_g, frac_w)
    np.testing.assert_allclose(frac_g, frac_w, atol=0.005)
    np.testing.assert_allclose(gv.mean(), wv.mean(), rtol=1e-4)
    np.testing.assert_allclose(got["S"][:, -1].numpy().mean(), want["S"][:, -1].mean(),
                               rtol=1e-4)


@pytest.mark.parametrize("cfg", [KW, FELLER_BAD, dict(KW, rho=0.9)])
@pytest.mark.parametrize("dt", [1 / 364, 1 / 26])
def test_qe_step_constants_equal_jax_in_f64(cfg, dt):
    args = (cfg["kappa"], cfg["theta"], cfg["xi"], cfg["rho"], dt)
    got, want = qe_step_constants(*args), jqe_step_constants(*args)
    assert got == want  # the same host-f64 arithmetic, bit for bit
    assert qe_mgf_argument(cfg["kappa"], cfg["xi"], cfg["rho"], dt) == jqe_mgf_argument(
        cfg["kappa"], cfg["xi"], cfg["rho"], dt)


def test_fused_wrappers_on_cpu_are_the_plain_versions():
    kw = dict(KW, dt=1 / 8, seed=3, store_every=2)
    before = (heston_log_fused.launches, heston_qe_fused.launches)
    for fused, plain in ((heston_log_fused, heston_log_plain), (heston_qe_fused, heston_qe_plain)):
        got, want = fused(256, 8, device="cpu", **kw), plain(256, 8, **kw)
        for k in ("S", "v"):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert (heston_log_fused.launches, heston_qe_fused.launches) == before  # no kernel ran


@pytest.mark.parametrize("kwargs, match", [
    (dict(n_paths=64, n_steps=10, store_every=3), "must divide"),
    (dict(n_paths=64, n_steps=8193, store_every=1), "direction table"),
    (dict(n_paths=0, n_steps=8, store_every=1), "n_paths"),
])
def test_fused_wrappers_validate(kwargs, match):
    for fused in (heston_log_fused, heston_qe_fused):
        with pytest.raises(ValueError, match=match):
            fused(dt=0.1, device="cpu", **KW, **kwargs)


@pytest.mark.parametrize("engine", ["pallas", "scan"])
@pytest.mark.parametrize("scheme", [None, "euler"])
def test_pipeline_sim_routes_engine_and_scheme(engine, scheme):
    h = HestonConfig(scheme=scheme)
    sim = SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2, engine=engine)
    grid = TimeGrid(1.0, 8)
    got = _simulate_heston_paths(h, sim, grid, "t", torch.device("cpu"))
    kw = dict(s0=h.s0, mu=h.r, v0=h.v0, kappa=h.kappa, theta=h.theta, xi=h.xi, rho=h.rho,
              seed=sim.seed_fund, store_every=2)
    if engine == "pallas":
        want = (heston_qe_plain if scheme is None else heston_log_plain)(256, 8, dt=1 / 8, **kw)
    else:
        want = (simulate_heston_qe if scheme is None else simulate_heston_log)(
            torch.arange(256), grid, **kw)
    for k in ("S", "v"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert resolve_heston_scheme(None) == "qe"
    with pytest.raises(ValueError, match="unknown HestonConfig.scheme"):
        resolve_heston_scheme("milstein")


def test_heston_oracle_is_the_reference_copy():
    kw = dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
    assert heston_call(100.0, 100.0, 0.08, 1.0, **kw) == jheston_call(100.0, 100.0, 0.08, 1.0,
                                                                     **kw)
    put = heston_put(100.0, 110.0, 0.08, 1.0, **kw)
    call = heston_call(100.0, 110.0, 0.08, 1.0, **kw)
    assert math.isclose(call - put, 100.0 - 110.0 * math.exp(-0.08), rel_tol=1e-12)
