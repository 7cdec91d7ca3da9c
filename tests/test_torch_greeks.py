"""Port parity: the pathwise greeks (``orp_tpu_torch/risk/greeks.py``) and their
Black-Scholes oracle (``utils/black_scholes.bs_put`` / ``bs_greeks``) against
the JAX package, on the CPU.

Tolerances and why:
- the oracle: equal (the same host float64 arithmetic);
- every greek in float64 at ``rtol=1e-10`` (the same recurrence and tangent
  formulas, summed in another order; gamma, a CRN difference of two means, in
  float64 only);
- float32 at a band about three times the largest gap measured over the
  seeds 7, 77, 11 and 1234 (calls and puts; 4,096 paths x 13 steps, Heston
  2,048 x 26, basket 4,096 x 13): ``rtol=1e-6`` for the prices, deltas,
  vegas, rhos, the digital and the basket (largest 2.0e-7), ``rtol=1e-5`` for
  theta (2.8e-6); Heston's ``vega_v0`` / ``vega_theta`` at ``rtol=1e-3``
  (2.7e-4 / 1.0e-4) and ``vega_kappa`` / ``vega_xi`` at ``atol=1e-2`` (3.4e-5
  / 3.5e-3 absolute on values of 0.01-0.35 that are differences of large
  pathwise terms): the variance tangent passes ``1 / (2 sqrt(v))`` near the
  floor, which magnifies f32 roundoff.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.risk import greeks as jgreeks
from orp_tpu.utils import black_scholes as jbs
from orp_tpu_torch.risk import (basket_greeks, digital_greeks, european_greeks,
                                heston_greeks)
from orp_tpu_torch.risk import greeks as tgreeks
from orp_tpu_torch.sde import TimeGrid, simulate_gbm_log
from orp_tpu_torch.utils import black_scholes as tbs

CFG = dict(s0=100.0, k=100.0, r=0.08, sigma=0.15, T=1.0)
HESTON = dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
BASKET = dict(s0=[95.0, 100.0, 105.0], weights=[0.3, 0.4, 0.3], strike=100.0, r=0.05,
              sigma=[0.25, 0.2, 0.15],
              corr=[[1.0, 0.3, 0.1], [0.3, 1.0, 0.3], [0.1, 0.3, 1.0]], T=1.0, n_steps=13,
              seed=11)
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
F64 = dict(rtol=1e-10, atol=0.0)
F32 = dict(rtol=1e-6, atol=0.0)
EURO_F32 = {"price": F32, "delta": F32, "vega": F32, "rho": F32,
            "theta": dict(rtol=1e-5, atol=0.0)}
HESTON_F32 = {"price": F32, "delta": F32, "rho_rate": F32,
              "vega_v0": dict(rtol=1e-3, atol=0.0), "vega_theta": dict(rtol=1e-3, atol=0.0),
              "vega_kappa": dict(rtol=0.0, atol=1e-2), "vega_xi": dict(rtol=0.0, atol=1e-2)}


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("s0, k, r, sigma, T", [(100.0, 100.0, 0.08, 0.15, 1.0),
                                                (90.0, 110.0, 0.03, 0.3, 2.5)])
def test_black_scholes_oracle_equals_jax(kind, s0, k, r, sigma, T):
    """The oracle: equal to JAX's (the same host float64 arithmetic)."""
    assert tbs.bs_greeks(s0, k, r, sigma, T, kind) == jbs.bs_greeks(s0, k, r, sigma, T, kind)
    assert tbs.bs_put(s0, k, r, sigma, T) == jbs.bs_put(s0, k, r, sigma, T)
    assert tbs.bs_call(s0, k, r, sigma, T) == jbs.bs_call(s0, k, r, sigma, T)
    assert tbs._phi(0.37) == jbs._phi(0.37)
    with pytest.raises(ValueError, match="call' or 'put"):
        tbs.bs_greeks(s0, k, r, sigma, T, "straddle")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["call", "put"])
def test_european_greeks_match_jax(kind, dt):
    """European greeks: f64 at ``rtol=1e-10`` with gamma, f32 in the measured band
    without it; standard errors at ``rtol=1e-4``."""
    jd, td = DTYPES[dt]
    want = jgreeks.european_greeks(4096, **CFG, kind=kind, n_steps=13, seed=77, dtype=jd)
    got = european_greeks(4096, **CFG, kind=kind, n_steps=13, seed=77, dtype=td, device="cpu")
    assert (got.n_paths, got.n_steps) == (4096, 13)
    fields = list(want.as_dict()) if dt == "f64" else list(EURO_F32)
    for name in fields:
        tol = F64 if dt == "f64" else EURO_F32[name]
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), **tol, err_msg=name)
    assert set(got.se) == set(want.se) == {"price", "delta", "vega", "rho", "theta"}
    for name, se in got.se.items():
        np.testing.assert_allclose(se, want.se[name], rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["call", "put"])
def test_digital_greeks_match_jax(kind, dt):
    """Likelihood-ratio digital greeks: f64 at ``rtol=1e-10``, f32 at ``rtol=1e-6``."""
    jd, td = DTYPES[dt]
    want = jgreeks.digital_greeks(4096, **CFG, kind=kind, n_steps=13, seed=7, dtype=jd)
    got = digital_greeks(4096, **CFG, kind=kind, n_steps=13, seed=7, dtype=td, device="cpu")
    for name in ("price", "delta", "vega"):
        np.testing.assert_allclose(got[name], want[name], **(F64 if dt == "f64" else F32),
                                   err_msg=name)
        np.testing.assert_allclose(got["se"][name], want["se"][name], rtol=1e-4)
    assert (got["n_paths"], got["n_steps"]) == (4096, 13)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["call", "put"])
def test_heston_greeks_match_jax(kind, dt):
    """Heston's six sensitivities and the price: f64 at ``rtol=1e-10``, f32 in the
    measured bands (module docstring)."""
    jd, td = DTYPES[dt]
    want = jgreeks.heston_greeks(2048, 100.0, 100.0, 0.08, 1.0, **HESTON, kind=kind,
                                 n_steps=26, seed=77, dtype=jd)
    got = heston_greeks(2048, 100.0, 100.0, 0.08, 1.0, **HESTON, kind=kind, n_steps=26,
                        seed=77, dtype=td, device="cpu")
    for name, tol in HESTON_F32.items():
        np.testing.assert_allclose(got[name], want[name], **(F64 if dt == "f64" else tol),
                                   err_msg=name)
    assert set(got["se"]) == set(want["se"]) and (got["n_paths"], got["n_steps"]) == (2048, 26)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_basket_greeks_match_jax(dt):
    """Basket price, delta and vega vectors, rate rho: f64 at ``rtol=1e-10``, f32 at
    ``rtol=1e-6``."""
    jd, td = DTYPES[dt]
    want = jgreeks.basket_greeks(4096, **BASKET, dtype=jd)
    got = basket_greeks(4096, **BASKET, dtype=td, device="cpu")
    tol = F64 if dt == "f64" else F32
    for name in ("price", "rho_rate"):
        np.testing.assert_allclose(got[name], want[name], **tol, err_msg=name)
    for name in ("delta", "vega"):
        assert got[name].shape == (3,)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **tol,
                                   err_msg=name)
    np.testing.assert_allclose(got["se"]["price"], want["se"]["price"], rtol=1e-4)


def test_safe_sqrt_keeps_the_tangent_finite_at_the_floor():
    """The double ``where``: the primal is ``sqrt`` and the tangent 0, not
    inf/NaN, where the variance is floored, as the JAX package's."""
    x = torch.tensor([0.0, 0.0, 4.0, -1.0], dtype=torch.float64)
    val, tan = torch.func.jvp(tgreeks._safe_sqrt, (x,), (torch.ones_like(x),))
    jval = jgreeks._safe_sqrt(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(tan.numpy(), [0.0, 0.0, 0.25, 0.0])
    assert bool(torch.isfinite(tan).all())


def test_single_asset_basket_is_the_european_call():
    """A=1, w=[1]: the basket recurrence is the European one, so price, delta,
    vega and rho agree in float64 to roundoff."""
    basket = basket_greeks(2048, s0=[100.0], weights=[1.0], strike=100.0, r=0.08,
                           sigma=[0.15], corr=[[1.0]], T=1.0, n_steps=13, seed=77,
                           dtype=torch.float64, device="cpu")
    euro = european_greeks(2048, **CFG, n_steps=13, seed=77, dtype=torch.float64,
                           device="cpu")
    np.testing.assert_allclose(basket["price"], euro.price, rtol=1e-12)
    np.testing.assert_allclose(float(basket["delta"][0]), euro.delta, rtol=1e-12)
    np.testing.assert_allclose(float(basket["vega"][0]), euro.vega, rtol=1e-12)
    np.testing.assert_allclose(basket["rho_rate"], euro.rho, rtol=1e-12)


def test_greeks_price_is_the_pricing_engine_and_digitals_partition():
    """The greeks' primal is ``simulate_gbm_log``'s arithmetic; the digital call
    and put count every path with ``S_T != K`` once."""
    g = european_greeks(4096, **CFG, n_steps=13, seed=77, device="cpu")
    s = simulate_gbm_log(torch.arange(4096), TimeGrid(1.0, 13), 100.0, 0.08, 0.15, seed=77,
                         store_every=13)
    direct = math.exp(-0.08) * float(torch.clamp(s[:, -1] - 100.0, min=0.0).mean())
    np.testing.assert_allclose(g.price, direct, rtol=1e-6)
    call = digital_greeks(4096, **CFG, n_steps=13, seed=7, device="cpu")
    put = digital_greeks(4096, **CFG, kind="put", n_steps=13, seed=7, device="cpu")
    disc = math.exp(-0.08)
    assert call["price"] + put["price"] <= disc + 1e-7
    assert disc - (call["price"] + put["price"]) < 16 * disc / 4096


def test_refusals_match_jax():
    """The greeks' refusals carry JAX's messages."""
    for call, jcall, kw in (
            (european_greeks, jgreeks.european_greeks, dict(**CFG, kind="straddle")),
            (digital_greeks, jgreeks.digital_greeks, dict(**CFG, kind="x")),
            (heston_greeks, jgreeks.heston_greeks,
             dict(s0=100.0, k=100.0, r=0.08, T=1.0, **HESTON, kind="x")),
            (heston_greeks, jgreeks.heston_greeks,
             dict(s0=100.0, k=100.0, r=0.08, T=1.0, **{**HESTON, "rho": -1.2}))):
        with pytest.raises(ValueError) as got:
            call(128, **kw, device="cpu")
        with pytest.raises(ValueError) as want:
            jcall(128, **kw)
        assert str(got.value) == str(want.value)
