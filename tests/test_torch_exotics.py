"""Port parity: the option-analytics pricers (``orp_tpu_torch/risk/asian.py``,
``barrier.py``, ``lookback.py``, ``surface.py``) against the JAX package, on
the CPU, from the same Sobol indices and seeds.

Tolerances and why:
- the closed forms (geometric Asian, reflection barrier, Conze-Viswanathan,
  Goldman-Sosin-Gatto): ``rtol=1e-12`` (the same host float64 arithmetic),
  every degenerate and validation branch included;
- each QMC pricer's whole result dict (``se`` included) in float64 at
  ``rtol=1e-10``: the same recurrences on the same Sobol points, reduced in
  another order (measured <= 2.1e-14, the surface's IV 1.3e-12);
- float32 at the scan simulator's tolerance, ``rtol=3e-5``
  (``tests/test_torch_gbm.py::test_scan_simulator_matches_jax_scan``;
  measured <= 2.6e-6, the Asian's residual ``se``); the surface's float32
  IV at ``atol=3e-4`` with the NaN mask equal: a wing node's IV is its
  price's roundoff over a vega near 0 (measured <= 6.1e-5 over the seeds 3,
  7, 11, 21, flat and Heston);
- ``implied_vol`` on exact Black-Scholes prices, float64 ``rtol=1e-10``, the
  NaN mask equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orp_tpu.risk import asian as jasian
from orp_tpu.risk import barrier as jbarrier
from orp_tpu.risk import lookback as jlookback
from orp_tpu.risk import surface as jsurface
from orp_tpu.utils.black_scholes import bs_greeks
from orp_tpu_torch.risk import (asian_call_qmc, down_and_out_call, down_and_out_call_qmc,
                                geometric_asian_call, heston_price_surface, implied_vol,
                                lookback_call_fixed, lookback_call_floating,
                                lookback_call_qmc, lookback_floating_qmc, price_surface)

N = 4096
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
RTOL = {"f64": 1e-10, "f32": 3e-5}
CLOSED = dict(rtol=1e-12, atol=0.0)
HESTON = dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)

# (port pricer, JAX pricer, positional args, keyword args)
PRICERS = {
    "asian": (asian_call_qmc, jasian.asian_call_qmc, (100.0, 100.0, 0.08, 0.15, 1.0),
              dict(n_avg=12, steps_per_avg=3, seed=5)),
    "asian-default-grid": (asian_call_qmc, jasian.asian_call_qmc,
                           (100.0, 95.0, 0.05, 0.25, 2.0), dict(seed=11)),
    "barrier": (down_and_out_call_qmc, jbarrier.down_and_out_call_qmc,
                (100.0, 100.0, 90.0, 0.08, 0.25, 1.0), dict(n_monitor=13, seed=5)),
    "barrier-naive": (down_and_out_call_qmc, jbarrier.down_and_out_call_qmc,
                      (100.0, 100.0, 90.0, 0.08, 0.25, 1.0),
                      dict(n_monitor=13, bridge=False, seed=5)),
    "barrier-substeps": (down_and_out_call_qmc, jbarrier.down_and_out_call_qmc,
                         (100.0, 105.0, 95.0, 0.03, 0.3, 0.5),
                         dict(n_monitor=8, steps_per_monitor=3, seed=3)),
    "lookback": (lookback_call_qmc, jlookback.lookback_call_qmc,
                 (100.0, 110.0, 0.08, 0.25, 1.0), dict(n_monitor=13, seed=5)),
    "lookback-naive": (lookback_call_qmc, jlookback.lookback_call_qmc,
                       (100.0, 110.0, 0.08, 0.25, 1.0), dict(n_monitor=13, bridge=False, seed=5)),
    "lookback-itm": (lookback_call_qmc, jlookback.lookback_call_qmc,
                     (100.0, 90.0, 0.08, 0.25, 1.0),
                     dict(n_monitor=6, steps_per_monitor=4, seed=3)),
    "floating": (lookback_floating_qmc, jlookback.lookback_floating_qmc,
                 (100.0, 0.08, 0.25, 1.0), dict(n_monitor=13, seed=5)),
    "floating-naive": (lookback_floating_qmc, jlookback.lookback_floating_qmc,
                       (100.0, 0.08, 0.25, 1.0), dict(n_monitor=13, bridge=False, seed=5)),
}
SURFACES = {
    "flat": (price_surface, jsurface.price_surface, (100.0, 0.08, 0.15),
             dict(strikes=[80.0, 90.0, 100.0, 110.0, 120.0], T=1.0, n_maturities=13,
                  steps_per_maturity=4, seed=21)),
    "flat-put": (price_surface, jsurface.price_surface, (100.0, 0.05, 0.2),
                 dict(strikes=[95.0, 105.0], T=1.0, n_maturities=4, steps_per_maturity=13,
                      seed=17, kind="put")),
    "heston-qe": (heston_price_surface, jsurface.heston_price_surface, (100.0, 0.08),
                  dict(strikes=[85.0, 95.0, 100.0, 105.0, 115.0], T=1.0, n_maturities=13,
                       steps_per_maturity=4, seed=7, **HESTON)),
    "heston-euler": (heston_price_surface, jsurface.heston_price_surface, (100.0, 0.08),
                     dict(strikes=[90.0, 100.0, 110.0], T=0.5, n_maturities=6,
                          steps_per_maturity=3, seed=3, scheme="euler", **HESTON)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(PRICERS))
def test_pricer_matches_jax(name, dt):
    """The whole result dict: f64 ``rtol=1e-10``, f32 ``rtol=3e-5``; the
    integer fields equal."""
    port, ref, args, kw = PRICERS[name]
    jd, td = DTYPES[dt]
    want = ref(N, *args, **kw, dtype=jd)
    got = port(N, *args, **kw, dtype=td, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert isinstance(got[key], type(w)), key
        np.testing.assert_allclose(got[key], w, rtol=RTOL[dt], atol=0.0, err_msg=key)
    assert got["n_paths"] == N


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(SURFACES))
def test_surface_matches_jax(name, dt):
    """times, strikes and prices at f64 ``rtol=1e-10`` / f32 ``rtol=3e-5``;
    the IV at f64 ``rtol=1e-10`` / f32 ``atol=3e-4``, the NaN mask equal."""
    port, ref, args, kw = SURFACES[name]
    jd, td = DTYPES[dt]
    want = ref(N, *args, **kw, dtype=jd)
    got = port(N, *args, **kw, dtype=td, device="cpu")
    assert set(got) == set(want) == {"times", "strikes", "prices", "iv"}
    for key in ("times", "strikes", "prices"):
        assert got[key].dtype == td and got[key].device.type == "cpu"
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL[dt],
                                   atol=0.0, err_msg=key)
    iv, want_iv = got["iv"].numpy(), np.asarray(want["iv"])
    np.testing.assert_array_equal(np.isnan(iv), np.isnan(want_iv))
    tol = dict(rtol=1e-10, atol=0.0) if dt == "f64" else dict(rtol=0.0, atol=3e-4)
    np.testing.assert_allclose(iv, want_iv, **tol)


def test_surface_without_iv_and_kind_validation():
    """``with_iv=False`` drops the key; an unknown kind raises JAX's words
    before any device is resolved (so without a card too)."""
    got = price_surface(256, 100.0, 0.05, 0.2, [100.0], 1.0, n_maturities=2,
                        steps_per_maturity=2, with_iv=False, device="cpu")
    assert set(got) == {"times", "strikes", "prices"}
    for port, ref, kw in ((price_surface, jsurface.price_surface, dict(sigma=0.2)),
                          (heston_price_surface, jsurface.heston_price_surface,
                           dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.3, rho=-0.5))):
        with pytest.raises(ValueError) as want:
            ref(128, 100.0, 0.05, strikes=[100.0], T=1.0, kind="digital", **kw)
        with pytest.raises(ValueError) as got:
            port(128, 100.0, 0.05, strikes=[100.0], T=1.0, kind="digital", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown Heston scheme"):
        heston_price_surface(64, 100.0, 0.05, [100.0], 1.0, v0=0.04, kappa=1.5, theta=0.04,
                             xi=0.3, rho=-0.5, scheme="milstein", device="cpu")


@pytest.mark.parametrize("kind", ["call", "put"])
def test_implied_vol_matches_jax(kind):
    """Exact BS prices (float64) inverted by both Newtons: ``rtol=1e-10``, and
    both recover sigma; prices outside the band are NaN in both."""
    strikes, times = np.array([70.0, 100.0, 130.0]), np.array([0.25, 1.0, 2.0])
    prices = np.array([[bs_greeks(100.0, k, 0.03, 0.22, t, kind=kind)["price"]
                        for k in strikes] for t in times])
    prices[0, 0], prices[2, 2] = 0.0, 250.0  # below the floor / above the bound
    want = np.asarray(jsurface.implied_vol(jnp.asarray(prices), 100.0, jnp.asarray(strikes),
                                           jnp.asarray(times), 0.03, kind=kind))
    got = implied_vol(torch.tensor(prices), 100.0, torch.tensor(strikes), torch.tensor(times),
                      0.03, kind=kind)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).sum() == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0.0)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[ok], 0.22, atol=1e-5)


@pytest.mark.parametrize("n_avg", [1, 4, 12, 52])
@pytest.mark.parametrize("sigma", [0.15, 0.0])
def test_geometric_asian_closed_form_equals_jax(n_avg, sigma):
    """``rtol=1e-12``, the sigma=0 intrinsic branch included."""
    for k in (90.0, 100.0, 130.0):
        args = (100.0, k, 0.08, sigma, 1.0, n_avg)
        np.testing.assert_allclose(geometric_asian_call(*args),
                                   jasian.geometric_asian_call(*args), **CLOSED)


@pytest.mark.parametrize("args", [
    (100.0, 100.0, 90.0, 0.08, 0.25, 1.0),    # the reflection formula
    (100.0, 110.0, 70.0, 0.03, 0.4, 2.0),
    (100.0, 100.0, 100.0, 0.08, 0.25, 1.0),   # h >= s0: knocked out
    (100.0, 100.0, 0.0, 0.08, 0.25, 1.0),     # h <= 0: the vanilla
    (100.0, 100.0, 90.0, 0.08, 0.0, 1.0),     # sigma = 0, clears the barrier
    (100.0, 100.0, 95.0, -0.08, 0.0, 1.0),    # sigma = 0, decays into it
])
def test_barrier_closed_form_equals_jax(args):
    """``rtol=1e-12`` on every branch."""
    np.testing.assert_allclose(down_and_out_call(*args), jbarrier.down_and_out_call(*args),
                               **CLOSED)


def test_barrier_refusal_and_early_returns_equal_jax():
    """``h > k`` raises in JAX's words; the knocked-out and sigma=0 QMC calls
    return JAX's dict without a simulation (so without a card too)."""
    with pytest.raises(ValueError) as want:
        jbarrier.down_and_out_call(100.0, 90.0, 95.0, 0.08, 0.25, 1.0)
    with pytest.raises(ValueError) as got:
        down_and_out_call(100.0, 90.0, 95.0, 0.08, 0.25, 1.0)
    assert str(got.value) == str(want.value)
    for args in ((128, 100.0, 100.0, 105.0, 0.08, 0.25, 1.0),
                 (128, 100.0, 100.0, 90.0, 0.08, 0.0, 1.0),
                 (128, 100.0, 100.0, 95.0, -0.08, 0.0, 1.0)):
        assert down_and_out_call_qmc(*args) == jbarrier.down_and_out_call_qmc(*args)


@pytest.mark.parametrize("args", [
    (100.0, 110.0, 0.08, 0.25, 1.0),
    (100.0, 90.0, 0.08, 0.25, 1.0),           # k < s0: the decomposition
    (100.0, 100.0, 0.03, 0.4, 2.0),
    (100.0, 120.0, 0.05, 0.0, 1.0),           # sigma = 0
    (100.0, 210.0, 0.05, 0.01, 1.0),          # the reflect term underflows
    (100.0, 150.0, 0.05, 0.01, 1.0),
])
def test_lookback_fixed_closed_form_equals_jax(args):
    """``rtol=1e-12`` on every branch."""
    np.testing.assert_allclose(lookback_call_fixed(*args), jlookback.lookback_call_fixed(*args),
                               **CLOSED)


@pytest.mark.parametrize("args", [(100.0, 0.08, 0.25, 1.0), (100.0, 0.03, 0.4, 2.0),
                                  (100.0, 0.05, 0.0, 1.0)])
def test_lookback_floating_closed_form_equals_jax(args):
    """``rtol=1e-12``, the sigma=0 branch included."""
    np.testing.assert_allclose(lookback_call_floating(*args),
                               jlookback.lookback_call_floating(*args), **CLOSED)


def test_lookback_closed_forms_refuse_in_jax_words():
    for port, ref, args in ((lookback_call_fixed, jlookback.lookback_call_fixed,
                             (100.0, 110.0, 0.0, 0.25, 1.0)),
                            (lookback_call_floating, jlookback.lookback_call_floating,
                             (100.0, 0.0, 0.25, 1.0))):
        with pytest.raises(ValueError) as want:
            ref(*args)
        with pytest.raises(ValueError) as got:
            port(*args)
        assert str(got.value) == str(want.value)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pricer", [lookback_call_qmc, lookback_floating_qmc])
def test_lookback_dims_overflow_raises_before_any_tensor_op(pricer):
    """n_steps + n_monitor past the 16,384-dimension table: the ValueError of
    JAX's words, raised before any tensor op (a CUDA gather past the table is
    a device-side assert) and before a device is resolved."""
    args = (100.0, 110.0, 0.08, 0.25, 1.0) if pricer is lookback_call_qmc else \
        (100.0, 0.08, 0.25, 1.0)
    jpricer = getattr(jlookback, pricer.__name__)
    kw = dict(n_monitor=4096, steps_per_monitor=4)
    with pytest.raises(ValueError) as want:
        jpricer(8, *args, **kw)
    idx = torch.arange(8)
    with _OpCount() as count, pytest.raises(ValueError) as got:
        pricer(8, *args, **kw, indices=idx)
    assert str(got.value) == str(want.value)
    assert "16384-dimension Sobol table" in str(got.value)
    assert count.ops == []
    with pytest.raises(ValueError, match="16384-dimension"):
        pricer(8, *args, **kw)  # no device given: still the ValueError


def test_indices_tensor_keeps_its_device():
    """An ``indices`` tensor decides the device (here the CPU, with no
    ``device=``); a prefix of the indices is a prefix of the paths."""
    got = asian_call_qmc(64, 100.0, 100.0, 0.08, 0.15, 1.0, n_avg=4, steps_per_avg=2,
                         indices=torch.arange(64), dtype=torch.float64)
    want = asian_call_qmc(64, 100.0, 100.0, 0.08, 0.15, 1.0, n_avg=4, steps_per_avg=2,
                          dtype=torch.float64, device="cpu")
    assert got == want
    half = lookback_call_qmc(32, 100.0, 110.0, 0.08, 0.25, 1.0, n_monitor=4,
                             indices=np.arange(32, 64), device="cpu")
    assert half["n_paths"] == 32
