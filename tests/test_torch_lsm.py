"""Port parity: the Bermudan LSM pricers (``orp_tpu_torch/train/lsm.py``) and
their CRR oracle (``orp_tpu_torch/utils/crr.py``) against the JAX package,
on the CPU.

Tolerances and why:
- ``crr_price``: ``rtol=1e-12`` (the same host NumPy float64 loop), every
  exercise style and both kinds, the refusals in JAX's words;
- one exercise date's regression (``beta``, the continuation value, the
  exercise mask) in float64 at ``rtol=1e-9`` from the same inputs. JAX's
  per-date step is a closure of its jitted walk, so the test holds the port
  to a jnp transcription of it, and the transcription to JAX's own
  ``_lsm_walk`` over a two-date walk (one regression date) at ``rtol=1e-12``;
- the walk and the whole ``bermudan_lsm`` / ``bermudan_lsm_heston`` result
  in float64 at ``rtol=1e-9`` (measured <= 1.3e-14); float32 at the scan
  simulator's ``rtol=3e-5`` (measured <= 1.4e-7: no exercise decision flips
  at these seeds).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu.train import lsm as jlsm
from orp_tpu.utils import crr as jcrr
from orp_tpu_torch.train import bermudan_lsm, bermudan_lsm_heston
from orp_tpu_torch.train import lsm as tlsm
from orp_tpu_torch.utils import crr_price

LS = dict(k=40.0, r=0.06, sigma=0.2, T=1.0)  # Longstaff-Schwartz 2001 Table 1 row
HESTON = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6)
N = 4096
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
RTOL = {"f64": 1e-9, "f32": 3e-5}


@pytest.mark.parametrize("kind", ["put", "call"])
@pytest.mark.parametrize("exercise, every", [("european", None), ("american", None),
                                             ("bermudan", 40), ("bermudan", 100)])
def test_crr_equals_jax(kind, exercise, every):
    """``rtol=1e-12``."""
    for s0 in (36.0, 44.0):
        kw = dict(kind=kind, exercise=exercise, n_steps=2000, exercise_every=every)
        np.testing.assert_allclose(crr_price(s0, **LS, **kw), jcrr.crr_price(s0, **LS, **kw),
                                   rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("kw", [dict(exercise="bermudan"), dict(kind="straddle"),
                                dict(exercise="asian"),
                                dict(exercise="bermudan", n_steps=100, exercise_every=7),
                                dict(n_steps=1)])
def test_crr_refusals_equal_jax(kw):
    """Each refusal raises in JAX's words (one step at r 0.5, sigma 0.1:
    ``e^{r dt} > u``, no no-arbitrage ``p``)."""
    args = (36.0, 40.0, 0.5, 0.1, 1.0) if kw.get("n_steps") == 1 else (36.0, *LS.values())
    with pytest.raises(ValueError) as want:
        jcrr.crr_price(*args, **kw)
    with pytest.raises(ValueError) as got:
        crr_price(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_features, degree", [(1, 3), (1, 0), (2, 3), (3, 2)])
def test_monomial_exponents_equal_jax(n_features, degree):
    assert tlsm._monomial_exponents(n_features, degree) == \
        jlsm._monomial_exponents(n_features, degree)


def _jax_regress_date(vd, f, pay, degree):
    """A jnp transcription of JAX's per-date ``regress_step``
    (``orp_tpu/train/lsm.py``), returning ``(beta, cont)``."""
    exps = jlsm._monomial_exponents(f.shape[-1], degree)
    n_basis = len(exps)
    itm = (pay > 0.0).astype(pay.dtype)
    wsum = jnp.sum(itm) + 1.0
    mu = jnp.sum(itm[:, None] * f, axis=0) / wsum
    sd = jnp.maximum(jnp.sqrt(jnp.sum(itm[:, None] * (f - mu) ** 2, axis=0) / wsum), 1e-3)
    z = (f - mu) / sd
    cols = [jnp.prod(jnp.stack([z[:, i] ** e for i, e in enumerate(exp)]), axis=0)
            if any(exp) else jnp.ones_like(pay) for exp in exps]
    x = jnp.stack(cols, axis=-1)
    xw = x * itm[:, None]
    gram = jnp.matmul(xw.T, x, precision="highest")
    rhs = jnp.matmul(xw.T, vd[:, None], precision="highest")[:, 0]
    gram = gram + (1e-6 * jnp.trace(gram) / n_basis + 1e-6) * jnp.eye(n_basis, dtype=pay.dtype)
    beta = jax.scipy.linalg.solve(gram, rhs, assume_a="pos")
    return beta, jnp.matmul(x, beta[:, None], precision="highest")[:, 0]


def _date_inputs(n_features: int, seed: int, n: int = 2048):
    """One date's float64 inputs from a seed: spot (and variance) features,
    a put payoff (about half the paths ITM) and the next date's cashflow."""
    rng = np.random.default_rng(seed)
    s = 40.0 * np.exp(0.2 * rng.standard_normal(n))
    feats = [s] + [0.04 * np.exp(0.5 * rng.standard_normal(n))][: n_features - 1]
    f = np.stack(feats, axis=-1)
    pay = np.maximum(40.0 - s, 0.0)
    vnext = np.maximum(40.0 - s * np.exp(0.05 * rng.standard_normal(n)), 0.0)
    return f, pay, vnext


@pytest.mark.parametrize("n_features, degree", [(1, 3), (2, 3), (2, 2)])
@pytest.mark.parametrize("seed", [1, 2])
def test_one_date_regression_matches_jax(n_features, degree, seed):
    """``beta``, the continuation value: ``rtol=1e-9``; the exercise mask
    equal. The transcription equals JAX's two-date walk at ``rtol=1e-12``."""
    f, pay, vnext = _date_inputs(n_features, seed)
    disc = np.exp(-0.06 / 50)
    vd = disc * vnext
    beta_j, cont_j = _jax_regress_date(jnp.asarray(vd), jnp.asarray(f), jnp.asarray(pay), degree)
    # the transcription is JAX's walk: a two-date walk regresses date 0 only
    walk = jlsm._lsm_walk(jnp.asarray(np.stack([f, f], axis=1)),
                          jnp.asarray(np.stack([pay, vnext], axis=1)),
                          jnp.asarray(disc), degree)
    mask_j = (pay > 0.0) & (pay > np.asarray(cont_j))
    np.testing.assert_allclose(np.asarray(walk), np.where(mask_j, pay, vd), rtol=1e-12, atol=0.0)
    assert 0 < mask_j.sum() < (pay > 0).sum()  # a real exercise boundary
    exps = tlsm._monomial_exponents(n_features, degree)
    beta, cont = tlsm._regress_date(torch.tensor(vd), torch.tensor(f), torch.tensor(pay), exps)
    np.testing.assert_allclose(beta.numpy(), np.asarray(beta_j), rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(cont.numpy(), np.asarray(cont_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(((torch.tensor(pay) > 0) & (torch.tensor(pay) > cont)).numpy(),
                                  mask_j)


def test_all_otm_date_passes_through_like_jax():
    """No ITM path: the ridge floor keeps the factor defined, beta = 0, the
    date passes the discounted cashflow through (float64, ``rtol=1e-12``)."""
    f, _, vnext = _date_inputs(2, 3)
    pay = np.zeros_like(vnext)
    beta_j, cont_j = _jax_regress_date(jnp.asarray(vnext), jnp.asarray(f), jnp.asarray(pay), 3)
    beta, cont = tlsm._regress_date(torch.tensor(vnext), torch.tensor(f), torch.tensor(pay),
                                    tlsm._monomial_exponents(2, 3))
    assert torch.isfinite(beta).all() and float(beta.abs().max()) == 0.0
    np.testing.assert_array_equal(beta.numpy(), np.asarray(beta_j))
    np.testing.assert_array_equal(cont.numpy(), np.asarray(cont_j))


@pytest.mark.parametrize("n_features", [1, 2])
def test_walk_matches_jax(n_features):
    """The whole backward walk over 12 dates from seeded float64 inputs:
    ``rtol=1e-9``."""
    rng = np.random.default_rng(5 + n_features)
    n, m = 2048, 12
    s = 40.0 * np.exp(np.cumsum(0.06 * rng.standard_normal((n, m)), axis=1))
    var = 0.04 * np.exp(np.cumsum(0.2 * rng.standard_normal((n, m)), axis=1))
    feats = np.stack([s, var][:n_features], axis=-1)
    pay = np.maximum(40.0 - s, 0.0)
    disc = np.exp(-0.06 / m)
    want = jlsm._lsm_walk(jnp.asarray(feats), jnp.asarray(pay), jnp.asarray(disc), 3)
    got = tlsm._lsm_walk(torch.tensor(feats), torch.tensor(pay), torch.tensor(disc), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=0.0)


CASES = {
    "put": (bermudan_lsm, jlsm.bermudan_lsm, (36.0, *LS.values()),
            dict(n_exercise=10, steps_per_exercise=2, seed=9)),
    "put-44": (bermudan_lsm, jlsm.bermudan_lsm, (44.0, *LS.values()),
               dict(n_exercise=8, steps_per_exercise=3, n_basis=3, seed=13)),
    "call": (bermudan_lsm, jlsm.bermudan_lsm, (40.0, *LS.values()),
             dict(kind="call", n_exercise=6, steps_per_exercise=2, seed=5)),
    "single-exercise": (bermudan_lsm, jlsm.bermudan_lsm, (40.0, *LS.values()),
                        dict(n_exercise=1, steps_per_exercise=12, seed=3)),
    "heston-qe": (bermudan_lsm_heston, jlsm.bermudan_lsm_heston, (36.0, 40.0, 0.06, 1.0),
                  dict(n_exercise=10, steps_per_exercise=2, seed=9, **HESTON)),
    "heston-euler": (bermudan_lsm_heston, jlsm.bermudan_lsm_heston, (36.0, 40.0, 0.06, 1.0),
                     dict(n_exercise=8, steps_per_exercise=2, seed=9, scheme="euler",
                          **HESTON)),
    "heston-xi-0": (bermudan_lsm_heston, jlsm.bermudan_lsm_heston, (36.0, 40.0, 0.06, 1.0),
                    dict(v0=0.04, kappa=1e-6, theta=0.04, xi=1e-6, rho=0.0, n_exercise=10,
                         steps_per_exercise=2, seed=9)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_pricer_matches_jax(name, dt):
    """The whole result dict: f64 ``rtol=1e-9``, f32 ``rtol=3e-5``, the
    early-exercise premium (a difference of two prices, 0 at one exercise
    date) at that tolerance of the price; the integer fields equal."""
    port, ref, args, kw = CASES[name]
    jd, td = DTYPES[dt]
    want = ref(N, *args, **kw, dtype=jd)
    got = port(N, *args, **kw, dtype=td, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert isinstance(got[key], type(w)), key
        atol = RTOL[dt] * want["price"] if key == "early_exercise_premium" else 0.0
        np.testing.assert_allclose(got[key], w, rtol=RTOL[dt], atol=atol, err_msg=key)


def test_kind_validation_in_jax_words():
    for port, ref, args in ((bermudan_lsm, jlsm.bermudan_lsm, (128, 36.0, *LS.values())),
                            (bermudan_lsm_heston, jlsm.bermudan_lsm_heston,
                             (128, 36.0, 40.0, 0.06, 1.0))):
        kw = {} if port is bermudan_lsm else HESTON
        with pytest.raises(ValueError) as want:
            ref(*args, **kw, kind="chooser")
        with pytest.raises(ValueError) as got:
            port(*args, **kw, kind="chooser")
        assert str(got.value) == str(want.value)
