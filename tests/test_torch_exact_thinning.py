"""Port parity: ``exact`` thinning of the pension paths (``orp_tpu_torch/sde/kernels.py``,
``orp_tpu_torch/utils/threefry.py``) against the JAX package's ``simulate_pension``
and ``jax.random``, index-addressed as in the JAX package:

- threefry's key words, splits and uniforms equal to ``jax.random``'s; the
  sampler's counts equal to ``jax.random.binomial``'s path for path in both
  regimes;
- a prefix of the paths and shards of them bitwise the whole run;
- the law: E[N_T] within 4 combined standard errors of JAX's own exact draws
  and sd within 10% at PARITY.md's 8,192 paths x monthly grid, where >= 99%
  of the knots' counts equal JAX's (measured 99.86%: the rest follow one-ulp
  differences of lambda, which the two packages' f32 arithmetic leaves on
  ~35% of knots); at the single-step grid the mean within 4 standard errors
  and the variance within 3% of the binomial's.

These tests were in ``tests/test_torch_pension_sim.py``; a file of their own
lets ``--dist loadfile`` run them beside the rest of the pension tests.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu.sde import TimeGrid as JTimeGrid
from orp_tpu.sde import simulate_pension as jsimulate_pension
from orp_tpu_torch.sde import TimeGrid, simulate_pension
from orp_tpu_torch.utils import threefry

KW = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: their tensors are a few
    thousand rows, and under the suite's parallel workers every worker's
    default pool (one thread a core) oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
