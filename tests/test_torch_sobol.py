"""Port parity: Owen-scrambled Sobol words, uniforms and inverse normals
(``orp_tpu_torch/qmc``) against ``orp_tpu.qmc.sobol`` and the Pallas
kernel's AS241 helper. Integers and uniforms are bitwise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.stats import norm

from orp_tpu.qmc import sobol as jsobol
from orp_tpu.qmc.pallas_sobol import _ndtri_f32
from orp_tpu_torch.qmc import fused_gbm, sobol

DIMS = np.arange(364)
INDICES = np.concatenate([
    np.arange(4096),
    [4097, 65535, 1 << 20, 123456789, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1],
]).astype(np.uint32)


def _jax_words(idx, dims, seed, scramble):
    dj = jsobol.direction_numbers()[jnp.asarray(dims, jnp.uint32)]
    x = jsobol._sobol_uint32(jnp.asarray(idx, jnp.uint32), dj)
    fn = jsobol.SCRAMBLES[scramble]
    if fn is not None:
        x = fn(x, jsobol._dim_seeds(seed, jnp.asarray(dims, jnp.uint32))[None, :])
    return np.asarray(x).astype(np.int64)


def _port_words(idx, dims, seed, scramble):
    dirs = sobol.direction_numbers()[torch.from_numpy(dims)]
    x = sobol._sobol_uint32(torch.from_numpy(idx.astype(np.int64)), dirs)
    fn = sobol.SCRAMBLES[scramble]
    if fn is not None:
        x = fn(x, sobol._dim_seeds(seed, torch.from_numpy(dims))[None, :])
    return x.numpy()


@pytest.mark.parametrize("scramble", ["owen", "shift", "none"])
def test_sobol_words_bitwise(scramble):
    """Dimensions 0..363 x indices 0..4095 plus high indices up to 2^32-1."""
    np.testing.assert_array_equal(_port_words(INDICES, DIMS, 1235, scramble),
                                  _jax_words(INDICES, DIMS, 1235, scramble))


def test_hash_primitives_bitwise():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (sobol._hash_combine(ta, tb), jsobol._hash_combine(ja, jb)),
        (sobol._reverse_bits32(ta), jsobol._reverse_bits32(ja)),
        (sobol._laine_karras_permutation(ta, tb), jsobol._laine_karras_permutation(ja, jb)),
        (sobol.owen_scramble(ta, tb), jsobol.owen_scramble(ja, jb)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1235, 2**32 - 1])
def test_sobol_uniform_bitwise(seed):
    got = sobol.sobol_uniform(INDICES.astype(np.int64), DIMS, seed).numpy()
    want = np.asarray(jsobol.sobol_uniform(jnp.asarray(INDICES), jnp.asarray(DIMS), seed,
                                           dtype=jnp.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.min() and got.max() < 1.0


def test_sobol_normal_matches_jax_ndtri():
    """``torch.special.ndtri`` against ``jax.scipy.special.ndtri`` on the same
    f32 uniforms: two f32 implementations, a couple of ulps apart."""
    idx = jnp.arange(4096, dtype=jnp.uint32)
    want = np.asarray(jsobol.sobol_normal(idx, jnp.arange(64), 7, dtype=jnp.float32))
    got = sobol.sobol_normal(np.arange(4096), np.arange(64), 7).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_as241_plain_matches_pallas_helper_and_scipy():
    """AS241 plain against ``pallas_sobol._ndtri_f32`` at ``atol=1e-6`` (same
    f32 formula) and against scipy at ``atol=2e-5`` (``tests/test_pallas.py``)."""
    u = np.concatenate([
        np.asarray([2**-23, 1e-4, 0.01, 0.3, 0.5, 0.77, 0.999, 1 - 2**-23]),
        np.asarray(jsobol.sobol_uniform(jnp.arange(8192, dtype=jnp.uint32),
                                        jnp.asarray([3]), 11, dtype=jnp.float32))[:, 0],
    ]).astype(np.float32)
    got = fused_gbm.ndtri_as241(torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax.jit(_ndtri_f32)(jnp.asarray(u))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, norm.ppf(u.astype(np.float64)), rtol=0, atol=2e-5)


def test_direction_words_for_the_kernel():
    """The kernel's int32 view carries the same 32 bits as the int64 words."""
    w64 = sobol.direction_numbers(364).numpy()
    w32 = sobol.direction_numbers(364, dtype=torch.int32).numpy()
    np.testing.assert_array_equal(w32.view(np.uint32).astype(np.int64), w64)
    np.testing.assert_array_equal(w64, np.asarray(jsobol.direction_numbers(364)).astype(np.int64))
    with pytest.raises(ValueError, match="int64 or int32"):
        sobol.direction_numbers(4, dtype=torch.float32)
