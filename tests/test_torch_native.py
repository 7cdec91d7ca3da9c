"""The port's host QMC engine (``orp_tpu_torch/native``, its own copy of
``qmc_host.cc`` built with ``g++``) against both device paths: uniforms
bitwise the JAX package's ``sobol_uniform`` and the port's in float64 for
every scramble, normals within 1e-9 of both (AS241 against the device
paths' inverse normals), the inverse-normal oracle and the refusals."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orp_tpu.qmc import sobol_normal as jsobol_normal
from orp_tpu.qmc import sobol_uniform as jsobol_uniform
from orp_tpu_torch.qmc import sobol_normal, sobol_uniform

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _native():
    from orp_tpu_torch import native

    return native


@pytest.mark.parametrize("scramble", ["none", "owen", "shift"])
def test_uniforms_bitwise_both_device_paths_f64(scramble):
    native = _native()
    idx = np.arange(4096, dtype=np.uint32)
    dims = np.array([0, 1, 2, 17, 1000], dtype=np.uint32)
    host = native.sobol_uniform_host(idx, dims, seed=1234, scramble=scramble)
    jax_dev = np.asarray(jsobol_uniform(jnp.asarray(idx), jnp.asarray(dims), 1234,
                                        scramble=scramble, dtype=jnp.float64))
    ours = sobol_uniform(torch.as_tensor(idx.astype(np.int64)),
                         torch.as_tensor(dims.astype(np.int64)), 1234, scramble=scramble,
                         dtype=torch.float64).numpy()
    np.testing.assert_array_equal(host, jax_dev)
    np.testing.assert_array_equal(host, ours)


def test_normals_within_1e9_of_both_device_paths():
    native = _native()
    idx = np.arange(2048, dtype=np.uint32)
    dims = np.array([3, 7], dtype=np.uint32)
    host = native.sobol_normal_host(idx, dims, seed=9, scramble="owen")
    jax_dev = np.asarray(jsobol_normal(jnp.asarray(idx), jnp.asarray(dims), 9,
                                       dtype=jnp.float64))
    ours = sobol_normal(torch.as_tensor(idx.astype(np.int64)),
                        torch.as_tensor(dims.astype(np.int64)), 9,
                        dtype=torch.float64).numpy()
    np.testing.assert_allclose(host, jax_dev, atol=1e-9)
    np.testing.assert_allclose(host, ours, atol=1e-9)


def test_ndtri_oracle_values():
    from scipy.stats import norm

    u = np.array([1e-10, 0.01, 0.3, 0.5, 0.9, 0.999, 1 - 1e-12])
    np.testing.assert_allclose(_native().ndtri_host(u), norm.ppf(u), rtol=1e-12)


def test_refusals_and_the_build_location():
    native = _native()
    with pytest.raises(ValueError, match="direction table"):
        native.sobol_uniform_host(np.arange(4, dtype=np.uint32), [999999], seed=0)
    with pytest.raises(ValueError, match="scramble"):
        native.sobol_uniform_host(np.arange(4, dtype=np.uint32), [0], scramble="sobol")
    native.load_library()
    so = native._so_path()
    assert so.exists() and so.name.startswith("lib_qmc_host-")
    # a source of its own: the port's copy, not the JAX package's
    assert native._SRC.parent.name == "native" and native._SRC.parent.parent.name == "orp_tpu_torch"
