"""Port parity: log-GBM paths (``orp_tpu_torch/qmc/fused_gbm.py`` and
``orp_tpu_torch/sde``) against ``gbm_log_pallas(interpret=True)`` and
``orp_tpu.sde.simulate_gbm_log``. The Sobol stream is bitwise; the float
accumulation differs at ulp level, hence ``rtol=3e-5``, the tolerance
``tests/test_pallas.py`` holds the Pallas kernel to."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orp_tpu.qmc.pallas_sobol import gbm_log_pallas
from orp_tpu.sde import TimeGrid as JTimeGrid
from orp_tpu.sde import bond_curve as jbond_curve
from orp_tpu.sde import simulate_gbm_log as jsimulate_gbm_log
from orp_tpu_torch.qmc import gbm_log_fused, gbm_log_plain
from orp_tpu_torch.sde import TimeGrid, bond_curve, payoffs, reduce_grid, simulate_gbm_log

N_PATHS, N_STEPS, STORE = 1024, 28, 7
KW = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / N_STEPS, seed=1235, store_every=STORE)


@pytest.fixture(scope="module")
def pallas_ref():
    return np.asarray(gbm_log_pallas(N_PATHS, N_STEPS, block_paths=256, interpret=True, **KW))


def test_gbm_plain_matches_pallas_kernel(pallas_ref):
    got = gbm_log_plain(N_PATHS, N_STEPS, **KW)
    assert got.shape == (N_PATHS, N_STEPS // STORE + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas_ref, rtol=3e-5)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.full(N_PATHS, 100.0, np.float32))


def test_gbm_plain_matches_chained_pallas_kernel():
    """Dense grids: the reference chains ``_gbm_kernel_chunk`` calls of
    ``knots_per_call`` knots, carrying the f32 log-state (bitwise its single
    call); the port's K1 is one launch at any knot count. 40 steps stored
    every step at 16 knots a call is a chain of three calls."""
    kw = dict(KW, dt=1.0 / 40, store_every=1)
    want = np.asarray(gbm_log_pallas(512, 40, block_paths=256, interpret=True,
                                     knots_per_call=16, **kw))
    got = gbm_log_plain(512, 40, **kw)
    assert got.shape == want.shape == (512, 41)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    got = gbm_log_fused(N_PATHS, N_STEPS, device="cpu", **KW)
    np.testing.assert_array_equal(got.numpy(), gbm_log_plain(N_PATHS, N_STEPS, **KW).numpy())
    assert gbm_log_fused.launches == 0  # no kernel ran on the CPU


def test_scan_simulator_matches_jax_scan(pallas_ref):
    grid = TimeGrid(1.0, N_STEPS)
    got = simulate_gbm_log(torch.arange(N_PATHS), grid, 100.0, 0.08, 0.15, 1235,
                           store_every=STORE)
    want = np.asarray(jsimulate_gbm_log(jnp.arange(N_PATHS, dtype=jnp.uint32),
                                        JTimeGrid(1.0, N_STEPS), 100.0, 0.08, 0.15,
                                        seed=1235, store_every=STORE, dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5)
    # the two port engines agree like the two JAX engines do
    np.testing.assert_allclose(got.numpy(), pallas_ref, rtol=3e-5)


def test_store_every_equals_reduced_fine_grid():
    grid = TimeGrid(1.0, N_STEPS)
    idx = torch.arange(256)
    fine = simulate_gbm_log(idx, grid, 100.0, 0.08, 0.15, 3)
    coarse = simulate_gbm_log(idx, grid, 100.0, 0.08, 0.15, 3, store_every=STORE)
    np.testing.assert_array_equal(reduce_grid(fine, STORE).numpy(), coarse.numpy())


def test_grid_bond_and_payoffs_match_jax():
    grid, jgrid = TimeGrid(1.0, 364).reduced(7), JTimeGrid(1.0, 364).reduced(7)
    assert grid.n_knots == jgrid.n_knots == 53
    np.testing.assert_allclose(bond_curve(grid, 0.08).numpy(),
                               np.asarray(jbond_curve(jgrid, 0.08, jnp.float32)), rtol=1e-6)
    s = torch.tensor([90.0, 100.0, 110.0])
    np.testing.assert_array_equal(payoffs.european(s, 100.0, "call").numpy(), [0, 0, 10])
    np.testing.assert_array_equal(payoffs.european(s, 100.0, "put").numpy(), [10, 0, 0])
    with pytest.raises(ValueError, match="option_type"):
        payoffs.european(s, 100.0, "digital")
    with pytest.raises(ValueError, match="must divide"):
        TimeGrid(1.0, 10).reduced(3)


@pytest.mark.parametrize("kwargs, match", [
    (dict(n_paths=64, n_steps=10, store_every=3), "must divide"),
    (dict(n_paths=64, n_steps=16385, store_every=1), "direction table"),
    (dict(n_paths=0, n_steps=8, store_every=1), "n_paths"),
])
def test_fused_wrapper_validates(kwargs, match):
    with pytest.raises(ValueError, match=match):
        gbm_log_fused(s0=1.0, drift=0.0, sigma=0.1, dt=0.1, device="cpu", **kwargs)
