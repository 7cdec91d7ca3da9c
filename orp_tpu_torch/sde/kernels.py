"""SDE simulation on the Sobol stream, GBM slice (counterpart of ``orp_tpu/sde/kernels.py``).

Time is a Python loop (the JAX package's ``lax.scan``); paths are a flat
vector axis. Step ``t`` (1-based) consumes Sobol dimensions
``(t-1)*n_factors + f``, so the full ``(n_paths, n_steps)`` increment matrix
never materialises, and ``store_every`` keeps only the rebalance knots.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from orp_tpu_torch.qmc.sobol import N_DIMS, sobol_uniform
from orp_tpu_torch.sde.grid import TimeGrid

# step_fn(state, z, t, dt) -> new_state; z is (n, n_factors), t the 1-based step
StepFn = Callable[[Any, torch.Tensor, int, float], Any]


def scan_sde(step_fn: StepFn, state0, out_fn: Callable[[Any], torch.Tensor],
             indices: torch.Tensor, grid: TimeGrid, n_factors: int, seed: int, *,
             scramble: str = "owen", store_every: int = 1, dtype=torch.float32,
             inverse_normal: Callable[[torch.Tensor], torch.Tensor] = torch.special.ndtri):
    """Drive ``step_fn`` over the grid, storing ``out_fn(state)`` every ``store_every``.

    ``inverse_normal`` maps the Sobol uniforms to the step's normals: ``ndtri``
    on the scan path, AS241 in the fused kernel's plain version.

    Returns ``(final_state, trajectory)`` with ``trajectory`` of shape
    ``(n_paths, n_steps // store_every + 1)``; column 0 is the initial condition.
    """
    if grid.n_steps % store_every != 0:
        raise ValueError(f"store_every={store_every} must divide n_steps={grid.n_steps}")
    if grid.n_steps * n_factors > N_DIMS:
        raise ValueError(
            f"n_steps*n_factors = {grid.n_steps * n_factors} exceeds the "
            f"{N_DIMS}-dimension Sobol direction table")
    factor_ids = torch.arange(n_factors, dtype=torch.int64, device=indices.device)
    state = state0
    outs = [out_fn(state0)]
    for t in range(1, grid.n_steps + 1):
        z = inverse_normal(sobol_uniform(indices, (t - 1) * n_factors + factor_ids, seed,
                                         scramble=scramble, dtype=dtype))
        state = step_fn(state, z, t, grid.dt)
        if t % store_every == 0:
            outs.append(out_fn(state))
    return state, torch.stack(outs, dim=1)


def simulate_gbm_log(indices, grid: TimeGrid, s0: float, drift: float, sigma: float,
                     seed: int = 1234, *, scramble: str = "owen", store_every: int = 1,
                     dtype=torch.float32, n_factors: int = 1, factor: int = 0) -> torch.Tensor:
    """Exact log-Euler GBM ``S_t = S_{t-1} exp((drift - sigma^2/2) dt + sigma sqrt(dt) Z)``.

    The accumulator is the log-RETURN (state0 = 0) and ``s0`` scales the
    output at the end: seeding it with a device-side ``log(s0)`` multiplies
    every path by the same rounding error (SCALING.md §6d).
    """
    indices = torch.as_tensor(indices).to(torch.int64)
    sdt = torch.tensor(grid.dt, dtype=dtype) ** 0.5
    c0 = (drift - 0.5 * sigma * sigma) * grid.dt
    vol = (sigma * sdt).to(indices.device)

    def step(logs, z, t, dt):
        return logs + c0 + vol * z[:, factor]

    state0 = torch.zeros(indices.shape, dtype=dtype, device=indices.device)
    _, traj = scan_sde(step, state0, lambda x: x, indices, grid, n_factors, seed,
                       scramble=scramble, store_every=store_every, dtype=dtype)
    return torch.tensor(s0, dtype=dtype, device=indices.device) * torch.exp(traj)
