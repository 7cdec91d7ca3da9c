"""Time grids, bond curve and rebalance-grid reduction (counterpart of ``orp_tpu/sde/grid.py``).

``n_time_steps = ceil(T/dt) + 1`` knots including t=0, the bank account
``B(t) = exp(r t)`` on the knots, and the stride-slice down to the rebalance
dates. The SDE layer stores directly on the coarse grid (``store_every``), so
``reduce_grid`` serves the simulate-fine-store-fine path and the tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TimeGrid:
    """Uniform simulation grid on [0, T] with ``n_steps`` steps (n_steps+1 knots)."""

    T: float
    n_steps: int

    @property
    def dt(self) -> float:
        return self.T / self.n_steps

    @property
    def n_knots(self) -> int:
        return self.n_steps + 1

    def times(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return torch.linspace(0.0, self.T, self.n_knots, dtype=dtype, device=device)

    def reduced(self, every: int) -> "TimeGrid":
        """Coarse grid keeping every ``every``-th knot (must divide n_steps)."""
        if self.n_steps % every != 0:
            raise ValueError(f"store stride {every} must divide n_steps={self.n_steps}")
        return TimeGrid(self.T, self.n_steps // every)


def bond_curve(grid: TimeGrid, r: float, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Deterministic bank account ``B(t) = e^{rt}`` on the grid knots, ``(n_knots,)``."""
    return torch.exp(torch.tensor(r, dtype=dtype, device=device)
                     * grid.times(dtype, device))


def reduce_grid(paths: torch.Tensor, every: int) -> torch.Tensor:
    """Stride-slice ``(n_paths, n_knots)`` down to the rebalance knots (keeps both ends)."""
    n_knots = paths.shape[-1]
    if (n_knots - 1) % every != 0:
        raise ValueError(f"reduction {every} must divide n_steps={n_knots - 1}")
    return paths[..., ::every]
