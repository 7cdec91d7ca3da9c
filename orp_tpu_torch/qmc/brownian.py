"""Brownian increments and paths (counterpart of ``orp_tpu/qmc/brownian.py``).

The reference's ``get_dW``/``get_W`` (``brownian_motion.py:6-24``) are
pseudo-random; here they draw from a ``torch.Generator`` where the JAX package
takes a ``jax.random`` key, so the draws equal JAX's in law, not draw by draw.
The Sobol pair reads the framework's QMC stream and gives the JAX package's
numbers. ``device=None`` is the card: the generator must live there, and
index arrays that are not tensors are placed there.
"""

from __future__ import annotations

import torch

from orp_tpu_torch.qmc.sobol import sobol_normal
from orp_tpu_torch.utils.device import as_indices, resolve_device


def get_dW(generator: torch.Generator, n: int, dtype=torch.float32, *,
           device=None) -> torch.Tensor:
    """``n`` i.i.d. N(0, 1) increments from ``generator``, on ``device``."""
    return torch.randn(n, generator=generator, dtype=dtype, device=resolve_device(device))


def get_W(generator: torch.Generator, n: int, dtype=torch.float32, *,
          device=None) -> torch.Tensor:
    """A Brownian path of ``n`` knots with ``W[0] = 0``, the cumulative sum of
    the first ``n - 1`` of :func:`get_dW`'s increments."""
    dW = get_dW(generator, n, dtype, device=device)
    return torch.cat([torch.zeros(1, dtype=dtype, device=dW.device), torch.cumsum(dW[:-1], 0)])


def get_dW_sobol(indices, n_steps: int, seed: int = 1234, dtype=torch.float32, *,
                 device=None) -> torch.Tensor:
    """``(n_paths, n_steps)`` Sobol N(0, 1) increments of the paths ``indices``."""
    indices = as_indices(indices, device)
    return sobol_normal(indices, torch.arange(n_steps, device=indices.device), seed,
                        dtype=dtype)


def get_W_sobol(indices, n_steps: int, seed: int = 1234, dtype=torch.float32, *,
                device=None) -> torch.Tensor:
    """Sobol Brownian paths ``(n_paths, n_steps)`` with ``W[:, 0] = 0``."""
    indices = as_indices(indices, device)
    dW = get_dW_sobol(indices, n_steps, seed, dtype)
    w = torch.cumsum(dW[:, :-1], dim=1)
    return torch.cat([torch.zeros((indices.shape[0], 1), dtype=dtype, device=w.device), w],
                     dim=1)
