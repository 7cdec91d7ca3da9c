"""The (phi, psi) hedge network's forward (counterpart of ``orp_tpu/models/mlp.py``).

A frozen dataclass holding the architecture plus pure functions over a params
dict ``{"w0": (f, h0), "b0": (h0,), ...}``: features -> Dense(8, LeakyReLU 0.3)
-> Dense(8, LeakyReLU 0.3) -> Dense(n_outputs) -> holdings, and the Dot head
``V = sum_j holdings_j * prices_j``. The constrained head returns
``(phi, 1 - phi)`` from one output; ``n_hedge_assets > 1`` is the vector
hedge (one phi per risky asset, then the bond).

``init`` and ``solve_readout`` belong to training and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

Params = dict


@dataclasses.dataclass(frozen=True)
class HedgeMLP:
    """Config + pure forward of the hedge network."""

    n_features: int
    hidden: tuple[int, ...] = (8, 8)
    negative_slope: float = 0.3
    constrain_self_financing: bool = False
    init_scale: float = 0.1
    dtype: torch.dtype = torch.float32
    n_hedge_assets: int = 1

    def __post_init__(self):
        if self.constrain_self_financing and self.n_hedge_assets != 1:
            raise ValueError(
                "psi = 1 - phi is a two-instrument normalisation; "
                f"n_hedge_assets={self.n_hedge_assets} needs the free head")

    @property
    def n_outputs(self) -> int:
        if self.constrain_self_financing:
            return 1
        return self.n_hedge_assets + 1

    @property
    def layer_sizes(self) -> tuple[int, ...]:
        return (self.n_features, *self.hidden, self.n_outputs)

    def with_dtype(self, dtype) -> "HedgeMLP":
        """The same architecture computing in ``dtype``."""
        if dtype == self.dtype:
            return self
        return dataclasses.replace(self, dtype=dtype)

    def last_hidden(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """Activations feeding the final layer: ``(n, hidden[-1])``."""
        x = features.to(self.dtype)
        for i in range(len(self.hidden)):
            x = x @ params[f"w{i}"] + params[f"b{i}"]
            x = torch.where(x >= 0, x, self.negative_slope * x)
        return x

    def holdings(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """Forward to the holdings layer: ``(n, n_instruments)`` (phi..., psi)."""
        last = len(self.hidden)
        x = self.last_hidden(params, features) @ params[f"w{last}"] + params[f"b{last}"]
        if self.constrain_self_financing:
            phi = x[..., 0]
            return torch.stack([phi, 1.0 - phi], dim=-1)
        return x

    def value(self, params: Params, features: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
        """Portfolio value ``V = sum_j holdings_j * prices_j``."""
        return torch.sum(self.holdings(params, features) * prices.to(self.dtype), dim=-1)

    def n_params(self) -> int:
        sizes = self.layer_sizes
        return sum((a + 1) * b for a, b in zip(sizes[:-1], sizes[1:]))
