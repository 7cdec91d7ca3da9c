"""Run configs of the European inference path (counterpart of ``orp_tpu/api/config.py``).

Frozen dataclasses with the JAX package's field names and defaults, cut to
the fields ``european_oos`` reads. The training knobs (epochs, optimizer,
Gauss-Newton iterations, ...) arrive with the training walk.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Path-simulation settings."""

    n_paths: int = 4096
    T: float = 10.0
    dt: float = 0.01
    rebalance_every: int = 25
    seed_fund: int = 1235        # the risky asset's Sobol stream
    scramble: str = "owen"
    dtype: str = "float32"
    engine: str = "scan"         # "scan" (plain per-step) | "pallas" (fused kernel)

    def __post_init__(self):
        if self.engine not in ("scan", "pallas"):
            raise ValueError(f"engine={self.engine!r}: expected 'scan' or 'pallas'")

    @property
    def n_steps(self) -> int:
        # the epsilon guards float quotients like 1/(1/365) = 365.00000000000006
        return math.ceil(self.T / self.dt - 1e-9)

    @property
    def n_rebalance(self) -> int:
        if self.n_steps % self.rebalance_every != 0:
            raise ValueError(
                f"rebalance_every={self.rebalance_every} must divide n_steps={self.n_steps}")
        return self.n_steps // self.rebalance_every


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training run's combine semantics, which a replay must match."""

    cost_of_capital: float = 0.1
    dual_mode: str = "separate"     # "separate" | "shared" | "mse_only"
    holdings_combine: str = "single"


@dataclasses.dataclass(frozen=True)
class EuropeanConfig:
    """European-option hedge run."""

    s0: float = 100.0
    strike: float = 100.0
    r: float = 0.08
    sigma: float = 0.15
    option_type: str = "call"
    constrain_self_financing: bool = True  # psi = 1 - phi head
