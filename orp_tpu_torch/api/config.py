"""Run configs of the European and Heston pipelines (counterpart of ``orp_tpu/api/config.py``).

Frozen dataclasses with the JAX package's field names and defaults, cut to
the fields the ported pipelines read. ``TrainConfig`` carries the
Gauss-Newton walk's fields; the fields of walks not ported yet (Adam's
epochs and schedule, the quantile leg) are absent, and the walk refuses the
JAX defaults that would select them (``optimizer="adam"``, ``fused``,
``checkpoint_dir``, ``nan_guard``) instead of running something else.
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
    """The walk's training policy and the combine semantics a replay must match."""

    cost_of_capital: float = 0.1
    dual_mode: str = "separate"     # "separate" | "shared" | "mse_only"
    holdings_combine: str = "single"
    final_solve: bool = False       # closed-form ridge readout after each fit
    optimizer: str = "adam"         # "adam" | "gauss_newton" (only GN is ported)
    gn_iters_first: int = 30
    gn_iters_warm: int = 10
    gn_block_rows: int | None = None  # blocked Gram accumulation (O(block*P) memory)
    seed: int = 1234                # the walk's init generator
    checkpoint_dir: str | None = None
    fused: bool = False
    nan_guard: bool = False


@dataclasses.dataclass(frozen=True)
class EuropeanConfig:
    """European-option hedge run."""

    s0: float = 100.0
    strike: float = 100.0
    r: float = 0.08
    sigma: float = 0.15
    option_type: str = "call"
    constrain_self_financing: bool = True  # psi = 1 - phi head


@dataclasses.dataclass(frozen=True)
class HestonConfig:
    """Risk-neutral Heston dynamics for the European hedge; ``v`` is *variance*.

    ``scheme``: ``"qe"`` (Andersen QE-M), ``"euler"`` (full truncation) or
    ``None`` (= ``"qe"``), resolved by ``api.pipelines.resolve_heston_scheme``."""

    s0: float = 100.0
    strike: float = 100.0
    r: float = 0.08
    v0: float = 0.0225
    kappa: float = 1.5
    theta: float = 0.0225
    xi: float = 0.25
    rho: float = -0.6
    option_type: str = "call"
    scheme: str | None = None
