"""Run configs of the European, Heston, basket and pension pipelines (counterpart of ``orp_tpu/api/config.py``).

Frozen dataclasses with the JAX package's field names and defaults, cut to
the fields the ported pipelines read. ``TrainConfig`` carries the Adam
walk's fields (the JAX default), the Gauss-Newton walk's and the quantile
leg's, and the walk's resilience plane (``checkpoint_dir``, ``nan_guard``
with ``nan_retries``) and ``fused``; ``fused`` together with
``checkpoint_dir`` or ``nan_guard`` is refused at construction, as in the
JAX package.
``SimConfig.binomial_mode`` keeps the JAX default ``"exact"``, the
binomial draw on the scan path (equal to the JAX package's in law, not in
its threefry draws); the fused kernel runs ``"normal"`` and ``"inversion"``
and refuses it, as the JAX package's Pallas engine does.

Every sub-model owns its namespace (``sv.c`` vs ``actuarial.mort_c``), so the
reference's ``'c'`` key collision (RP.py:249 vs :257) cannot be written
down; the flat-dict shims of ``api.pipelines`` document the fix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from orp_tpu_torch.train.fit import validate_shuffle


@dataclasses.dataclass(frozen=True)
class MarketConfig:
    """Fund / underlying dynamics and the money-market rate."""

    y0: float = 1.0          # initial fund level (Y in RP.py:31)
    mu: float = 0.08         # real-world drift (RP.py:34)
    r: float = 0.03          # risk-free rate -> bond curve (RP.py:35)
    sigma: float = 0.15      # constant vol (RP.py:36); ignored when sv is set


@dataclasses.dataclass(frozen=True)
class ActuarialConfig:
    """Pension-liability population and mortality (RP.py:38-45); ``mort_c`` is
    the reference's mortality drift ``c``."""

    n0: int = 10_000         # initial policyholders N(0)
    premium: float = 100.0   # P per policyholder
    guarantee: float = 1.0   # K floor per unit fund (payoff max(Y_T, K))
    age: int = 55            # x, carried for reporting only
    l0: float = 0.01         # lambda(0) initial mortality intensity
    mort_c: float = 0.075    # intensity drift
    eta: float = 0.000597    # intensity vol


@dataclasses.dataclass(frozen=True)
class StochVolConfig:
    """CIR stochastic-vol parameters (v is *vol*, not variance, RP.py:280-289)."""

    a: float = 0.00336       # mean-reversion speed
    b: float = 0.15431       # long-run vol level
    c: float = 0.01583       # vol-of-vol (the parameter RP.py:285 lost to the collision)
    v0: float = 0.15         # initial vol
    drift_times_dt: bool = False  # False reproduces RP.py:285 omitting dt on the drift

    def feller_ok(self) -> bool:
        """The ``2ab >= c^2`` condition of the reference's CIRParams."""
        return 2 * self.a * self.b >= self.c * self.c


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Path-simulation settings."""

    n_paths: int = 4096
    T: float = 10.0
    dt: float = 0.01
    rebalance_every: int = 25
    seed: int = 1234             # the pension system's Sobol stream (every factor)
    seed_fund: int = 1235        # the risky asset's Sobol stream
    scramble: str = "owen"
    binomial_mode: str = "exact"  # "exact" (a binomial draw, scan engine only) |
    # "inversion" (exact-in-law Sobol CDF inversion) | "normal" (moment-matched)
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

    epochs_first: int = 500         # Adam: epochs and patience of the first fitted
    epochs_warm: int = 100          # date and of the warm-started ones
    patience_first: int = 50
    patience_warm: int = 7
    batch_size: int = 512
    cost_of_capital: float = 0.1
    quantile: float = 0.99
    quantile_loss: str = "pinball"  # or "smoothed_pinball"
    dual_mode: str = "separate"     # "separate" | "shared" | "mse_only"
    holdings_combine: str = "single"
    lr: float | None = None         # Adam: None is the reference schedule / warm LR
    final_solve: bool = False       # closed-form ridge readout after each MSE fit
    optimizer: str = "adam"         # "adam" | "gauss_newton"
    gn_iters_first: int = 30
    gn_iters_warm: int = 10
    gn_quantile: bool = True        # GN: the quantile leg by IRLS Gauss-Newton (False:
    # by Adam)
    gn_block_rows: int | None = None  # blocked Gram accumulation (O(block*P) memory)
    seed: int = 1234                # the walk's init generator and Adam's orders
    checkpoint_dir: str | None = None  # persist / resume per backward date
    shuffle: bool | str = True      # Adam: True/"full" | "blocks" | False (FitConfig)
    fused: bool = False             # no host read between dates (BackwardConfig.fused)
    nan_guard: bool = False         # per-date NaN/Inf sentinel and trainer ladder
    nan_retries: int = 2            # the ladder's budget per date (nan_guard only)

    def __post_init__(self):
        # fail at config construction, not after a 1M-path simulation
        object.__setattr__(self, "shuffle", validate_shuffle(self.shuffle))
        if self.fused and self.checkpoint_dir is not None:
            raise ValueError(
                "fused=True runs the whole walk device-side; per-date "
                "checkpointing needs the host loop (fused=False)")
        if self.fused and self.nan_guard:
            raise ValueError(
                "fused=True runs the whole walk device-side; the NaN "
                "sentinel's per-date host checks need the host loop "
                "(fused=False)")


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


@dataclasses.dataclass(frozen=True)
class BasketConfig:
    """A-asset correlated-GBM basket call (BASELINE.json config 5), with uniform
    pairwise correlation ``rho``. Tuples keep the config hashable."""

    s0: tuple = (100.0, 100.0, 100.0, 100.0, 100.0)
    weights: tuple = (0.2, 0.2, 0.2, 0.2, 0.2)
    strike: float = 100.0
    r: float = 0.08
    sigmas: tuple = (0.1, 0.12, 0.15, 0.18, 0.2)
    rho: float = 0.3

    def __post_init__(self):
        a = len(self.s0)
        if not (len(self.weights) == len(self.sigmas) == a):
            raise ValueError(
                f"s0/weights/sigmas lengths differ: {a}/"
                f"{len(self.weights)}/{len(self.sigmas)}")
        # equicorrelation is PSD on [-1/(A-1), 1], but the endpoints are
        # singular and their Cholesky factor is NaN: the simulator needs strict
        # definiteness (the oracle basket_call_mm takes rho = 1)
        lo = -1.0 / (a - 1) if a > 1 else -1.0
        if a > 1 and not (lo < self.rho < 1.0):
            raise ValueError(
                f"rho={self.rho} outside the positive-definite range "
                f"({lo:.3f}, 1) — the endpoints are singular and Cholesky "
                "would yield NaN paths")

    def corr(self) -> np.ndarray:
        """The ``(A, A)`` equicorrelation matrix."""
        a = len(self.s0)
        m = np.full((a, a), self.rho)
        np.fill_diagonal(m, 1.0)
        return m


@dataclasses.dataclass(frozen=True)
class HedgeRunConfig:
    """The pension run: market + actuarial + optional SV + sim + train."""

    market: MarketConfig = MarketConfig()
    actuarial: ActuarialConfig = ActuarialConfig()
    sv: StochVolConfig | None = None
    sim: SimConfig = SimConfig()
    train: TrainConfig = TrainConfig()
