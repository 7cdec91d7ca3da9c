"""The backward hedge-training walk and its result types (counterpart of ``orp_tpu/train/backward.py``).

For each rebalance date t from the last down to 0 the walk fits the date's
network to replicate the next-date portfolio value (the MSE leg), then,
unless ``dual_mode="mse_only"``, the 0.99-quantile leg, each warm-started
from the previous date's params, and records the date's value, holdings and
next-date replication residual (:func:`_date_outputs_core`, shared with
replay and serving). ``optimizer="adam"`` (the reference's default) trains
both legs with ``train/fit.fit_core``; ``optimizer="gauss_newton"`` trains
the MSE leg with ``train/gn.fit_gn`` and the quantile leg with
``fit_gn_pinball`` (IRLS) or, with ``gn_quantile=False``, with Adam. The
walk is the host loop (one host read per date, for the date's fit metrics;
Adam's fits read their stop flag once per epoch). The fused one-program
walk, checkpoint/resume and the NaN guard are not ported (ROADMAP A3):
:func:`backward_induction` refuses the configs that ask for them.

``dual_mode``: ``"separate"`` (two param sets, ``v = g + i(h - g)``),
``"shared"`` (one param set, RP.py:172's weight sharing: the quantile fit
continues from the MSE fit's weights, ``g`` is the MSE-fit value
snapshotted before it, and the ledger holdings read the quantile weights)
and ``"mse_only"`` (quantile branch off). ``holdings_combine``: ``"single"``
(``phi1 + i(phi2 - phi1)``) or ``"py"`` (the reference's sign quirk
``phi1 + i(phi1 - phi2)``, RP.py:114).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from orp_tpu_torch.train.fit import FitConfig, fit_core, validate_shuffle
from orp_tpu_torch.train.gn import GNConfig, GNPinballConfig, fit_gn, fit_gn_pinball
from orp_tpu_torch.train.losses import mae, make_loss, mape, mse
from orp_tpu_torch.utils.precision import full_f32, typed_scalar

DUAL_MODES = ("separate", "shared", "mse_only")
HOLDINGS_COMBINES = ("single", "py")
OPTIMIZERS = ("adam", "gauss_newton")


def _stack_prices(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y (n, knots)`` -> ``(n, knots, 2)`` (risky, bond); ``y (n, knots, A)``
    -> ``(n, knots, A+1)``. The bond is always last."""
    if y.ndim == 3:
        bcol = b[None, :, None].expand(*y.shape[:2], 1)
        return torch.cat([y, bcol], dim=-1)
    return torch.stack([y, b[None, :].expand(y.shape)], dim=-1)


def _date_outputs_core(model, params1, params2, feats_t, prices_t, prices_t1, target,
                       cost_of_capital, g_pre, *, dual_mode, holdings_combine):
    """Per-date value, combined holdings and next-date replication residual.

    ``shared``: ``g_pre`` is the value under the weights right after the MSE
    fit; the holdings ledger reads ``params2``. ``cost_of_capital`` multiplies
    as a scalar of ``model.dtype`` (bf16 rounds it, as JAX does)."""
    cost_of_capital = typed_scalar(cost_of_capital, model.dtype)
    if dual_mode == "shared":
        h_t = model.value(params2, feats_t, prices_t)
        v_t = g_pre + cost_of_capital * (h_t - g_pre)
        comb = model.holdings(params2, feats_t)
        return v_t, comb, target - torch.sum(comb * prices_t1, dim=-1)
    g_t = model.value(params1, feats_t, prices_t)
    if dual_mode == "mse_only":
        v_t = g_t
    else:
        h_t = model.value(params2, feats_t, prices_t)
        v_t = g_t + cost_of_capital * (h_t - g_t)
    h1 = model.holdings(params1, feats_t)
    if dual_mode == "mse_only":
        comb = h1
    else:
        h2 = model.holdings(params2, feats_t)
        if holdings_combine == "py":
            comb = h1 + cost_of_capital * (h1 - h2)
        else:
            comb = h1 + cost_of_capital * (h2 - h1)
    var_resid = target - torch.sum(comb * prices_t1, dim=-1)
    return v_t, comb, var_resid


def _split_holdings(comb: torch.Tensor):
    """``(..., k)`` holdings -> ``(phi, psi)``: scalar phi for the 2-instrument
    head, per-asset phi ``(..., A)`` for a vector hedge; the bond is last."""
    if comb.shape[-1] == 2:
        return comb[..., 0], comb[..., 1]
    return comb[..., :-1], comb[..., -1]


def date_params(params_by_date: dict, t: int) -> dict:
    """Date ``t``'s params out of the stacked ``{name: (D, ...)}`` dict."""
    return {k: v[t] for k, v in params_by_date.items()}


def params_to(params_by_date: dict | None, device, dtype) -> dict | None:
    """Params (numpy arrays, e.g. a JAX run's, or tensors) as contiguous tensors on ``device``."""
    if params_by_date is None:
        return None
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))
            .to(device=device, dtype=dtype).contiguous() for k, v in params_by_date.items()}


@dataclasses.dataclass(frozen=True)
class BackwardConfig:
    """The walk's combine semantics (the fields a replay reads) and its
    training policy, with the JAX package's names and defaults. Warm dates
    train Adam at ``warm_lr`` unless ``lr`` is set: the reference passes its
    LR scheduler only to the first date's fit (RP.py:205-209), so later fits
    keep Adam at the schedule's final 5e-4."""

    epochs_first: int = 500
    epochs_warm: int = 100
    patience_first: int = 50
    patience_warm: int = 7
    batch_size: int = 512
    cost_of_capital: float = 0.1
    quantile: float = 0.99
    quantile_loss: str = "pinball"  # or "smoothed_pinball"
    dual_mode: str = "separate"
    holdings_combine: str = "single"
    lr: float | None = None  # None: the schedule on the first date, warm_lr after
    warm_lr: float = 5e-4
    final_solve: bool = False
    optimizer: str = "adam"
    gn_iters_first: int = 30
    gn_iters_warm: int = 10
    gn_quantile: bool = True
    gn_block_rows: int | None = None
    seed: int = 1234
    checkpoint_dir: str | None = None
    shuffle: bool | str = True  # FitConfig.shuffle: True/"full", "blocks" or False
    fused: bool = False
    nan_guard: bool = False

    def __post_init__(self):
        object.__setattr__(self, "shuffle", validate_shuffle(self.shuffle))
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer={self.optimizer!r}: expected one of {OPTIMIZERS}")
        if self.dual_mode not in DUAL_MODES:
            raise ValueError(f"dual_mode={self.dual_mode!r}: expected one of {DUAL_MODES}")
        if self.holdings_combine not in HOLDINGS_COMBINES:
            raise ValueError(
                f"holdings_combine={self.holdings_combine!r}: expected one of "
                f"{HOLDINGS_COMBINES}")


@dataclasses.dataclass
class BackwardResult:
    """Ledgers of a walk; the time axis is the rebalance-date index, ascending."""

    values: Any               # (n_paths, n_dates+1) incl. terminal
    phi: Any                  # (n_paths, n_dates) or (n_paths, n_dates, A)
    psi: Any                  # (n_paths, n_dates)
    var_residuals: Any        # (n_paths, n_dates) next-date replication residuals
    train_loss: np.ndarray    # (n_dates,) per-date fit metrics of the training run
    train_mae: np.ndarray
    train_mape: np.ndarray
    epochs_ran: np.ndarray
    params1: Any = None
    params2: Any = None
    params1_by_date: Any = None  # {name: (n_dates, ...)} the per-date policy
    params2_by_date: Any = None
    quantile_loss: np.ndarray | None = None       # (n_dates,) the quantile leg's final
    quantile_epochs_ran: np.ndarray | None = None  # loss and epochs (GN: accepted iterations)

    @property
    def v0(self) -> torch.Tensor:
        """t=0 portfolio value per path; its mean is the network's price."""
        return self.values[:, 0]

    @classmethod
    def from_policy_state(cls, state: dict) -> "BackwardResult":
        """A params-only result (ledgers None), for replay and serving."""
        return cls(
            values=None, phi=None, psi=None, var_residuals=None,
            train_loss=np.asarray(state["train_loss"]),
            train_mae=np.asarray(state["train_mae"]),
            train_mape=np.asarray(state["train_mape"]),
            epochs_ran=np.asarray(state["epochs_ran"]).astype(np.int64),
            params1_by_date=state["params1_by_date"],
            params2_by_date=state.get("params2_by_date"),
        )


def _check_walk(cfg: BackwardConfig) -> None:
    """Refuse what the port cannot train yet, instead of training something else."""
    for name, on in (("fused=True", cfg.fused),
                     ("checkpoint_dir", cfg.checkpoint_dir is not None),
                     ("nan_guard=True", cfg.nan_guard)):
        if on:
            raise ValueError(f"{name}: not ported yet (ROADMAP A3); the port runs the "
                             "host-loop walk without it")


def _fit_generator(seed: int, step_i: int, leg: int) -> torch.Generator:
    """The CPU generator of one Adam fit's epoch orders, seeded from ``(seed,
    step_i, leg)`` alone (leg 0 the MSE fit, 1 the quantile fit): a fit's
    stream does not depend on what earlier fits drew. The JAX package draws
    from keys split per date; threefry cannot be reproduced, so the orders
    match it in law."""
    words = np.random.SeedSequence([seed, step_i, leg]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(words[0]))


def _initial_params(model, cfg: BackwardConfig, bias_init, initial_params, dev, dtype):
    """``(params1, params2)``: ``params1`` then, in ``separate`` mode,
    ``params2`` drawn from one generator seeded with ``cfg.seed`` (JAX draws
    them from two keys of one split); ``initial_params = (p1, p2)`` replaces
    them, ``p2=None`` keeping the seeded ``params2``. ``params2`` is
    ``params1`` under ``shared`` and unused under ``mse_only``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    params1 = model.init(gen, bias_init=bias_init)
    params2 = model.init(gen, bias_init=bias_init) if cfg.dual_mode == "separate" else None
    if initial_params is not None:
        w1, w2 = initial_params
        shapes = {k: v.shape for k, v in params1.items()}
        params1 = {k: v.reshape(shapes[k]) for k, v in params_to(w1, "cpu", dtype).items()}
        if params2 is not None and w2 is not None:
            params2 = {k: v.reshape(shapes[k]) for k, v in params_to(w2, "cpu", dtype).items()}
    params1 = params_to(params1, dev, dtype)
    params2 = params1 if params2 is None else params_to(params2, dev, dtype)
    return params1, params2


def backward_induction(model, features: torch.Tensor, y_prices: torch.Tensor,
                       b_prices: torch.Tensor, terminal_values: torch.Tensor,
                       cfg: BackwardConfig, *, bias_init: tuple[float, ...] | None = None,
                       initial_params=None) -> BackwardResult:
    """Run the backward hedge-training walk on ``y_prices``'s device.

    ``features (n, n_dates+1, n_features)``, ``y_prices (n, n_dates+1)``,
    ``b_prices (n_dates+1,)``, ``terminal_values (n,)``. The first params are
    ``model.init`` from a generator seeded with ``cfg.seed`` and the output
    bias ``bias_init`` (:func:`_initial_params`); ``initial_params =
    (params1, params2)`` (numpy arrays or tensors, e.g. a JAX run's initial
    params) replaces them. The first fitted date runs ``cfg.gn_iters_first``
    GN iterations or ``cfg.epochs_first`` Adam epochs (patience
    ``patience_first``, LR ``cfg.lr``: the schedule when None) in each leg,
    the rest ``gn_iters_warm`` or ``epochs_warm`` (``patience_warm``, LR
    ``cfg.lr`` or ``warm_lr``). Each Adam fit draws its epoch orders from
    :func:`_fit_generator`."""
    _check_walk(cfg)
    full_f32()
    dev, dtype = y_prices.device, model.dtype
    n_paths, n_knots = y_prices.shape[:2]
    n_dates = n_knots - 1
    params1, params2 = _initial_params(model, cfg, bias_init, initial_params, dev, dtype)
    q_loss = make_loss(cfg.quantile_loss, q=cfg.quantile)
    solve_fn = model.solve_readout if cfg.final_solve else None
    prices_all = _stack_prices(y_prices.to(dtype), b_prices.to(device=dev, dtype=dtype))
    values = torch.zeros((n_paths, n_knots), dtype=dtype, device=dev)
    values[:, -1] = terminal_values.to(dtype)
    phi_cols, psi_cols, var_cols, snaps1, snaps2, metrics = [], [], [], [], [], []
    for step_i, t in enumerate(range(n_dates - 1, -1, -1)):
        first = step_i == 0
        n_iters = cfg.gn_iters_first if first else cfg.gn_iters_warm
        adam_cfg = FitConfig(
            n_epochs=cfg.epochs_first if first else cfg.epochs_warm,
            batch_size=cfg.batch_size,
            patience=cfg.patience_first if first else cfg.patience_warm,
            lr=cfg.lr if (first or cfg.lr is not None) else cfg.warm_lr, shuffle=cfg.shuffle)
        feats_t, prices_t, prices_t1 = features[:, t], prices_all[:, t], prices_all[:, t + 1]
        target = values[:, t + 1]
        if cfg.optimizer == "adam":
            params1, aux = fit_core(model, params1, feats_t, prices_t1, target,
                                    _fit_generator(cfg.seed, step_i, 0), loss_fn=mse,
                                    cfg=adam_cfg, metric_fns=(mae, mape), solve_fn=solve_fn)
        else:
            params1, aux = fit_gn(model, params1, feats_t, prices_t1, target,
                                  cfg=GNConfig(n_iters=n_iters, block_rows=cfg.gn_block_rows),
                                  final_solve=cfg.final_solve)
        g_pre, q_aux = None, None
        if cfg.dual_mode == "mse_only":
            params2 = params1
        else:
            if cfg.dual_mode == "shared":
                # the MSE fit's value, before the quantile fit moves the shared
                # weights (RP.py:212-217 order); a device tensor, no host read
                g_pre = model.value(params1, feats_t, prices_t)
                params2 = params1
            # the quantile leg never receives the least-squares readout solve
            if cfg.optimizer == "gauss_newton" and cfg.gn_quantile:
                params2, q_aux = fit_gn_pinball(
                    model, params2, feats_t, prices_t1, target, loss_fn=q_loss,
                    cfg=GNPinballConfig(n_iters=n_iters, q=cfg.quantile,
                                        block_rows=cfg.gn_block_rows))
            else:
                params2, q_aux = fit_core(model, params2, feats_t, prices_t1, target,
                                          _fit_generator(cfg.seed, step_i, 1), loss_fn=q_loss,
                                          cfg=adam_cfg)
            if cfg.dual_mode == "shared":
                params1 = params2
        v_t, comb, var_resid = _date_outputs_core(
            model, params1, params2, feats_t, prices_t, prices_t1, target, cfg.cost_of_capital,
            g_pre, dual_mode=cfg.dual_mode, holdings_combine=cfg.holdings_combine)
        values[:, t] = v_t
        phi_t, psi_t = _split_holdings(comb)
        phi_cols.append(phi_t)
        psi_cols.append(psi_t)
        var_cols.append(var_resid)
        snaps1.append(params1)
        snaps2.append(params2)
        # the date's one host read: its fit metrics (the quantile leg's last two);
        # n_epochs_ran counts Adam's epochs or GN's accepted iterations
        row = [aux["final_loss"], aux["mae"], aux["mape"], aux["n_epochs_ran"].to(dtype)]
        if q_aux is not None:
            row += [q_aux["final_loss"], q_aux["n_epochs_ran"].to(dtype)]
        metrics.append(torch.stack(row).cpu())
    # walked t downward; stored date-ascending
    m = torch.stack(metrics[::-1]).double().numpy()

    def asc(cols):
        return torch.stack(cols[::-1], dim=1)

    def by_date(snaps):
        return {k: torch.stack([p[k] for p in snaps[::-1]]) for k in snaps[0]}

    dual = cfg.dual_mode != "mse_only"
    return BackwardResult(
        values=values, phi=asc(phi_cols), psi=asc(psi_cols), var_residuals=asc(var_cols),
        train_loss=m[:, 0], train_mae=m[:, 1], train_mape=m[:, 2],
        epochs_ran=m[:, 3].astype(np.int64), params1=params1, params2=params2,
        params1_by_date=by_date(snaps1),
        params2_by_date=by_date(snaps2) if cfg.dual_mode == "separate" else None,
        quantile_loss=m[:, 4] if dual else None,
        quantile_epochs_ran=m[:, 5].astype(np.int64) if dual else None)
