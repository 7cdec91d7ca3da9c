"""The backward hedge-training walk and its result types (counterpart of ``orp_tpu/train/backward.py``).

For each rebalance date t from the last down to 0 the walk fits the date's
network to replicate the next-date portfolio value (the MSE leg), then,
unless ``dual_mode="mse_only"``, the 0.99-quantile leg, each warm-started
from the previous date's params, and records the date's value, holdings and
next-date replication residual (:func:`_date_outputs_core`, shared with
replay and serving). ``optimizer="adam"`` (the reference's default) trains
both legs with ``train/fit.fit_core``; ``optimizer="gauss_newton"`` trains
the MSE leg with ``train/gn.fit_gn`` and the quantile leg with
``fit_gn_pinball`` (IRLS) or, with ``gn_quantile=False``, with Adam.

The walk runs in one of two ways, over the same date body (:func:`_date_body`):

- the host loop (``fused=False``): one host read per date, of the date's fit
  metrics (Adam's fits also read their stop flag once an epoch). It alone
  runs the resilience plane: ``checkpoint_dir`` saves each date's increment
  (``utils/checkpoint.py``, SHA-256 digests, a run fingerprint) and a killed
  walk resumes bitwise-equal to an uninterrupted one; ``nan_guard`` checks
  each date for non-finite state (the flag rides in the date's host read) and
  refits a bad date one rung down the trainer ladder (``guard/sentinel.py``);
- the fused walk (``fused=True``, the counterpart of the JAX package's one
  ``lax.scan`` program): ledgers, per-date params and metrics preallocated on
  the device, nothing read back until the walk ends. On a CUDA device each
  GN leg's LM iteration is captured once as a CUDA graph and replayed
  ``n_iters`` times a date, each Adam fit replays its captured epoch for all
  its epochs (``fit_core(sync_free=True)``), and each date's inputs reach the
  graphs' buffers by device-to-device copies. The date loop runs in the
  scope :func:`fused_loop_scope` gives, empty unless a check replaces it
  (``utils/measure.no_host_sync`` makes a host sync there raise). On the CPU
  the same code runs without graphs. It trains the same numbers as the host
  loop.

Under a paths mesh (``mesh=``, ``parallel/mesh.py``; the counterpart of the
JAX package's ``fused_walk_on_mesh`` and its mesh-threaded host loop) each rank
holds its contiguous block of the paths: the ledgers (values, phi, psi, VaR)
stay path-sharded, each rank holding its block, while params and metrics are
replicated. Every fit reduces over the global paths (``train/gn.py``,
``train/fit.py``), and the guard decides on the ranks' summed finite flag.
``fused=True`` on a card captures each LM iteration with its ``all_reduce``,
which NCCL allows and ``gloo`` does not: a card mesh on another backend is
refused. Checkpoints leave the mesh out of the fingerprint, so a walk saved
on D ranks resumes on any topology: the first rank writes the gathered
per-path columns, and each rank reads back its own block.

Under a telemetry session (``obs/``) the walk emits, as the JAX package's
does, a device-complete ``train/walk`` span (``n_paths`` the global count,
``mesh_devices`` the mesh size), on the host loop the per-date
``train/fit`` / ``train/fit_quantile`` / ``train/outputs`` spans (the guard's
degraded refits too), and after the walk one ``train/convergence`` record
with ``train/gram_cond{date}`` gauges (:func:`_emit_convergence`). The fused
walk is one span: nothing is recorded inside its date loop, which still runs
under :func:`fused_loop_scope`. With telemetry off none of this runs. The
JAX package's ``train/xla_compiles`` counter (its ``compile_audit``) has no
counterpart: the port compiles no XLA programs. The CLI's ``--resume`` waits
for ``cli.py``.

``dual_mode``: ``"separate"`` (two param sets, ``v = g + i(h - g)``),
``"shared"`` (one param set, RP.py:172's weight sharing: the quantile fit
continues from the MSE fit's weights, ``g`` is the MSE-fit value
snapshotted before it, and the ledger holdings read the quantile weights)
and ``"mse_only"`` (quantile branch off). ``holdings_combine``: ``"single"``
(``phi1 + i(phi2 - phi1)``) or ``"py"`` (the reference's sign quirk
``phi1 + i(phi1 - phi2)``, RP.py:114).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from orp_tpu_torch.guard import inject as _inject
from orp_tpu_torch.guard import sentinel as _sentinel
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import emit_record as obs_emit_record
from orp_tpu_torch.obs import enabled as obs_enabled
from orp_tpu_torch.obs import set_gauge as obs_set_gauge
from orp_tpu_torch.obs import span as obs_span
from orp_tpu_torch.obs import spanned as obs_spanned
from orp_tpu_torch.parallel.mesh import (as_mesh, dist_backend, mesh_rank, mesh_size,
                                         path_gather, path_mean, path_sum,
                                         replicate_from_first, shard_rows)
from orp_tpu_torch.train import fit as _fit
from orp_tpu_torch.train import gn as _gn
from orp_tpu_torch.train.fit import FitConfig, fit_core, validate_shuffle
from orp_tpu_torch.train.gn import GNConfig, GNPinballConfig, fit_gn, fit_gn_pinball
from orp_tpu_torch.train.losses import mae, make_loss, mape, mse
from orp_tpu_torch.utils import checkpoint as _ckpt
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.precision import full_f32, typed_scalar

#: versions the on-disk state layout and the fingerprint's field set of a
#: checkpoint directory (the JAX package's are "increment-v<N>", orbax's)
CKPT_FORMAT = "torch-increment-v1"
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
    fused: bool = False  # the whole walk with no host read between dates (module docstring)
    nan_guard: bool = False  # per-date NaN/Inf sentinel and the trainer ladder
    nan_retries: int = 2  # the ladder's budget per date (nan_guard only)

    def __post_init__(self):
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


def _adam_cfg(cfg: BackwardConfig, first: bool) -> FitConfig:
    return FitConfig(
        n_epochs=cfg.epochs_first if first else cfg.epochs_warm, batch_size=cfg.batch_size,
        patience=cfg.patience_first if first else cfg.patience_warm,
        lr=cfg.lr if (first or cfg.lr is not None) else cfg.warm_lr, shuffle=cfg.shuffle)


def _gn_cfgs(cfg: BackwardConfig, n_iters: int) -> tuple[GNConfig, GNPinballConfig]:
    return (GNConfig(n_iters=n_iters, block_rows=cfg.gn_block_rows),
            GNPinballConfig(n_iters=n_iters, q=cfg.quantile, block_rows=cfg.gn_block_rows))


def _leg_fits(model, cfg: BackwardConfig, feats_t, prices_t1, target, step_i: int, *,
              gauss_newton: bool, gn_quantile: bool, programs: dict | None = None,
              mesh=None):
    """The date's two trainers ``(fit_fn, q_fit_fn)``, each ``params -> (params,
    aux)`` on the date's regression (features at t, prices at t+1): Adam
    (``fit_core``, its orders from :func:`_fit_generator`) or Gauss-Newton
    (``fit_gn`` / ``fit_gn_pinball``), the MSE leg with the readout solve when
    ``cfg.final_solve``. ``programs`` (the fused walk) holds the GN legs'
    :func:`~orp_tpu_torch.train.gn.gn_program` s, refilled by
    ``gn.refit``; with it Adam runs sync-free. ``mesh``: every fit reduces
    over the mesh's global paths."""
    first = step_i == 0
    n_iters = cfg.gn_iters_first if first else cfg.gn_iters_warm
    q_loss = make_loss(cfg.quantile_loss, q=cfg.quantile)
    fused = programs is not None
    gn_cfg, gnq_cfg = _gn_cfgs(cfg, n_iters)

    def adam(leg: int, loss_fn, **kw):
        return lambda p: fit_core(model, p, feats_t, prices_t1, target,
                                  _fit_generator(cfg.seed, step_i, leg), loss_fn=loss_fn,
                                  cfg=_adam_cfg(cfg, first), sync_free=fused, mesh=mesh,
                                  **kw)

    def gauss_newton_leg(key: str, plain, leg_cfg, final_solve: bool = False, **loss):
        if fused:
            return lambda p: _gn.refit(programs[key], p, feats_t, prices_t1, target,
                                       n_iters=n_iters, final_solve=final_solve)
        return lambda p: plain(model, p, feats_t, prices_t1, target, cfg=leg_cfg,
                               final_solve=final_solve, mesh=mesh, **loss)

    if gauss_newton:
        fit_fn = gauss_newton_leg("mse", fit_gn, gn_cfg, cfg.final_solve)
    else:
        fit_fn = adam(0, mse, metric_fns=(mae, mape),
                      solve_fn=(functools.partial(model.solve_readout, mesh=mesh)
                                if cfg.final_solve else None))
    # the quantile leg never receives the least-squares readout solve
    if gauss_newton and gn_quantile:
        q_fit_fn = gauss_newton_leg("q", fit_gn_pinball, gnq_cfg, loss_fn=q_loss)
    else:
        q_fit_fn = adam(1, q_loss)
    return fit_fn, q_fit_fn


def _date_body(model, cfg: BackwardConfig, params1, params2, feats_t, prices_t, prices_t1,
               target, fit_fn, q_fit_fn, *, outputs_fn=_date_outputs_core):
    """One backward date: the MSE fit, the quantile fit (``dual_mode``
    semantics, the shared-weights ``g_pre`` snapshot, RP.py:212-217 order),
    then the date's outputs (``outputs_fn``: :func:`_date_outputs_core`,
    spanned on the host loop under telemetry). The one definition of the date
    body: the host loop, the fused walk and the guard's Gauss-Newton rung pass
    their trainers. Returns ``(params1, params2, v_t, comb, var_resid, aux,
    q_aux)`` (``q_aux`` None under ``mse_only``)."""
    params1, aux = fit_fn(params1)
    g_pre, q_aux = None, None
    if cfg.dual_mode == "mse_only":
        params2 = params1
    else:
        if cfg.dual_mode == "shared":
            # the MSE fit's value, before the quantile fit moves the shared
            # weights (RP.py:212-217 order); a device tensor, no host read
            g_pre = model.value(params1, feats_t, prices_t)
            params2 = params1
        params2, q_aux = q_fit_fn(params2)
        if cfg.dual_mode == "shared":
            params1 = params2
    v_t, comb, var_resid = outputs_fn(
        model, params1, params2, feats_t, prices_t, prices_t1, target, cfg.cost_of_capital,
        g_pre, dual_mode=cfg.dual_mode, holdings_combine=cfg.holdings_combine)
    return params1, params2, v_t, comb, var_resid, aux, q_aux


def _final_solve_date(model, cfg: BackwardConfig, params0, feats_t, prices_t, prices_t1,
                      target, mesh=None, *, outputs_fn=_date_outputs_core):
    """The ladder's terminal rung: the PRE-FIT ``params0`` with its readout
    replaced by the closed-form ridge optimum (``model.solve_readout``), the
    solved params for both legs, the outputs combined as ``mse_only`` (the
    dual combine collapses when the legs share params). Returns the
    :func:`_date_body` tuple; the quantile leg's record is the pinball loss of
    the solved params and no iterations."""
    solved = model.solve_readout(params0, feats_t, prices_t1, target, mesh=mesh)
    pred = model.value(solved, feats_t, prices_t1)
    zero = torch.zeros((), dtype=torch.int64, device=pred.device)
    aux = {"final_loss": path_mean(mse(pred, target), mesh),
           "mae": path_mean(mae(pred, target), mesh),
           "mape": path_mean(mape(pred, target), mesh), "n_epochs_ran": zero}
    q_aux = None
    if cfg.dual_mode != "mse_only":
        q_loss = make_loss(cfg.quantile_loss, q=cfg.quantile)
        q_aux = {"final_loss": path_mean(q_loss(pred, target), mesh), "n_epochs_ran": zero}
    v_t, comb, var_resid = outputs_fn(
        model, solved, solved, feats_t, prices_t, prices_t1, target, cfg.cost_of_capital, None,
        dual_mode="mse_only", holdings_combine=cfg.holdings_combine)
    return solved, solved, v_t, comb, var_resid, aux, q_aux


def _date_finite(state, mesh=None) -> torch.Tensor:
    """The sentinel's per-date flag (a device tensor): the loss, both param sets
    and every ledger column the date contributes are finite, on every rank of
    ``mesh`` (the ranks' flags summed: a replicated decision)."""
    params1, params2, v_t, comb, var_resid, aux, _ = state
    flag = _sentinel.finite_flag(aux["final_loss"], params1, params2, v_t, comb, var_resid)
    if mesh is None:
        return flag
    return path_sum(flag.to(v_t.dtype).reshape(1), mesh)[0] == mesh.size()


def _degrade_date(model, cfg: BackwardConfig, pre1, pre2, feats_t, prices_t, prices_t1,
                  target, step_i: int, t: int, mesh=None):
    """The sentinel fired at date ``t``: walk the trainer ladder from the
    PRE-FIT params on a sanitized target until a rung gives finite state, at
    most ``cfg.nan_retries`` rungs; running dry raises rather than let every
    earlier date train on garbage. Returns the :func:`_date_body` tuple.
    Under telemetry the refits are spanned like the host loop's and the
    sanitized rows counted (``guard/target_sanitized{date}``)."""
    _sentinel.record_nan_event(t, cfg.optimizer, "post-fit date state")
    target, n_bad = _sentinel.sanitize_target(target, mesh)
    if n_bad:
        obs_count("guard/target_sanitized", n_bad, date=str(t))
    ladder = _sentinel.degradation_ladder(cfg.optimizer, cfg.nan_retries)
    outputs_fn = obs_spanned("train/outputs", _date_outputs_core)
    for rung in ladder:
        _sentinel.record_degrade(t, rung)
        if rung == "gauss_newton":
            fit_fn, q_fit_fn = _leg_fits(model, cfg, feats_t, prices_t1, target, step_i,
                                         gauss_newton=True, gn_quantile=True, mesh=mesh)
            state = _date_body(model, cfg, pre1, pre2, feats_t, prices_t, prices_t1, target,
                               obs_spanned("train/fit", fit_fn),
                               obs_spanned("train/fit_quantile", q_fit_fn),
                               outputs_fn=outputs_fn)
        else:  # "final_solve": the closed-form terminal rung
            state = _final_solve_date(model, cfg, pre1, feats_t, prices_t, prices_t1, target,
                                      mesh, outputs_fn=outputs_fn)
        if bool(_date_finite(state, mesh)):
            return state
        _sentinel.record_nan_event(t, rung, "degraded retry")
    raise RuntimeError(
        f"guard: backward date {t} is still non-finite after the trainer ladder {ladder} "
        f"(nan_retries={cfg.nan_retries}) — refusing to continue: every earlier date would "
        "train on this garbage. Raise nan_retries or inspect the walk's inputs.")


def _metrics_row(aux, q_aux, dtype) -> torch.Tensor:
    """The date's fit metrics as one device row: final loss, mae, mape and
    epochs / accepted iterations, then the quantile leg's final loss and count."""
    row = [aux["final_loss"], aux["mae"], aux["mape"], aux["n_epochs_ran"]]
    if q_aux is not None:
        row += [q_aux["final_loss"], q_aux["n_epochs_ran"]]
    return torch.stack([torch.as_tensor(x).to(dtype) for x in row])


def _fused_programs(model, cfg: BackwardConfig, feats, prices_t1, target, mesh=None) -> dict:
    """Every program the fused walk's fits replay, built (and on a CUDA device
    captured) before its date loop, from the first date's shapes: the GN legs'
    ``gn_program`` s, one per leg for both the first and the warm dates, and
    Adam's epoch programs (``fit.prepare``)."""
    graphs = target.device.type == "cuda"
    programs = {}
    dual = cfg.dual_mode != "mse_only"
    gauss_newton = cfg.optimizer == "gauss_newton"
    if gauss_newton:
        gn_cfg, gnq_cfg = _gn_cfgs(cfg, max(cfg.gn_iters_first, cfg.gn_iters_warm))
        programs["mse"] = _gn.gn_program(model, feats, prices_t1, target, gn_cfg,
                                         graphs=graphs, mesh=mesh)
        cuda_build.count_site("walk_program")
        if dual and cfg.gn_quantile:
            programs["q"] = _gn.gn_program(
                model, feats, prices_t1, target, gnq_cfg, graphs=graphs,
                loss_fn=make_loss(cfg.quantile_loss, q=cfg.quantile), mesh=mesh)
            cuda_build.count_site("walk_program")
    adam_legs = [] if gauss_newton else [mse]
    if dual and not (gauss_newton and cfg.gn_quantile):
        adam_legs.append(make_loss(cfg.quantile_loss, q=cfg.quantile))
    for loss_fn in adam_legs:
        for first in (True, False):
            _fit.prepare(model, feats, prices_t1, target, loss_fn=loss_fn,
                         cfg=_adam_cfg(cfg, first), mesh=mesh)
            cuda_build.count_site("walk_program")
    return programs


def fused_loop_scope(device: torch.device):
    """The context the fused walk's date loop runs in: none. A check that the
    loop reads nothing back replaces this function, for example with
    ``utils/measure.no_host_sync``; the library sets no sync-debug mode
    itself, since that mode holds for every thread of the process."""
    return contextlib.nullcontext()


def _fingerprint(model, cfg: BackwardConfig, n_paths: int, n_dates: int, warm) -> str:
    """The run's identity for its checkpoint directory: the config (less
    ``checkpoint_dir``, whose spelling may vary, and ``fused``, which the host
    loop never is), the shapes, the model, the GN configs' reprs (their
    defaults are training policy outside the config), the port's format tag
    and, for a warm start, its params' digest. Neither the device nor the mesh
    is in it (``n_paths`` is the global count): the layout names neither, and a
    walk saved on D ranks resumes on any topology."""
    fp_cfg = dataclasses.replace(cfg, checkpoint_dir=None, fused=False)
    warm_tag = "" if warm is None else " warm=" + _ckpt.state_digest(warm)[:16]
    return (f"{fp_cfg} n_paths={n_paths} n_dates={n_dates} model={model} "
            f"gn={GNConfig(n_iters=0)} gnq={GNPinballConfig(n_iters=0)} "
            f"ckpt_format={CKPT_FORMAT}{warm_tag}")


def backward_induction(model, features: torch.Tensor, y_prices: torch.Tensor,
                       b_prices: torch.Tensor, terminal_values: torch.Tensor,
                       cfg: BackwardConfig, *, bias_init: tuple[float, ...] | None = None,
                       initial_params=None, mesh=None) -> BackwardResult:
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
    :func:`_fit_generator`. ``cfg.fused``, ``cfg.checkpoint_dir`` and
    ``cfg.nan_guard``: the module docstring. ``mesh`` (a paths mesh, a rank
    count or a ``MeshSpec``): the inputs are this rank's block of the paths,
    and so are the returned ledgers. Under a telemetry session the walk is
    spanned and records its convergence (the module docstring); the result
    is bitwise the same either way."""
    mesh = as_mesh(mesh, y_prices.device)
    args = (model, features, y_prices, b_prices, terminal_values, cfg)
    if not obs_enabled():
        return _walk_impl(*args, bias_init=bias_init, initial_params=initial_params, mesh=mesh)
    with obs_span("train/walk", attrs={
        "n_paths": int(y_prices.shape[0]) * mesh_size(mesh),
        "n_dates": int(y_prices.shape[1]) - 1,
        "fused": cfg.fused, "optimizer": cfg.optimizer,
        "dual_mode": cfg.dual_mode,
        "mesh_devices": mesh_size(mesh),
    }) as sp:
        res = _walk_impl(*args, bias_init=bias_init, initial_params=initial_params, mesh=mesh)
        sp.set_result(res.values)
    _emit_convergence(res, cfg, model, features, y_prices, b_prices)
    return res


def _emit_convergence(res: BackwardResult, cfg: BackwardConfig, model, features, y_prices,
                      b_prices) -> None:
    """The walk's convergence telemetry (telemetered walks only), after the
    walk and without touching ``res``: ONE ``train/convergence`` record with
    the per-date loss / mae / mape trajectories, the epochs or accepted GN
    iterations of each date's MSE fit and the configured trainer (the
    sentinel's ``guard/degrade{date,to}`` events overlay the rungs a date
    took; ``obs/report.load_convergence`` merges them) and, for Gauss-Newton
    walks, the condition number of each date's Gram at its fitted params
    (``gn.gram_cond`` on the date's first ``min(2048, paths)`` rows, rounded
    to 3 decimals as the JAX package rounds it), each also a
    ``train/gram_cond{date}`` gauge.

    It enters no collective. The metrics are replicated, so every rank of a
    mesh records the same trajectories; each rank computes the Gram
    conditioning on the first rows of its own block. The first rank holds
    global rows 0..2047 whenever its block has at least ``min(2048, global
    paths)`` rows, and then records the unsharded run's numbers; the other
    ranks record their own block's conditioning."""
    payload = {
        "optimizer": cfg.optimizer,
        "dual_mode": cfg.dual_mode,
        "fused": bool(cfg.fused),
        "nan_guard": bool(cfg.nan_guard),
        "n_dates": int(res.train_loss.shape[0]),
        "train_loss": [float(x) for x in res.train_loss],
        "train_mae": [float(x) for x in res.train_mae],
        "train_mape": [float(x) for x in res.train_mape],
        "epochs_ran": [int(x) for x in res.epochs_ran],
    }
    if cfg.optimizer == "gauss_newton" and res.params1_by_date is not None:
        dtype = model.dtype
        m = min(int(y_prices.shape[0]), 2048)
        prices_all = _stack_prices(y_prices[:m].to(dtype),
                                   b_prices.to(device=y_prices.device, dtype=dtype))
        conds = []
        for d in range(payload["n_dates"]):
            # the Gram the date's fit solved: features at t, prices at t+1
            c = _gn.gram_cond(model, date_params(res.params1_by_date, d), features[:m, d],
                              prices_all[:, d + 1])
            conds.append(round(float(c), 3))
            obs_set_gauge("train/gram_cond", float(c), date=str(d))
        payload["gram_cond"] = conds
    obs_emit_record("train/convergence", payload)


def _walk_impl(model, features: torch.Tensor, y_prices: torch.Tensor, b_prices: torch.Tensor,
               terminal_values: torch.Tensor, cfg: BackwardConfig, *, bias_init, initial_params,
               mesh) -> BackwardResult:
    """The walk itself (:func:`backward_induction`, ``mesh`` built)."""
    full_f32()
    dev, dtype = y_prices.device, model.dtype
    n_paths, n_knots = y_prices.shape[:2]
    n_dates = n_knots - 1
    if cfg.fused and mesh is not None and dev.type == "cuda":
        backend = dist_backend(mesh)
        if backend != "nccl":
            raise ValueError(
                f"fused=True captures each LM iteration with its all_reduce as a CUDA graph; "
                f"the mesh's {backend!r} backend cannot be captured (use NCCL, or the host "
                "loop fused=False)")
    rows_here = shard_rows(n_paths * mesh_size(mesh), mesh)
    first_rank = mesh_rank(mesh) == 0
    params1, params2 = _initial_params(model, cfg, bias_init, initial_params, dev, dtype)
    warm = None if initial_params is None else {"p1": params1, "p2": params2}
    prices_all = _stack_prices(y_prices.to(dtype), b_prices.to(device=dev, dtype=dtype))
    values = torch.zeros((n_paths, n_knots), dtype=dtype, device=dev)
    values[:, -1] = terminal_values.to(dtype)
    dual = cfg.dual_mode != "mse_only"
    n_metrics = 6 if dual else 4
    # the ledgers, per-date params and fit metrics, written date by date (the
    # walk visits t downward; every one is indexed by date, ascending)
    rows = torch.empty((n_dates, n_metrics), dtype=dtype, device=dev if cfg.fused else "cpu")
    ledgers = {}
    snaps1 = {k: torch.empty((n_dates, *v.shape), dtype=dtype, device=dev)
              for k, v in params1.items()}
    snaps2 = ({k: torch.empty_like(v) for k, v in snaps1.items()}
              if cfg.dual_mode == "separate" else None)

    def record(t, p1, p2, v_t, phi_t, psi_t, var_resid):
        values[:, t] = v_t
        for name, col in (("phi", phi_t), ("psi", psi_t), ("var", var_resid)):
            if name not in ledgers:
                ledgers[name] = torch.empty((n_paths, n_dates, *col.shape[1:]), dtype=col.dtype,
                                            device=dev)
            ledgers[name][:, t] = col
        for snaps, p in ((snaps1, p1), (snaps2, p2)):
            for k, v in (p.items() if snaps is not None else ()):
                snaps[k][t] = v

    metric_keys = ["train_loss", "train_mae", "train_mape", "epochs_ran"]
    if dual:
        metric_keys += ["quantile_loss", "quantile_epochs_ran"]
    start_step = 0
    if cfg.checkpoint_dir is not None:
        fp = _fingerprint(model, cfg, n_paths * mesh_size(mesh), n_dates, warm)
        # the first rank writes a new directory's fingerprint, the others then
        # check it, and a refusal on the first rank reaches every rank (a rank
        # that raised alone would leave the others waiting in a collective);
        # the resume point is the first rank's, so every rank agrees
        refused = None
        if first_rank:
            try:
                _ckpt.check_fingerprint(cfg.checkpoint_dir, fp)
            except ValueError as e:
                refused = e
        if not replicate_from_first(float(refused is None), mesh, dev):
            raise refused or ValueError(
                f"checkpoint directory {cfg.checkpoint_dir}: the first rank refused its "
                "run fingerprint")
        if not first_rank:
            _ckpt.check_fingerprint(cfg.checkpoint_dir, fp)
        last = _ckpt.latest_complete_step(cfg.checkpoint_dir) if first_rank else None
        last = int(replicate_from_first(-1.0 if last is None else float(last), mesh, dev))
        if last >= 0:
            # each step holds its own date's increment: replay 0..last to rebuild
            # the ledgers (a missing or corrupt step raises in the loader)
            for i, st in enumerate(_ckpt.load_checkpoints(cfg.checkpoint_dir, range(last + 1))):
                params1 = params_to(st["params1"], dev, dtype)
                params2 = params_to(st["params2"], dev, dtype)
                record(n_dates - 1 - i, params1, params2,
                       *(torch.from_numpy(st[k][rows_here]).to(dev)
                         for k in ("v_col", "phi_col", "psi_col", "var_col")))
                rows[n_dates - 1 - i] = torch.tensor([float(st[k]) for k in metric_keys],
                                                     dtype=dtype)
            if cfg.dual_mode != "separate":
                params2 = params1
            start_step = last + 1

    programs = (_fused_programs(model, cfg, features[:, n_dates - 1], prices_all[:, n_dates],
                                values[:, n_dates], mesh) if cfg.fused else None)
    gauss_newton = cfg.optimizer == "gauss_newton"
    with fused_loop_scope(dev) if cfg.fused else contextlib.nullcontext():
        for step_i, t in enumerate(range(n_dates - 1, -1, -1)):
            if step_i < start_step:
                continue
            feats_t, prices_t, prices_t1 = features[:, t], prices_all[:, t], prices_all[:, t + 1]
            target = values[:, t + 1]
            inj = None if cfg.fused else _inject.active()
            if inj is not None:
                # may NaN-poison the date's LOCAL target; values[:, t+1] stays clean
                target = inj.corrupt_target(step_i, target)
            fit_fn, q_fit_fn = _leg_fits(model, cfg, feats_t, prices_t1, target, step_i,
                                         gauss_newton=gauss_newton, gn_quantile=cfg.gn_quantile,
                                         programs=programs, mesh=mesh)
            outputs_fn = _date_outputs_core
            if not cfg.fused:
                # the host loop's per-date spans (each the callable itself with
                # telemetry off); the fused walk's date loop records nothing
                fit_fn = obs_spanned("train/fit", fit_fn)
                q_fit_fn = obs_spanned("train/fit_quantile" if gauss_newton else "train/fit",
                                       q_fit_fn)
                outputs_fn = obs_spanned("train/outputs", outputs_fn)
            state = _date_body(model, cfg, params1, params2, feats_t, prices_t, prices_t1,
                               target, fit_fn, q_fit_fn, outputs_fn=outputs_fn)
            row = _metrics_row(state[5], state[6], dtype)
            if cfg.fused:
                rows[t] = row
            else:
                if cfg.nan_guard:
                    row = torch.cat([row, _date_finite(state, mesh).to(dtype)[None]])
                row = row.cpu()  # the date's one host read (with the guard's flag)
                if cfg.nan_guard and not bool(row[-1]):
                    state = _degrade_date(model, cfg, params1, params2, feats_t, prices_t,
                                          prices_t1, target, step_i, t, mesh)
                    row = _metrics_row(state[5], state[6], dtype).cpu()
                rows[t] = row[:n_metrics]
            params1, params2, v_t, comb, var_resid = state[:5]
            phi_t, psi_t = _split_holdings(comb)
            record(t, params1, params2, v_t, phi_t, psi_t, var_resid)
            if cfg.checkpoint_dir is not None:
                # per-date increments only: O(paths) a save, not the walk so far;
                # under a mesh the columns are gathered and the first rank writes
                cols = {k: path_gather(v, mesh) for k, v in (
                    ("v_col", v_t), ("phi_col", phi_t), ("psi_col", psi_t),
                    ("var_col", var_resid))}
                if first_rank:
                    inc = {"params1": params1, "params2": params2, **cols}
                    inc.update(zip(metric_keys, rows[t]))
                    _ckpt.save_checkpoint(cfg.checkpoint_dir, step_i, inc)
                if inj is not None:
                    inj.maybe_kill(step_i)  # a synthetic kill after the date's save
    m = rows.cpu().double().numpy()  # orp: noqa[ORP001] -- the fused walk's one host read: its per-date metrics as f64 host rows
    return BackwardResult(
        values=values, phi=ledgers["phi"], psi=ledgers["psi"], var_residuals=ledgers["var"],
        train_loss=m[:, 0], train_mae=m[:, 1], train_mape=m[:, 2],
        epochs_ran=m[:, 3].astype(np.int64), params1=params1, params2=params2,
        params1_by_date=snaps1, params2_by_date=snaps2,
        quantile_loss=m[:, 4] if dual else None,
        quantile_epochs_ran=m[:, 5].astype(np.int64) if dual else None)
