"""Levenberg-Marquardt-damped Gauss-Newton fits of the walk's two legs (counterpart of ``orp_tpu/train/gn.py``).

The per-date fit is a ~100-parameter nonlinear problem over up to 1M
samples. Each iteration is one large product pair

    G = J^T W J / n   (P x P weighted Gram of the per-sample value gradients)
    b = J^T W r / n   (normal-equations right-hand side, r = pred - y)

then a damped solve ``(G + (lam * mean(diag G) + ridge) I) delta = b``, the
candidate ``theta - delta`` and its TRUE loss: the step is taken only if the
loss falls (damping down), else rejected (damping up). An accepted step that
improves the loss by less than ``min_rel_improve`` freezes the fit.

- :func:`fit_gn`, the MSE leg: ``W = I``, plain damped Gauss-Newton.
- :func:`fit_gn_pinball`, the 0.99-quantile leg (reference model2,
  RP.py:138-142): IRLS. The pinball loss is an asymmetric L1, so each
  iteration solves the weighted least squares that majorises it at the
  current residuals, ``w = a(r) / max(|r|, floor)`` with ``a = q`` where
  ``r = pred - y < 0`` and ``1 - q`` elsewhere; accept/reject runs on the
  true (smoothed) pinball loss. The weights span three decades (at q = 0.99
  about 1% of rows carry the upper branch).

The loop stays on the device: accept/reject and the freeze are
``torch.where`` selections on 0-d tensors and the solve is
``torch.linalg.solve_ex`` (no error check, so no host sync); nothing is read
back per iteration. A frozen iteration still computes its step (no host
branch can skip it without a sync) but leaves theta, the damping and the
loss unchanged and records ``inf`` in ``loss_history``, as the JAX
``skip`` branch does. The problem object owns that state (and its
buffers), advanced in place by one iteration, so the fused walk captures an
iteration once as a CUDA graph and replays it on each date's data
(:func:`gn_program`, :func:`refit`). :func:`gram_cond` is the Gram's
condition number, the JAX package's convergence diagnostic.

``J`` is the closed-form per-sample gradient (``HedgeMLP.value_jacobian``),
one ``(n, P)`` buffer reused across iterations (456 MB at 1M paths and
P = 114), or ``(block_rows, P)`` when ``block_rows`` accumulates the Gram
over row blocks; the IRLS leg writes ``J w`` into a second buffer of the
same shape (JAX's order: weight J, then the product). Products run in full
f32 (``utils/precision.full_f32``):
normal equations square the condition number, and a reduced-precision Gram
moved the north-star price by -2.4bp on the TPU (SCALING.md §6b); TF32 is
the same hazard on this card.

Under a paths mesh (``mesh``, ``parallel/mesh.py``) each rank holds its block
of the rows: the Gram and right-hand side are each rank's means over its
block, summed across the ranks by one ``all_reduce`` an iteration and divided
by the rank count (the global means over equal shards), and every loss is
the mean of the ranks' means. The IRLS weights stay row-local. Everything the
iteration decides on is then replicated, and ``iterate`` stays capturable:
the ``all_reduce`` is issued on the capturing stream (NCCL; the warm-up
before the capture runs it once, so the communicator exists).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from orp_tpu_torch.parallel.mesh import mesh_rank, mesh_size, path_mean, path_means, path_sum
from orp_tpu_torch.train.losses import mae, mape, mse
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class GNConfig:
    n_iters: int = 12
    init_lambda: float = 1e-4      # LM damping, relative to mean(diag(G))
    lambda_up: float = 3.0
    lambda_down: float = 1 / 3
    min_rel_improve: float = 1e-7  # freeze once an accepted step gains less
    ridge: float = 1e-9            # absolute floor added to the damped diagonal
    block_rows: int | None = None  # accumulate the Gram over row blocks of this
    # size instead of materialising the (n, P) Jacobian; must divide n


@dataclasses.dataclass(frozen=True)
class GNPinballConfig(GNConfig):
    """IRLS weights of the quantile leg, ``w = a(r) / max(|r|, weight_floor)``;
    the floor caps the weight of near-zero residuals (the smoothed pinball's
    kink half-width). LM starts more cautiously than the MSE leg's 1e-4: the
    asymmetric-L1 majoriser is a rougher model than the MSE's quadratic."""

    q: float = 0.99
    weight_floor: float = 1e-3
    init_lambda: float = 1e-2


class _GNProblem:
    """One date's regression ``value(theta; features, prices) ~ targets`` under
    ``loss_fn``, and the LM state that the iterations advance; ``weights``,
    when given, are the IRLS weights ``(q_hi, q_lo, floor)`` of the pinball leg.

    Every buffer is allocated here, once: the Jacobian ``J`` (and ``Jw``), the
    eye, and the state (``theta``, the damping ``lam``, ``best_loss``,
    ``frozen``, the accepted count ``takes``, and ``hist``, ``cfg.n_iters``
    entries of loss history written at the counter ``it``, which stops at the
    last entry: iterations past the history overwrite it). With
    ``static=False`` the problem reads the caller's ``features``, ``prices``
    and ``targets`` (a host-loop fit); with ``static=True`` it owns contiguous
    copies that :meth:`load` refills per date, so that an iteration captured
    by :meth:`capture` (a CUDA graph) replays on whatever a date wrote into
    them. ``mesh``: the rows are this rank's block of a paths mesh."""

    def __init__(self, model, features, prices, targets, cfg: GNConfig, loss_fn=mse,
                 weights: tuple[float, float, float] | None = None, *, static: bool = False,
                 mesh=None):
        self.model, self.cfg, self.loss_fn, self.mesh = model, cfg, loss_fn, mesh
        y = targets.to(model.dtype)
        if static:
            like = lambda x: torch.empty_like(x, memory_format=torch.contiguous_format)  # noqa: E731
            self.features, self.prices, self.y = like(features), like(prices), like(y)
            self.load(features, prices, targets)
        else:
            self.features, self.prices, self.y = features, prices, y
        self.n = self.y.shape[0]
        block = cfg.block_rows
        self.block = block if block is not None and self.n > block else None
        if self.block is not None and self.n % self.block:
            # the knob exists to bound fit memory; a silent one-shot fallback
            # would allocate exactly the Jacobian it was set to avoid
            raise ValueError(f"block_rows={block} does not divide n={self.n} rows — pick a "
                             "divisor (n <= block_rows needs no blocking and is accepted)")
        dim, dt = model.n_params(), model.dtype
        dev = self.y.device
        rows = self.block or self.n
        self.J = torch.empty((rows, dim), dtype=dt, device=dev)
        self.eye = torch.eye(dim, dtype=dt, device=dev)
        self.Jw, self.w = None, None
        if weights is not None:
            self.Jw = torch.empty_like(self.J)
            q_hi, q_lo, self.floor = weights
            self.w = (torch.full((), q_hi, dtype=dt, device=dev),
                      torch.full((), q_lo, dtype=dt, device=dev))
        self.theta = torch.empty(dim, dtype=dt, device=dev)
        self.lam, self.best_loss = (torch.empty((), dtype=dt, device=dev) for _ in range(2))
        self.frozen = torch.zeros((), dtype=torch.bool, device=dev)
        self.it, self.takes = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
        self.hist = torch.empty(max(cfg.n_iters, 1), dtype=dt, device=dev)
        self.graph = None

    def load(self, features, prices, targets) -> None:
        """A date's inputs into the owned buffers (device-to-device copies)."""
        self.features.copy_(features)
        self.prices.copy_(prices)
        self.y.copy_(targets)

    def loss(self, theta: torch.Tensor) -> torch.Tensor:
        pred = self.model.value(self.model.unflatten(theta), self.features, self.prices)
        return path_mean(self.loss_fn(pred, self.y), self.mesh)

    def _weighted(self, J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """``J`` for the MSE leg; ``J * w[:, None]`` into the reused buffer for IRLS."""
        if self.w is None:
            return J
        a = torch.where(r < 0, *self.w)
        w = a / torch.clamp(torch.abs(r), min=self.floor)
        return torch.mul(J, w[:, None], out=self.Jw)

    def gram(self, theta: torch.Tensor):
        """``(Jw^T J / n, Jw^T r / n)`` over the global rows: this rank's means
        (:meth:`_local_gram`), then across the mesh in one ``all_reduce``."""
        return path_means(self.mesh, *self._local_gram(theta))

    def _local_gram(self, theta: torch.Tensor):
        """``(Jw^T J / n, Jw^T r / n)`` over this rank's rows, one-shot or summed
        over row blocks."""
        params = self.model.unflatten(theta)
        if self.block is None:
            v, J = self.model.value_jacobian(params, self.features, self.prices, out=self.J)
            r = v - self.y
            Jw = self._weighted(J, r)
            return Jw.T @ J / self.n, Jw.T @ r / self.n
        G, b = torch.zeros_like(self.eye), torch.zeros_like(theta)
        for s in range(0, self.n, self.block):
            rows = slice(s, s + self.block)
            v, J = self.model.value_jacobian(params, self.features[rows], self.prices[rows],
                                             out=self.J)
            r = v - self.y[rows]
            Jw = self._weighted(J, r)
            G += Jw.T @ J
            b += Jw.T @ r
        return G / self.n, b / self.n

    def start(self, theta: torch.Tensor) -> None:
        """The fit's first state: ``theta``, the initial damping, its loss."""
        self.theta.copy_(theta)
        self.lam.fill_(self.cfg.init_lambda)
        self.best_loss.copy_(self.loss(self.theta))
        for x in (self.frozen, self.it, self.takes):
            x.zero_()

    def iterate(self) -> None:
        """One LM iteration on the device state, in place: the damped step, its
        true loss, accept/reject and the freeze by ``torch.where``; the history
        entry (the post-accept loss, ``inf`` once frozen) lands at ``hist[it]``,
        and ``it`` advances no further than the history's last entry."""
        cfg, theta, lam, best_loss, frozen = (self.cfg, self.theta, self.lam, self.best_loss,
                                              self.frozen)
        G, b = self.gram(theta)
        diag_scale = torch.mean(torch.diagonal(G)) + cfg.ridge
        delta = torch.linalg.solve_ex(G + (lam * diag_scale + cfg.ridge) * self.eye, b)[0]
        cand = theta - delta
        cand_loss = self.loss(cand)
        take = (cand_loss < best_loss) & ~frozen
        rel_gain = (best_loss - cand_loss) / torch.clamp(best_loss, min=1e-30)
        frozen_next = frozen | (take & (rel_gain < cfg.min_rel_improve))
        new_best = torch.where(take, cand_loss, best_loss)
        lam_next = torch.clamp(torch.where(take, lam * cfg.lambda_down, lam * cfg.lambda_up),
                               1e-10, 1e10)
        new_lam = torch.where(frozen, lam, lam_next)
        h = torch.where(frozen, torch.full_like(new_best, float("inf")), new_best)
        theta.copy_(torch.where(take, cand, theta))
        best_loss.copy_(new_best)
        lam.copy_(new_lam)
        frozen.copy_(frozen_next)
        self.hist.index_copy_(0, self.it.view(1), h.view(1))
        self.takes.add_(take)
        self.it.add_(1).clamp_(max=self.hist.shape[0] - 1)

    def capture(self) -> None:
        """Warm one iteration up on a side stream, then capture it as a CUDA
        graph (the state it leaves is replaced by the next :meth:`start`)."""
        dev = self.theta.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.iterate()
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()  # orp: noqa[ORP007] -- times the capture itself: kernels are recorded, not launched, under torch.cuda.graph
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.iterate()
        cuda_build.count_capture(time.perf_counter() - t0, site="gn_iteration")

    def run(self, n_iters: int) -> None:
        for _ in range(n_iters):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.iterate()


def _fit(problem: _GNProblem, params: dict, final_solve: bool, n_iters: int, features, prices,
         targets):
    """The LM loop on the device from ``params``, then the result and its aux
    tensors, evaluated on the caller's ``features``, ``prices`` and ``targets``."""
    model = problem.model
    problem.start(model.flatten(params).to(device=problem.theta.device, dtype=model.dtype))
    problem.run(n_iters)
    best = model.unflatten(problem.theta.clone())
    y = targets.to(model.dtype)
    mesh = problem.mesh
    if final_solve:
        best = model.solve_readout(best, features, prices, y, mesh=mesh)
    pred = model.value(best, features, prices)
    aux = {
        "loss_history": problem.hist[:n_iters].clone(),
        "n_epochs_ran": problem.takes.clone(),
        "final_loss": path_mean(problem.loss_fn(pred, y), mesh),
        "mae": path_mean(mae(pred, y), mesh),
        "mape": path_mean(mape(pred, y), mesh),
    }
    aux["best_loss"] = aux["final_loss"] if final_solve else problem.best_loss.clone()
    return best, aux


def _pinball_weights(cfg: GNPinballConfig) -> tuple[float, float, float]:
    return cfg.q, 1.0 - cfg.q, cfg.weight_floor


def gn_program(model, features, prices, targets, cfg: GNConfig, *, loss_fn=mse,
               graphs: bool = False, mesh=None) -> _GNProblem:
    """A problem that owns its buffers, for fits run date after date with
    :func:`refit` (the fused walk): the MSE leg, or the IRLS pinball leg when
    ``cfg`` is a :class:`GNPinballConfig`. ``cfg.n_iters`` bounds the
    iterations of one fit. ``graphs`` (a CUDA device) captures one LM
    iteration as a CUDA graph, replayed ``n_iters`` times by each fit; a
    capture that fails raises. Under ``mesh`` the captured iteration holds
    its ``all_reduce`` (the first :meth:`_GNProblem.start` has run one)."""
    full_f32()
    weights = _pinball_weights(cfg) if isinstance(cfg, GNPinballConfig) else None
    problem = _GNProblem(model, features, prices, targets, cfg, loss_fn=loss_fn, weights=weights,
                         static=True, mesh=mesh)
    if graphs:
        problem.start(torch.zeros_like(problem.theta))
        problem.capture()
    return problem


def refit(problem: _GNProblem, params: dict, features, prices, targets, *, n_iters: int,
          final_solve: bool = False):
    """One fit on a :func:`gn_program`: the date's inputs copied into its
    buffers, ``n_iters`` iterations (graph replays where captured), and
    :func:`fit_gn`'s result and aux, with no host read."""
    if n_iters > problem.cfg.n_iters:
        raise ValueError(f"n_iters={n_iters} exceeds the program's cfg.n_iters="
                         f"{problem.cfg.n_iters}")
    problem.load(features, prices, targets)
    return _fit(problem, params, final_solve, n_iters, features, prices, targets)


def fit_gn(model, params: dict, features: torch.Tensor, prices: torch.Tensor,
           targets: torch.Tensor, *, loss_fn=mse, cfg: GNConfig = GNConfig(),
           final_solve: bool = False, mesh=None):
    """Fit ``model``'s value at ``(features, prices)`` to ``targets`` by damped GN.

    Returns ``(best_params, aux)``; ``aux`` holds device tensors:
    ``loss_history`` (per iteration, post-accept loss, ``inf`` past the
    freeze), ``n_epochs_ran`` (accepted iterations), ``best_loss``,
    ``final_loss`` and the ``mae`` / ``mape`` metrics at the result.
    ``final_solve`` replaces the readout with ``model.solve_readout`` after
    the iterations (``best_loss`` is then the final loss). ``mesh``: the
    rows are this rank's block of a paths mesh (module docstring)."""
    if loss_fn is not mse:
        # GN minimises mean squared residuals by construction; another loss
        # would be ignored by the iterations while aux reported it
        raise ValueError("fit_gn optimises the MSE only; got a different loss_fn "
                         "(the quantile leg uses fit_gn_pinball)")
    full_f32()
    return _fit(_GNProblem(model, features, prices, targets, cfg, mesh=mesh), params,
                final_solve, cfg.n_iters, features, prices, targets)


def fit_gn_pinball(model, params: dict, features: torch.Tensor, prices: torch.Tensor,
                   targets: torch.Tensor, *, loss_fn, cfg: GNPinballConfig = GNPinballConfig(),
                   final_solve: bool = False, mesh=None):
    """IRLS Gauss-Newton for the quantile (pinball) leg, with :func:`fit_gn`'s
    aux contract. ``loss_fn`` must be the pinball (or smoothed pinball) at
    ``cfg.q``: accept/reject optimises it, while the weighted normal
    equations supply the step. ``final_solve`` is refused: a least-squares
    readout is not the pinball optimum and would undo the fit."""
    if final_solve:
        raise ValueError("fit_gn_pinball: final_solve (closed-form least-squares readout) "
                         "does not apply to the pinball objective")
    full_f32()
    problem = _GNProblem(model, features, prices, targets, cfg, loss_fn=loss_fn,
                         weights=_pinball_weights(cfg), mesh=mesh)
    return _fit(problem, params, False, cfg.n_iters, features, prices, targets)


def gram_cond(model, params: dict, feats: torch.Tensor, prices: torch.Tensor, *,
              max_rows: int = 2048, mesh=None) -> float:
    """Condition number of the GN Gram ``J^T J / n`` at ``params`` over at most
    ``max_rows`` of the date's fit inputs, in full f32 (the matrix every GN
    iteration solves; normal equations square the condition number). The
    bottom eigenvalue is floored at ``top * 1e-12``: a spectrum wider than 12
    decades is numerically singular either way, and a capped 1e12 reads as
    that; a non-positive top eigenvalue gives ``inf``. Under ``mesh`` the rows
    are the first ``max_rows`` global rows, wherever they lie: each rank adds
    its part of them."""
    full_f32()
    n_local = feats.shape[0]
    lo = mesh_rank(mesh) * n_local
    n_rows = min(max_rows, n_local * mesh_size(mesh))
    take = max(0, min(n_local, n_rows - lo))
    _, J = model.value_jacobian(params, feats[:take], prices[:take])
    eigs = torch.linalg.eigvalsh(path_sum(J.T @ J, mesh) / n_rows).double().cpu()  # orp: noqa[ORP001] -- the Gram's eigenvalues (a diagnostic read once a fit) leave for the host in f64
    top = float(eigs[-1])
    if top <= 0.0:
        return float("inf")
    return top / max(float(eigs[0]), top * 1e-12)
