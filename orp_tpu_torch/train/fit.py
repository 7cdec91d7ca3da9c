"""Minibatch Adam with the reference's LR schedule and early stopping (counterpart of ``orp_tpu/train/fit.py``).

The reference's per-date Keras ``fit`` (``Replicating_Portfolio.py:203-211``):

- Adam (optax's formula: b1 0.9, b2 0.999, eps 1e-8 added after the square
  root of the bias-corrected second moment) with the step schedule of
  :func:`reference_lr_schedule` (RP.py:128-136), or a constant ``lr``;
- ``EarlyStopping(monitor='loss', patience, restore_best_weights=True)``
  (RP.py:174): ``(best_theta, best_loss, wait, stopped)`` carried in device
  tensors and updated by ``torch.where``, as the JAX package carries it
  through its scan;
- minibatches of ``batch_size`` rows, reshuffled every epoch
  (:func:`_epoch_order`).

Every minibatch step stays on the device: the params are one flat ``theta``
(``model.flatten``), Adam's two moments tensors of its shape, the LR and the
epoch's order device tensors, the gradient ``torch.autograd``'s. The host
reads ``stopped`` once per epoch, to stop looping; an epoch entered with
``stopped`` set leaves every tensor as it found it, so the result does not
depend on that read. Shapes are static, so on a CUDA device one epoch (the
gather of its rows, its steps and the early-stopping update) is captured
once as a CUDA graph and replayed; :data:`CUDA_GRAPHS` off runs the same
epoch eagerly. Each epoch's order is drawn on the host from the fit's
``torch.Generator``, so the card and the CPU given generators of one seed
train on the same orders.

``fit_core(..., sync_free=True)`` (the fused walk's fits) reads nothing from
the device: it runs all ``n_epochs`` epochs without reading ``stopped`` (an
epoch entered stopped changes nothing, so the result is the same), and on a
CUDA device stages each epoch's order through a ring of pinned host buffers
copied with ``non_blocking=True``, each slot guarded by a CUDA event so that
no buffer is rewritten before its copy has run. The host-loop fit copies the
order from pageable memory (a blocking copy, which syncs the stream).

Runs in full f32 (``utils/precision.full_f32``, no TF32): the counterpart of
the JAX package's ``@highest_matmul_precision``.

Under a paths mesh (``mesh``) each rank holds its block of the rows, and the
gradient means over a batch are global reductions, as in the JAX package:
every rank draws the same global epoch order from the same generator over
the global ``n``, gathers the ``batch_size`` rows of each batch at fixed
shape (a row another rank holds is read at a clamped index and weighted 0),
and sums its weighted per-row losses over the global batch size; one
``all_reduce`` a step sums the gradients and the batch loss across the ranks.
The early-stopping loss is then global, and so every rank stops together.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch

from orp_tpu_torch.parallel.mesh import mesh_rank, mesh_size, path_mean, path_sum
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.precision import full_f32

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0  # optax.adam's defaults
#: capture each epoch as a CUDA graph on a CUDA device (off: the same epoch
#: launched op by op; the walls of both are compared by tools/torch_adam_walk.py)
CUDA_GRAPHS = True
_MAX_PROGRAMS = 4  # captured epoch programs kept, one per shape and loss
_RING = 4  # pinned order buffers of a sync-free fit


def reference_lr_schedule(count_to_epoch: float = 1.0) -> Callable[[int], float]:
    """The reference's step schedule (RP.py:128-136) over epochs: 1e-2 below
    100, 1e-3 below 200, 5e-4 from 200 on."""

    def schedule(epoch) -> float:
        e = epoch * count_to_epoch
        return 1e-2 if e < 100 else 1e-3 if e < 200 else 5e-4

    return schedule


def validate_shuffle(shuffle: bool | str) -> bool | str:
    """Check a shuffle policy and turn the ``"full"`` alias into ``True``."""
    if isinstance(shuffle, str) and shuffle not in ("full", "blocks"):
        raise ValueError(f"shuffle={shuffle!r}: expected True/'full', 'blocks', or False")
    return True if shuffle == "full" else shuffle


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """``shuffle``: ``True`` (or ``"full"``) permutes all rows every epoch;
    ``"blocks"`` permutes only the order of fixed minibatches (the window of
    blocks slides by a random offset when ``batch_size`` does not divide n);
    ``False`` keeps the rows in order. ``lr=None`` is the reference schedule."""

    n_epochs: int = 100
    batch_size: int = 512
    patience: int = 7
    min_delta: float = 0.0
    shuffle: bool | str = True
    lr: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "shuffle", validate_shuffle(self.shuffle))


def _epoch_order(generator: torch.Generator, n: int, bs: int, shuffle: bool | str):
    """One epoch's order, drawn on the host: ``(perm, order, offset)``.

    ``True``: ``perm`` a permutation of the n rows cut to the ``n_used`` that
    fill whole batches, ``order`` the batches in turn; ``"blocks"``: no
    ``perm``, ``order`` a permutation of the batches and ``offset`` the start
    of the window of blocks (drawn only when the batches leave rows over)."""
    n_batches = max(n // bs, 1)
    n_used = n_batches * bs
    if shuffle == "blocks":
        order = torch.randperm(n_batches, generator=generator)
        offset = (int(torch.randint(0, n - n_used + 1, (), generator=generator))
                  if n_used < n else 0)
        return None, order, offset
    return torch.randperm(n, generator=generator)[:n_used], torch.arange(n_batches), 0


class _EpochProgram:
    """The device state of one fit and the epoch that advances it.

    The fit's inputs and state live in this object's tensors, so a captured
    epoch replays on whatever :meth:`load` wrote into them."""

    def __init__(self, model, loss_fn, cfg: FitConfig, n: int, bs: int, features, prices,
                 targets, graphs: bool = False, mesh=None):
        dev, dt = targets.device, model.dtype
        self.mesh, self.n_local = mesh, targets.shape[0]
        self.lo = mesh_rank(mesh) * self.n_local  # this rank's first global row
        self.graphs = graphs  # capture the epoch at the first fit
        self.model, self.loss_fn, self.cfg, self.bs = model, loss_fn, cfg, bs
        self.n_batches = max(n // bs, 1)
        n_used = self.n_batches * bs
        self.keys = list(model.param_shapes())
        self.features = torch.empty_like(features, memory_format=torch.contiguous_format)
        self.prices = torch.empty_like(prices, memory_format=torch.contiguous_format)
        self.targets = torch.empty_like(targets, memory_format=torch.contiguous_format)
        P = model.n_params()
        self.theta, self.mu, self.nu, self.best_theta = (
            torch.empty(P, dtype=dt, device=dev) for _ in range(4))
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.best_loss = torch.empty((), dtype=targets.dtype, device=dev)
        self.wait = torch.zeros((), dtype=torch.int32, device=dev)
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.neg_lr = torch.zeros((), dtype=dt, device=dev)
        self.betas = torch.empty(2, dtype=torch.float64, device=dev)  # orp: noqa[ORP001] -- Adam's bias corrections in f64, as optax computes them; filled, not copied:
        self.betas[0].fill_(B1)  # a host-to-device copy would sync the stream
        self.betas[1].fill_(B2)
        self.losses = torch.empty(self.n_batches, dtype=targets.dtype, device=dev)
        self.epoch_loss = torch.empty((), dtype=targets.dtype, device=dev)
        self.order = torch.arange(self.n_batches, device=dev)
        self.offset = torch.zeros((), dtype=torch.int64, device=dev)
        self.perm = (torch.arange(n_used, device=dev) if cfg.shuffle is True else None)
        self.all_rows = torch.arange(n_used, device=dev) if mesh is not None else None
        self.cols = torch.arange(bs, device=dev)
        self.graph = None
        self._ring, self._slot = None, 0

    def load(self, theta, features, prices, targets) -> None:
        """The fit's inputs and its first state: Adam's moments at 0, no best yet."""
        self.features.copy_(features)
        self.prices.copy_(prices)
        self.targets.copy_(targets)
        self.theta.copy_(theta)
        self.best_theta.copy_(theta)
        for t in (self.mu, self.nu, self.count, self.wait, self.stopped):
            t.zero_()
        self.best_loss.fill_(float("inf"))

    def set_order(self, perm, order, offset: int) -> None:
        if perm is not None:
            self.perm.copy_(perm)
        self.order.copy_(order)
        self.offset.fill_(offset)

    def stage_order(self, perm, order, offset: int) -> None:
        """:meth:`set_order` without a host sync: on a CUDA device the order
        goes through the next pinned ring slot, copied with ``non_blocking=True``;
        the slot's event, recorded after its last copy, is waited on first."""
        if self.theta.device.type != "cuda":
            self.set_order(perm, order, offset)
            return
        if self._ring is None:
            pin = lambda x: None if x is None else torch.empty_like(x).pin_memory()  # noqa: E731
            self._ring = [(pin(perm), pin(order), torch.cuda.Event()) for _ in range(_RING)]
        pp, po, ev = self._ring[self._slot]
        self._slot = (self._slot + 1) % _RING
        ev.synchronize()
        if perm is not None:
            pp.copy_(perm)
            self.perm.copy_(pp, non_blocking=True)
        po.copy_(order)
        self.order.copy_(po, non_blocking=True)
        ev.record()
        self.offset.fill_(offset)

    def _batches(self):
        """The epoch's rows as ``(n_batches, bs, ...)`` features, prices,
        targets, and under a mesh the rows' weights (1 where this rank holds
        the row, else 0; None without a mesh)."""
        n_used, tail = self.n_batches * self.bs, (self.bs,)
        if self.cfg.shuffle is False:
            rows = self.all_rows
        else:
            blk = (self.order[:, None] * self.bs + self.cols).reshape(-1)
            rows = (self.perm.index_select(0, blk) if self.perm is not None
                    else blk + self.offset)
        w = None
        if self.mesh is not None:
            rows = rows - self.lo
            w = ((rows >= 0) & (rows < self.n_local)).to(self.model.dtype)
            w = w.reshape(self.n_batches, self.bs)
            rows = rows.clamp(0, self.n_local - 1)
        out = []
        for x in (self.features, self.prices, self.targets):
            x = x[:n_used] if rows is None else x.index_select(0, rows)
            out.append(x.reshape(self.n_batches, *tail, *x.shape[1:]))
        return out, w

    def _step(self, i: int, f, pr, t, w) -> None:
        """One minibatch: the loss's gradient by autograd, then optax's Adam.
        Under a mesh the loss is this rank's rows' share of the global batch
        mean (``w`` the rows' weights) and one ``all_reduce`` sums the
        gradients and the loss across the ranks."""
        leaves = [p.detach().requires_grad_() for p in self.model.unflatten(self.theta).values()]
        pred = self.model.value(dict(zip(self.keys, leaves)), f, pr)
        if w is None:
            loss = self.loss_fn(pred, t)
        else:
            terms = torch.func.vmap(self.loss_fn)(pred[:, None], t[:, None])
            loss = torch.sum(w * terms) / self.bs
        g = torch.cat([x.reshape(-1) for x in torch.autograd.grad(loss, leaves)])
        if w is not None:
            packed = path_sum(torch.cat([g, loss.detach().to(g.dtype)[None]]), self.mesh)
            g, loss = packed[:-1], packed[-1]
        self.losses[i].copy_(loss.detach())
        self.count.add_(1)
        bc = (1.0 - torch.pow(self.betas, self.count.to(torch.float64))).to(g.dtype)  # orp: noqa[ORP001] -- Adam's bias corrections in f64, as the JAX package's optax schedule computes them
        torch.add((1.0 - B1) * g, self.mu, alpha=B1, out=self.mu)
        torch.add((1.0 - B2) * (g * g), self.nu, alpha=B2, out=self.nu)
        upd = (self.mu / bc[0]) / (torch.sqrt(self.nu / bc[1] + EPS_ROOT) + EPS)
        self.theta.add_(self.neg_lr * upd)

    def epoch(self) -> None:
        """One epoch on the device; entered with ``stopped`` set it changes nothing
        and records ``inf``."""
        (fb, pb, tb), wb = self._batches()
        state = (self.theta, self.mu, self.nu, self.count)
        snap = [x.clone() for x in state]
        for i in range(self.n_batches):
            self._step(i, fb[i], pb[i], tb[i], None if wb is None else wb[i])
        stopped = self.stopped.clone()
        for x, old in zip(state, snap):
            x.copy_(torch.where(stopped, old, x))
        loss = self.losses.mean()
        improved = (loss < self.best_loss - self.cfg.min_delta) & ~stopped
        self.best_theta.copy_(torch.where(improved, self.theta, self.best_theta))
        self.best_loss.copy_(torch.where(improved, loss, self.best_loss))
        wait = torch.where(improved, torch.zeros_like(self.wait), self.wait + 1)
        self.wait.copy_(torch.where(stopped, self.wait, wait))
        self.epoch_loss.copy_(torch.where(stopped, torch.full_like(loss, float("inf")), loss))
        self.stopped.copy_(stopped | (self.wait >= self.cfg.patience))

    def capture(self) -> None:
        """Warm one epoch up on a side stream, then capture it (the state it
        leaves is replaced by the next :meth:`load`)."""
        side = torch.cuda.Stream(self.theta.device)
        side.wait_stream(torch.cuda.current_stream(self.theta.device))
        with torch.cuda.stream(side):
            self.epoch()
        torch.cuda.current_stream(self.theta.device).wait_stream(side)
        t0 = time.perf_counter()  # orp: noqa[ORP007] -- times the capture itself: kernels are recorded, not launched, under torch.cuda.graph
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.epoch()
        cuda_build.count_capture(time.perf_counter() - t0, site="fit_epoch")

    def run_epoch(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.epoch()


_PROGRAMS: collections.OrderedDict = collections.OrderedDict()


def _program(model, loss_fn, cfg: FitConfig, n: int, bs: int, features, prices,
             targets, mesh=None) -> _EpochProgram:
    """A fresh program, or on a CUDA device with graphs on the captured one for
    these shapes, this loss and this mesh (captured at its first use, kept for
    the next fit)."""
    graphs = CUDA_GRAPHS and targets.device.type == "cuda"
    if not graphs:
        return _EpochProgram(model, loss_fn, cfg, n, bs, features, prices, targets, mesh=mesh)
    key = (model, loss_fn, cfg.shuffle, cfg.patience, cfg.min_delta, n, bs, targets.device,
           tuple(features.shape), features.dtype, tuple(prices.shape), prices.dtype,
           targets.dtype, None if mesh is None else id(mesh))
    prog = _PROGRAMS.pop(key, None)
    if prog is None:
        prog = _EpochProgram(model, loss_fn, cfg, n, bs, features, prices, targets,
                             graphs=True, mesh=mesh)
    _PROGRAMS[key] = prog
    while len(_PROGRAMS) > _MAX_PROGRAMS:
        _PROGRAMS.popitem(last=False)
    return prog


def prepare(model, features: torch.Tensor, prices: torch.Tensor, targets: torch.Tensor, *,
            loss_fn, cfg: FitConfig, mesh=None) -> None:
    """Build and capture, ahead of time, the epoch program that
    :func:`fit_core` will use for these shapes, this loss and ``cfg`` (a no-op
    where no graph is captured): the capture syncs the card, which a
    sync-free fit must not."""
    n = targets.shape[0] * mesh_size(mesh)
    prog = _program(model, loss_fn, cfg, n, min(cfg.batch_size, n), features, prices, targets,
                    mesh)
    if prog.graphs and prog.graph is None:
        prog.load(torch.zeros(model.n_params(), dtype=model.dtype, device=targets.device),
                  features, prices, targets)
        prog.capture()


def fit_core(model, params: dict, features: torch.Tensor, prices: torch.Tensor,
             targets: torch.Tensor, generator: torch.Generator, *, loss_fn,
             cfg: FitConfig, metric_fns: tuple = (), solve_fn=None, sync_free: bool = False,
             mesh=None):
    """Train ``params`` so that ``model.value(params, features, prices) ~ targets``.

    ``generator`` (a CPU ``torch.Generator``) draws each epoch's order.
    Returns ``(best_params, aux)``, the params of the best epoch (Keras'
    ``restore_best_weights``) and device tensors: ``loss_history (n_epochs,)``
    (each epoch's mean minibatch loss, ``inf`` past the stop),
    ``n_epochs_ran`` (its finite entries), ``best_loss``, and ``final_loss``
    and each ``metric_fns`` entry (by name) of the returned params on all
    rows. ``solve_fn(params, features, prices, targets)``, where given (the
    walk passes ``model.solve_readout``), replaces the best params' readout,
    and ``best_loss`` is then the final loss. ``sync_free`` runs every epoch
    and stages the orders without a host sync (module docstring); the
    program must then have been captured by :func:`prepare`. ``mesh``: the
    rows are this rank's block of a paths mesh (module docstring); the
    returned losses and metrics are global."""
    full_f32()
    n = targets.shape[0] * mesh_size(mesh)
    bs = min(cfg.batch_size, n)
    schedule = reference_lr_schedule() if cfg.lr is None else None
    theta = model.flatten(params).to(device=targets.device, dtype=model.dtype)
    prog = _program(model, loss_fn, cfg, n, bs, features, prices, targets, mesh)
    prog.load(theta, features, prices, targets)
    if prog.graphs and prog.graph is None:
        prog.capture()
        prog.load(theta, features, prices, targets)
    hist = torch.full((cfg.n_epochs,), float("inf"), dtype=targets.dtype,
                      device=targets.device)
    for epoch in range(cfg.n_epochs):
        if not sync_free and bool(prog.stopped):  # the epoch's one host read
            break
        if cfg.shuffle is not False:
            order = _epoch_order(generator, n, bs, cfg.shuffle)
            (prog.stage_order if sync_free else prog.set_order)(*order)
        prog.neg_lr.fill_(-(schedule(epoch) if schedule is not None else cfg.lr))
        prog.run_epoch()
        hist[epoch] = prog.epoch_loss
    best = model.unflatten(prog.best_theta.clone())
    best_loss = prog.best_loss.clone()
    if solve_fn is not None:
        best = solve_fn(best, features, prices, targets)
    pred = model.value(best, features, prices)
    aux = {"loss_history": hist, "n_epochs_ran": torch.isfinite(hist).sum(),
           "final_loss": path_mean(loss_fn(pred, targets), mesh)}
    aux["best_loss"] = aux["final_loss"] if solve_fn is not None else best_loss
    for fn in metric_fns:
        aux[fn.__name__] = path_mean(fn(pred, targets), mesh)
    return best, aux
