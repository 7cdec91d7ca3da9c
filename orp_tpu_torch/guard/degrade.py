"""Topology degradation: lose a device, rebuild, replay — keep answering (counterpart of ``orp_tpu/guard/degrade.py``).

Every fault the guard layer handled before this module was *sub-topology*:
a NaN at one date, a transient dispatch, a failing AOT bucket. Losing a
device out of the mesh is structural — the engine's shardings name a
topology that no longer exists, so every subsequent dispatch is doomed and
no retry policy helps. The production answer (the same one the AOT layer
gives fingerprint mismatches) is to DEGRADE, not die:

    healthy ──device loss──▶ degraded ──drain → rebuild → replay──▶ recovered

:class:`DegradeManager` is that state machine around one engine + batcher:

- **detect** — a dispatch (or block) raising
  :class:`~orp_tpu_torch.guard.DeviceLostError` marks the topology dead; the
  failed request is TRAPPED for replay instead of failing its caller, and
  exactly one recovery runs (``guard/device_loss``).
- **drain**  — the old batcher drains OUTSIDE every lock (its queued
  requests resolve through the old engine where the runtime still can, and
  re-enter the replay set where it cannot — either way no future is
  dropped). New submits never stall: the swap installs the new batcher
  BEFORE the drain.
- **rebuild** — a fresh ``HedgeEngine`` on the largest surviving
  submesh (``parallel.mesh.largest_submesh``). A bundle that ships the
  topology's AOT set (``aot/bundle_exec.py``) rebuilds it from the shipped
  libraries and recaptured bucket graphs with ZERO ``nvcc`` runs
  (``rebuild_xla_compiles``, the port's build count, reads 0); anything else
  serves eagerly — same bits.
- **replay** — trapped requests re-dispatch through the new engine; served
  bits are BITWISE what the healthy engine returns. The
  drain→rebuild→replay wall is the MTTR, recorded per recovery
  (``stats()``) and a first-class field of ``serve/bench.serve_bench``'s
  record (``degrade_at``).

Topology: a mesh of N ranks is N processes here, each SPMD by hand, and every
rank constructs ``DegradeManager(policy, mesh=N)``. Rank 0 is the FRONT: it
alone takes ``submit`` / ``submit_block`` / ``evaluate`` and runs the batcher,
whose engine broadcasts each dispatch through a ``serve/engine.MeshChannel``
before its forward. Every other rank is a FOLLOWER: a thread that makes each
broadcast dispatch on its own engine (``serve/engine.follow``). One ordered
channel on one thread per rank carries dispatch, loss and stop. A device loss
fires on rank 0 (a ``FaultPlan`` is process-local); its recovery thread sends
a loss message carrying the survivors over the old mesh and retires the old
channel, under the channel's lock, so it never interleaves with a dispatch's
broadcast or gather. Every rank then rebuilds on the first
``largest_submesh(survivors)`` ranks (``make_mesh`` takes the first n of the
group; ``parallel/mesh.join_submesh`` forms that subgroup, entered by every
rank still in the manager, waiting only among its members), and the ranks
outside it stand down. Which rank died is not known (nor is it in the JAX
package): the survivors are a count. A real process death, seen as a failed
collective, is outside this design. Served bits stay BITWISE the
single-device engine's on every topology: the mesh engine's forward runs in
fixed row tiles and its gather is exact (``serve/engine.py``).

The clean path pays one pointer indirection per submit and nothing else;
a manager that never sees a ``DeviceLostError`` is a pass-through.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeoutError

import numpy as np

from orp_tpu_torch.guard.serve import DeviceLostError, GuardPolicy
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import flight
from orp_tpu_torch.utils import cuda_build


class _Tracked:
    """One request (or one columnar block) as the manager remembers it:
    enough to replay. ``is_block`` routes the resubmission through
    ``submit_block`` — a trapped block replays AS a block, with its
    per-row deadline budgets restarted exactly like a per-request replay's
    ``deadline_s`` is."""

    __slots__ = ("date_idx", "states", "prices", "deadline_s", "outer",
                 "is_block")

    def __init__(self, date_idx, states, prices, deadline_s, outer,
                 is_block=False):
        self.date_idx = date_idx
        self.states = states
        self.prices = prices
        self.deadline_s = deadline_s   # per-request budget OR the block's
        # per-row deadlines column (relative seconds), per lane
        self.outer = outer
        self.is_block = is_block


def _healthy_spec(mesh):
    """The manager's starting topology: None for one device (no mesh, or a
    1-rank one), else its ``MeshSpec``, refused in flag-speak when it spans
    more ranks than the process group holds."""
    import torch.distributed as dist

    from orp_tpu_torch.parallel.mesh import spec_of

    spec = spec_of(mesh)
    if spec is None:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if spec.n_devices is None else spec.n_devices
    if n > world:
        raise ValueError(
            f"DegradeManager(mesh={mesh!r}) spans {n} ranks, but this process group has "
            f"{world}: start {n} ranks (torchrun --nproc-per-node {n}, or "
            "parallel.multihost.initialize_multihost) or pass a smaller mesh")
    return None if n == 1 else type(spec)(n_devices=n, axis=spec.axis)


class DegradeManager:
    """Serve one policy through device loss: drain → rebuild → replay.

    ``policy``        — what the engine evaluates (a ``PolicyBundle`` —
    ideally one shipping its topology's AOT set — or a trained
    ``PipelineResult``). Retained: every rebuild constructs from it.
    ``mesh``          — the healthy topology: None, a rank count, a
    ``MeshSpec`` or a built mesh, at most the ranks of the process group;
    every rank of it constructs the manager (module docstring: rank 0 is the
    front, the others follow, and ``role`` says which this rank is:
    ``"front"``, ``"follower"`` or, after a loss left it outside the
    rebuilt mesh, ``"stood_down"``).
    ``engine_kwargs`` — ``HedgeEngine`` keywords (``device``, ``precision``...).
    ``guard_policy``  — optional :class:`~orp_tpu_torch.guard.GuardPolicy` for the
    inner batcher (deadlines/watermark/retries/hard wall keep their exact
    semantics on every topology).
    ``replay_timeout_s`` — bound on waiting for replayed requests during
    recovery (a replay that cannot resolve inside it is left to its future
    and counted, never waited on forever).
    """

    def __init__(self, policy, *, mesh=None,
                 guard_policy: GuardPolicy | None = None,
                 engine_kwargs: dict | None = None,
                 batcher_kwargs: dict | None = None,
                 replay_timeout_s: float = 30.0):
        self._policy = policy
        self._guard_policy = guard_policy
        self.engine_kwargs = dict(engine_kwargs or {})
        self.batcher_kwargs = dict(batcher_kwargs or {})
        self.replay_timeout_s = float(replay_timeout_s)
        self._lock = threading.Lock()
        self._spec = _healthy_spec(mesh)
        self._meshed = self._spec is not None  # started on a mesh of ranks
        self._replay: collections.deque[_Tracked] = collections.deque()
        self._recoveries: list[dict] = []
        self._recovering = False
        self._recovery_thread: threading.Thread | None = None
        self._closed = False
        self._batcher = None
        self._follower: threading.Thread | None = None
        self._follower_error: Exception | None = None
        #: a follower's rebuilds: {"to_devices", "nvcc", "captures", "aot_buckets"}
        self.rebuilds: list[dict] = []
        self.rank = 0
        if self._spec is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank()
        # built OUTSIDE the lock (nothing to race at construction; the
        # discipline everywhere else)
        if self.rank == 0:
            self.role = "front"
            self.engine, self._batcher = self._build(self._spec)
        else:
            self.engine = self._build_engine(self._spec)
            self.role = "follower" if self.engine is not None else "stood_down"
            if self.engine is not None:
                self._follower = threading.Thread(target=self._follow, name="orp-degrade-follower",
                                                  daemon=True)
                self._follower.start()

    # -- build / swap --------------------------------------------------------

    def _build_engine(self, spec):
        """This rank's engine for ``spec`` (None when this rank is outside the
        mesh), the front's announcing to the others through a fresh channel."""
        from orp_tpu_torch.parallel.mesh import join_submesh
        from orp_tpu_torch.serve.engine import HedgeEngine, MeshChannel

        mesh = None
        if spec is not None:
            mesh = join_submesh(spec.n_devices, axis=spec.axis,
                                device=self.engine_kwargs.get("device"))
            if mesh is None:
                return None
        if self.rank != 0 and mesh is None:
            return None  # a single device is rank 0's alone
        engine = HedgeEngine(self._policy, mesh=mesh, **self.engine_kwargs)
        if mesh is not None and self.rank == 0:
            engine.front = MeshChannel(mesh)
        return engine

    def _build(self, spec):
        """Engine + batcher for ``spec`` — always called OUTSIDE every lock
        (engine construction installs AOT libraries and captures graphs, or
        builds; a lock held across it would head-of-line-block submits)."""
        from orp_tpu_torch.serve.batcher import MicroBatcher

        engine = self._build_engine(spec)
        batcher = MicroBatcher(engine, policy=self._guard_policy,
                               **self.batcher_kwargs)
        return engine, batcher

    def _surviving_spec(self, survivors):
        from orp_tpu_torch.parallel.mesh import largest_submesh

        cur = 1 if self._spec is None else (self._spec.n_devices or 1)
        alive = cur - 1 if survivors is None else int(survivors)
        # a loss never GROWS the topology, and at least one device answers
        # (zero survivors has no serving story — the process is gone too).
        # A runtime that still fails re-raises DeviceLostError on the rebuilt
        # engine's next dispatch, which re-traps and (replay_timeout_s
        # bounding the loop) fails over another recovery round.
        return largest_submesh(max(1, min(alive, cur)))

    def _follow(self) -> None:
        """A follower's thread: mirror rank 0's dispatches; on a loss, rebuild
        with every other rank (or stand down outside the new mesh); end at
        rank 0's stop."""
        from orp_tpu_torch.serve.engine import LOSS, MeshChannel, STOP, follow

        try:
            while True:
                op, ints = follow(self.engine, MeshChannel(self.engine.mesh))
                if op == STOP:
                    return
                if op != LOSS:
                    raise RuntimeError(f"unknown mesh channel message {op}")
                new_spec = self._surviving_spec(None if ints[0] < 0 else ints[0])
                builds0 = dict(cuda_build.BUILD_STATS)
                engine = self._build_engine(new_spec)
                with self._lock:
                    self._spec = new_spec
                    self.engine = engine
                    if engine is None:
                        self.role = "stood_down"
                self.rebuilds.append({
                    "to_devices": 1 if new_spec is None else new_spec.n_devices,
                    "nvcc": cuda_build.BUILD_STATS["nvcc"] - builds0["nvcc"],
                    "captures": cuda_build.BUILD_STATS["captures"] - builds0["captures"],
                    "aot_buckets": None if engine is None else engine.cache_info()["aot_buckets"]})
                if engine is None:
                    return
        except Exception as e:  # orp: noqa[ORP009] -- kept for close(), which re-raises it
            self._follower_error = e

    # -- request path --------------------------------------------------------

    def submit(self, date_idx: int, states, prices=None, *,
               deadline_s: float | None = None):
        """Route one request through the CURRENT topology's batcher; the
        returned future resolves exactly like the batcher's own —
        ``(phi, psi, value)`` or a structured ``Rejection`` — except that a
        topology death under the request replays it instead of failing it."""
        from orp_tpu_torch.serve.batcher import SlimFuture

        self._need_front("submit")
        outer = SlimFuture()
        req = _Tracked(int(date_idx), np.asarray(states), prices, deadline_s,
                       outer)
        self._submit_inner(req)
        return outer

    def submit_block(self, date_idx: int, states, prices=None,
                     deadlines=None):
        """Columnar lane through the degradation state machine: the future
        resolves to the batcher's own
        :class:`~orp_tpu_torch.serve.ingest.BlockResult` — except that a topology
        death under the block TRAPS the WHOLE block and replays it (as a
        block, one resubmission) through the rebuilt engine instead of
        failing its caller."""
        from orp_tpu_torch.serve.batcher import SlimFuture

        self._need_front("submit_block")
        outer = SlimFuture()
        req = _Tracked(int(date_idx),
                       np.atleast_2d(np.ascontiguousarray(states)),
                       prices, deadlines, outer, is_block=True)
        self._submit_inner(req)
        return outer

    def evaluate(self, date_idx: int, states, prices=None):
        """Synchronous convenience: ``submit(...).result()``."""
        self._need_front("evaluate")
        return self.submit(date_idx, states, prices).result()

    def _need_front(self, what: str) -> None:
        if self.role != "front":
            raise RuntimeError(
                f"DegradeManager.{what} on rank {self.rank} ({self.role}): rank 0 is the front "
                "of the mesh and takes every request; the other ranks only mirror its "
                f"dispatches — call {what} on rank 0")

    def _submit_inner(self, req: _Tracked) -> None:
        # bounded claim loop: between reading the pointer and submitting,
        # a recovery may swap + close the batcher underneath — the closed
        # batcher raises, and the retry reads the NEW pointer
        for _ in range(16):
            with self._lock:
                if self._closed:
                    raise RuntimeError("DegradeManager is closed")
                batcher = self._batcher
            try:
                if req.is_block:
                    fut = batcher.submit_block(req.date_idx, req.states,
                                               req.prices, req.deadline_s)
                else:
                    fut = batcher.submit(req.date_idx, req.states,
                                         req.prices,
                                         deadline_s=req.deadline_s)
            except RuntimeError:
                continue
            fut.add_done_callback(lambda f, r=req: self._inner_done(r, f))
            return
        raise RuntimeError(
            "could not reach a live batcher (recovery churn); the topology "
            "is flapping faster than it can rebuild")

    def _inner_done(self, req: _Tracked, fut) -> None:
        """Runs on the inner batcher's worker thread: forward the result to
        the caller's future — unless the topology died under the request,
        in which case TRAP it for replay and trigger exactly one recovery."""
        exc = fut.exception()
        if isinstance(exc, DeviceLostError):
            with self._lock:
                if not self._closed:
                    self._replay.append(req)
                    self._trigger_recovery_locked(exc)
                    return
        if exc is not None:
            req.outer.set_exception(exc)
        else:
            req.outer.set_result(fut.result())

    # -- recovery ------------------------------------------------------------

    def _trigger_recovery_locked(self, exc: DeviceLostError) -> None:
        """Caller holds the lock. Recovery runs on its OWN thread: the
        trigger fires from a batcher done-callback, and the recovery must
        drain (join) that very worker — recovering inline would deadlock."""
        if self._recovering:
            return  # the running recovery replays everything trapped so far
        self._recovering = True
        survivors = getattr(exc, "survivors", None)
        t = threading.Thread(target=self._recover, args=(survivors,),
                             name="orp-degrade-recovery", daemon=True)
        self._recovery_thread = t
        t.start()

    def _recover(self, survivors) -> None:
        """drain → rebuild → replay; the wall is the MTTR."""
        t0 = time.perf_counter()
        old_spec = self._spec
        from_devices = 1 if old_spec is None else (old_spec.n_devices or 1)
        obs_count("guard/device_loss", survivors=str(survivors))
        flight.record("device_lost", survivors=survivors,
                      from_devices=from_devices)
        new_spec = self._surviving_spec(survivors)
        to_devices = 1 if new_spec is None else new_spec.n_devices
        with self._lock:
            old_chan = self.engine.front
        if old_chan is not None:
            from orp_tpu_torch.serve.engine import LOSS

            # tell the followers over the old mesh, then retire its channel:
            # under the channel's lock, so no dispatch's broadcast or gather
            # interleaves, and every later dispatch on the old engine traps
            with old_chan.lock:
                old_chan.send(LOSS, (-1 if survivors is None else int(survivors),))
                old_chan.retired = True
        # rebuild FIRST and OUTSIDE the manager's lock (the rebuild's subgroup
        # is a collective, which the followers enter from their loss message):
        # new traffic starts flowing the moment the pointer swaps, while the
        # old queue drains
        builds0 = dict(cuda_build.BUILD_STATS)
        engine, batcher = self._build(new_spec)
        builds = {k: cuda_build.BUILD_STATS[k] - builds0[k] for k in ("nvcc", "captures")}
        with self._lock:
            old_batcher = self._batcher
            self._batcher = batcher
            self.engine = engine
            self._spec = new_spec
        # drain OUTSIDE every lock: resolving futures runs done-callbacks
        # (this class's own _inner_done among them) which take the lock
        old_batcher.close()
        replayed, unresolved = self._replay_trapped()
        mttr_ms = (time.perf_counter() - t0) * 1e3
        info = engine.cache_info()
        record = {
            "from_devices": from_devices,
            "to_devices": to_devices,
            "survivors_reported": survivors,
            "replayed": replayed,
            "replay_unresolved": unresolved,
            "mttr_ms": round(mttr_ms, 3),
            # the port's build count: the nvcc runs of the rebuild, zero when
            # the bundle shipped the topology's AOT set (or the cache held it)
            "rebuild_xla_compiles": builds["nvcc"],
            "rebuild_graph_captures": builds["captures"],
            "aot_buckets": info["aot_buckets"],
        }
        with self._lock:
            self._recoveries.append(record)
            self._recovering = False
            # a loss that raced the end of this recovery's replay loop
            # (trapped after the last deque check, before the flag cleared)
            # must not strand its request: run another round
            leftover = bool(self._replay) and not self._closed
            if leftover:
                self._trigger_recovery_locked(
                    DeviceLostError("replay straggler",
                                    survivors=to_devices))
        obs_count("guard/topology_rebuild", from_devices=str(from_devices),
                  to_devices=str(to_devices))

    def _replay_trapped(self) -> tuple[int, int]:
        """Re-dispatch every trapped request through the NEW engine and wait
        (bounded) for the replays to resolve — the MTTR honestly includes
        the time to ANSWER the interrupted traffic, not just to rebuild. A
        replay that dies to another loss mid-recovery re-enters the trap
        and is picked up by this same loop.

        ``replay_timeout_s`` bounds the WHOLE loop, resubmissions included:
        under a PERSISTENT loss every replay re-traps, and a deadline
        checked only on the wait branch would ping-pong requests between
        the trap and the queue forever while ``_recovering`` blocks any
        further degradation. Past the deadline, still-trapped requests are
        FAILED to their callers (counted ``guard/replay_unresolved``) —
        an honest error beats an invisible live-lock."""
        replayed, unresolved = 0, 0
        pending: list = []
        deadline = time.perf_counter() + self.replay_timeout_s
        while True:
            expired = time.perf_counter() >= deadline
            with self._lock:
                req = self._replay.popleft() if self._replay else None
            if req is not None:
                if expired:
                    unresolved += 1
                    obs_count("guard/replay_unresolved")
                    req.outer.set_exception(DeviceLostError(
                        "replay window exhausted: the topology kept losing "
                        f"devices for {self.replay_timeout_s}s"))
                    continue
                replayed += 1
                pending.append(req.outer)
                try:
                    self._submit_inner(req)
                except RuntimeError as e:
                    req.outer.set_exception(e)
                continue
            if not pending:
                return replayed, unresolved
            fut = pending.pop()
            try:
                fut.exception(timeout=max(0.0,
                                          deadline - time.perf_counter()))
            except _FutureTimeoutError:
                unresolved += 1
                obs_count("guard/replay_unresolved")

    # -- introspection / lifecycle -------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            recs = list(self._recoveries)
            return {
                "mesh_devices": 1 if self._spec is None
                else (self._spec.n_devices or 1),
                "recovering": self._recovering,
                "pending_replay": len(self._replay),
                "recoveries": recs,
                "mttr_ms": recs[-1]["mttr_ms"] if recs else None,
            }

    def close(self, timeout: float | None = 10.0) -> None:
        """Rank 0: drain, fail what still awaits replay, and send the followers
        stop (on a mesh after any running recovery, without a bound: the stop
        must follow the rebuild). A follower: wait for that stop (its part ends
        with the front's, so it waits without a bound) and raise what ended its
        loop otherwise."""
        if self.role != "front":
            with self._lock:
                self._closed = True
            if self._follower is not None:
                self._follower.join()
            if self._follower_error is not None:
                raise RuntimeError(f"the follower on rank {self.rank} failed: "
                                   f"{self._follower_error!r}") from self._follower_error
            return
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._recovery_thread
        if t is not None and t.is_alive():
            # a mesh's stop must follow its rebuild on the channel: no bound there
            t.join(None if self._meshed else timeout)
        with self._lock:
            # read the pointer AFTER the recovery join: a recovery racing
            # close may have swapped in a fresh batcher
            batcher = self._batcher
        batcher.close(timeout)
        with self._lock:
            trapped, self._replay = list(self._replay), collections.deque()
        for req in trapped:
            # never leave a caller waiting on a future nobody will resolve
            req.outer.set_exception(RuntimeError(
                "DegradeManager closed while the request awaited replay"))
        chan = self.engine.front
        if chan is not None:
            from orp_tpu_torch.serve.engine import STOP

            with chan.lock:
                if not chan.retired:
                    chan.send(STOP)
                    chan.retired = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
