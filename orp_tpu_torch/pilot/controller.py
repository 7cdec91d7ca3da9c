"""The pilot state machine: drift trip -> recalibrate -> warm-start retrain
-> export -> canary -> promote, journaled at every step (counterpart of
``orp_tpu/pilot/controller.py``).

One :class:`PilotController` owns one tenant's closed loop on one
:class:`~orp_tpu_torch.serve.host.ServeHost`. A cycle walks the explicit state
machine

    idle -> calibrating -> training -> exporting -> canary
                                               -> promoted | rejected | failed

with every transition appended to the ``orp-pilot-v1`` journal
(``pilot/journal.py``) BEFORE the state's work runs — so a pilot killed at
any point resumes from its last journaled state (``resume()``) instead of
restarting the cycle:

- killed while ``training``: the retrain's per-date checkpoints
  (``utils/checkpoint.py``, content-addressed under the workdir) replay on
  resume — the completed dates load, the rest train, and the finished
  policy is BITWISE what the uninterrupted run would have produced (the
  walk's resume guarantee; the walk's fingerprint carries the warm-start
  digest, ``train/backward.py``'s ``warm_tag``);
- killed while ``exporting``: the half-written candidate directory is
  discarded and rebuilt from the (checkpoint-cached) training result;
- killed while ``canary``: the fully exported candidate re-runs the gate.

The retrain WARM-STARTS from the serving policy's first-visited-date params
(``warm_params``): ``backward_induction(initial_params=...)`` replaces the
seeded init, so the walk continues from weights that already hedge the old
regime — fewer warm epochs to converge on the new one. Promotion goes
through ``ServeHost.reload_tenant(require_same_bits=False, quality_band=…)``
— every verdict (promote AND reject) lands on the hash-linked promotions
chain, and a reject leaves the incumbent serving bitwise-untouched while the
trigger hub's cooldown escalates.

The training itself is injected (``train_fn``) so the controller is pipeline
-agnostic: the drill retrains the European GBM hedge, a Heston desk would
inject its own. ``train_fn(window, warm_start, checkpoint_dir)`` must return
a ``PipelineResult``-shaped object (``export_bundle`` consumes it).

The checkpoint directory is keyed on the port's own ``state_digest`` of the
warm start (it hashes key names where the JAX package hashes pytree paths,
so the two packages' directories differ by design): what holds is the
guarantee, not equal hex — the same calibration and warm start resolve to the
same directory, and a killed cycle resumes its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil
import time

import numpy as np
import torch

from orp_tpu_torch.guard.cooldown import Cooldown
from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.pilot import journal as _journal
from orp_tpu_torch.pilot.calibrate import (CalibrationWindow, bake_calibration,
                                     calibrate_window, read_calibration)
from orp_tpu_torch.pilot.triggers import TriggerEvent, TriggerHub


@dataclasses.dataclass(frozen=True)
class PilotConfig:
    """Operating parameters for one tenant's loop (see module doc)."""

    tenant: str
    workdir: str                 # journal, checkpoints, candidate bundles
    quality_band: float = 0.25   # max relative hedge-error regression
    vol_window: int = 40         # rolling-vol window (calib/cir.py)
    calib_window: int = 160      # prices per calibration window
    n_boot: int = 32             # bootstrap resamples per CI band
    boot_seed: int = 0
    cooldown_s: float = 300.0    # base retrain cool-down
    backoff: float = 2.0         # escalation per consecutive reject
    max_backoff_s: float = 3600.0
    aot: bool = False            # export serving executables with candidates
    aot_buckets: tuple = (8,)
    annualization: float = 252.0
    prices_path: str | None = None  # market feed (doctor probes this)
    events_dir: str | None = None   # flight-recorder dump dir (doctor probes)


def warm_params(policy) -> tuple:
    """``(params1, params2)`` at the walk's FIRST visited date
    (t = n_dates-1; the per-date stacks are date-ascending, so index -1)
    from a ``PolicyBundle`` / ``PipelineResult.backward`` carrier — the
    warm start a retrain continues from."""
    bw = getattr(policy, "backward", policy)
    if getattr(bw, "params1_by_date", None) is None:
        raise ValueError(
            "policy carries no per-date params (params1_by_date) — "
            "cannot warm-start; re-export the bundle with current code")
    p1 = _last_date(bw.params1_by_date)
    p2 = None
    if getattr(bw, "params2_by_date", None) is not None:
        p2 = _last_date(bw.params2_by_date)
    return p1, p2


def _last_date(params_by_date: dict) -> dict:
    """Index -1 of each per-date stack, as host numpy arrays (the JAX
    package's ``jax.tree.map(lambda x: np.asarray(x)[-1], ...)``)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))[-1] for k, v in params_by_date.items()}


def _window_from_meta(meta: dict) -> CalibrationWindow:
    """Rebuild a journaled ``CalibrationWindow.to_meta()`` (resume path)."""
    from orp_tpu_torch.calib.cir import CalibrationFit, CIRParams

    f = meta["fit"]
    fit = CalibrationFit(
        params=CIRParams(a=f["a"], b=f["b"], c=f["c"]), mu=f["mu"],
        sigma0=f["sigma0"], n_prices=f["n_prices"],
        vol_window=f["vol_window"])
    return CalibrationWindow(
        fit=fit, ci={k: tuple(v) for k, v in meta["ci"].items()},
        n_boot=meta["n_boot"], n_failed=meta["n_failed"],
        start=meta["start"], level=meta.get("level", 0.95))


class PilotController:
    """One tenant's closed loop (module doc). Not thread-safe by design:
    one pilot per tenant, cycles run sequentially — the concurrency story
    is the HOST's (the swap is the zero-downtime part), not the pilot's."""

    def __init__(self, host, cfg: PilotConfig, train_fn, *,
                 journal_path=None, validation=None, hub: TriggerHub = None,
                 clock=time.monotonic):
        self.host = host
        self.cfg = cfg
        self.train_fn = train_fn
        self.validation = validation
        self._clock = clock
        self.workdir = pathlib.Path(cfg.workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.journal_path = pathlib.Path(
            journal_path if journal_path is not None
            else self.workdir / _journal.JOURNAL_FILE)
        self.hub = hub if hub is not None else TriggerHub(
            cfg.tenant, cooldown=Cooldown(
                cooldown_s=cfg.cooldown_s, backoff=cfg.backoff,
                max_backoff_s=cfg.max_backoff_s, clock=clock))
        records, _ = _journal.read_journal(self.journal_path)
        prev = _journal.latest_config(records)
        conf = {"kind": "config", "tenant": cfg.tenant,
                "calib_window": cfg.calib_window,
                "vol_window": cfg.vol_window,
                "quality_band": cfg.quality_band,
                "prices_path": cfg.prices_path,
                "events_dir": cfg.events_dir,
                "workdir": str(self.workdir)}
        if prev is None or any(prev.get(k) != v for k, v in conf.items()
                               if k != "kind"):
            _journal.journal_append(self.journal_path, conf)

    # -- transition methods (ORP023: obs emission first, no lock held) -------

    def _journal_state(self, cycle: int, state: str, **payload) -> dict:
        return _journal.journal_append(
            self.journal_path,
            {"kind": "transition", "cycle": cycle, "state": state,
             "tenant": self.cfg.tenant, **payload})

    def _enter_calibrating(self, cycle: int, trigger: TriggerEvent,
                           prices) -> CalibrationWindow:
        obs_count("pilot/transition", state="calibrating",
                  tenant=self.cfg.tenant)
        p = np.asarray(prices, np.float64)
        if p.shape[0] < self.cfg.calib_window:
            raise ValueError(
                f"calibration window unsatisfiable: need "
                f">= {self.cfg.calib_window} prices, got {p.shape[0]} — "
                "widen the feed or lower PilotConfig.calib_window")
        start = p.shape[0] - self.cfg.calib_window
        self._journal_state(
            cycle, "calibrating", trigger_source=trigger.source,
            trigger_reason=trigger.reason, trigger_seq=trigger.seq,
            n_prices=int(p.shape[0]))
        return calibrate_window(
            p[start:], vol_window=self.cfg.vol_window,
            n_boot=self.cfg.n_boot, seed=self.cfg.boot_seed, start=start,
            annualization=self.cfg.annualization)

    def _enter_training(self, cycle: int, window: CalibrationWindow,
                        incumbent, warm, ckpt_dir: pathlib.Path):
        obs_count("pilot/transition", state="training",
                  tenant=self.cfg.tenant)
        self._journal_state(
            cycle, "training", calibration=window.to_meta(),
            checkpoint_dir=str(ckpt_dir), incumbent=str(incumbent))
        # the heavy call runs OUTSIDE any lock: a pilot retrain must never
        # head-of-line-block the host it is about to promote into
        return self.train_fn(window, warm, str(ckpt_dir))

    def _enter_exporting(self, cycle: int, result,
                         window: CalibrationWindow) -> pathlib.Path:
        obs_count("pilot/transition", state="exporting",
                  tenant=self.cfg.tenant)
        candidate = self.workdir / "candidates" / f"cycle-{cycle}"
        self._journal_state(cycle, "exporting", candidate=str(candidate))
        if candidate.exists():
            # a previous attempt died mid-export: the half-written dir is
            # not a bundle, discard and rebuild (nothing serves from it yet)
            shutil.rmtree(candidate)
        from orp_tpu_torch.serve.bundle import export_bundle

        bundle = export_bundle(result, candidate)
        bake_calibration(candidate, window)
        if self.cfg.aot:
            from orp_tpu_torch.aot import export_aot

            export_aot(candidate, bundle, buckets=self.cfg.aot_buckets)
        return candidate

    def _enter_canary(self, cycle: int, candidate: pathlib.Path) -> dict:
        obs_count("pilot/transition", state="canary",
                  tenant=self.cfg.tenant)
        self._journal_state(cycle, "canary", candidate=str(candidate))
        # reload_tenant manages its own locking; holding any pilot-side
        # lock across it would stall the serving path (ORP023)
        return self.host.reload_tenant(
            self.cfg.tenant, str(candidate), require_same_bits=False,
            quality_band=self.cfg.quality_band, validation=self.validation)

    def _enter_terminal(self, cycle: int, state: str, **payload) -> dict:
        obs_count("pilot/transition", state=state, tenant=self.cfg.tenant)
        chain = getattr(self.host, "promotion_chain", None)
        return self._journal_state(
            cycle, state, chain=None if chain is None else str(chain),
            **payload)

    # -- cycle drivers -------------------------------------------------------

    def next_cycle_id(self) -> int:
        records, _ = _journal.read_journal(self.journal_path)
        last, _ = _journal.last_cycle(records)
        return 0 if last is None else last + 1

    def _ckpt_dir(self, window: CalibrationWindow,
                  warm_digest: str) -> pathlib.Path:
        """Content-addressed checkpoint dir: same calibration + same warm
        start resolve to the same directory, so a repeated cycle (a reject
        followed by an unchanged-inputs retry) RESUMES the finished walk
        instead of retraining, and a killed cycle resumes its own."""
        key = hashlib.sha256(json.dumps(
            {"fit": window.fit.as_dict(), "warm": warm_digest},
            sort_keys=True).encode()).hexdigest()[:16]
        return self.workdir / "ckpt" / key

    def _warm_from(self, incumbent):
        from orp_tpu_torch.utils.checkpoint import state_digest

        policy = incumbent
        if isinstance(policy, (str, bytes)) or hasattr(policy, "__fspath__"):
            from orp_tpu_torch.serve.bundle import load_bundle

            policy = load_bundle(policy)
        warm = warm_params(policy)
        digest = state_digest({"p1": warm[0],
                               "p2": () if warm[1] is None else warm[1]})
        return warm, digest[:16]

    def run_cycle(self, trigger: TriggerEvent, prices) -> dict:
        """Drive one full cycle from a trigger. Returns an outcome dict
        (``outcome`` in promoted/rejected); raises on ``failed`` (after
        journaling) and lets a training kill propagate with the journal
        parked at ``training`` for ``resume()``."""
        cycle = self.next_cycle_id()
        t0 = self._clock()
        window = self._enter_calibrating(cycle, trigger, prices)
        incumbent = self.host.tenant_source(self.cfg.tenant)
        return self._finish_cycle(cycle, window, incumbent, t0=t0)

    def _finish_cycle(self, cycle: int, window: CalibrationWindow,
                      incumbent, *, t0=None,
                      skip_to_canary: pathlib.Path | None = None) -> dict:
        from orp_tpu_torch.guard.inject import WalkKilled
        from orp_tpu_torch.serve.host import CanaryRejected

        t0 = self._clock() if t0 is None else t0
        try:
            if skip_to_canary is None:
                warm, warm_digest = self._warm_from(incumbent)
                ckpt = self._ckpt_dir(window, warm_digest)
                result = self._enter_training(cycle, window, incumbent,
                                              warm, ckpt)
                candidate = self._enter_exporting(cycle, result, window)
            else:
                candidate = skip_to_canary
            verdict = self._enter_canary(cycle, candidate)
        except CanaryRejected as e:
            self.hub.note_reject()
            self._enter_terminal(cycle, "rejected", why=str(e),
                                 cooldown=self.hub.cooldown.snapshot())
            return {"cycle": cycle, "outcome": "rejected", "why": str(e),
                    "elapsed_s": round(self._clock() - t0, 3)}
        except WalkKilled:
            # journal is parked at "training" — resume() continues the walk
            raise
        except Exception as e:
            self._enter_terminal(cycle, "failed",
                                 error=f"{type(e).__name__}: {e}")
            raise
        self.hub.note_promote()
        elapsed = round(self._clock() - t0, 3)
        self._enter_terminal(cycle, "promoted",
                             version=verdict.get("version"),
                             candidate=str(candidate), elapsed_s=elapsed)
        return {"cycle": cycle, "outcome": "promoted", "verdict": verdict,
                "candidate": str(candidate), "elapsed_s": elapsed}

    def resume(self, prices=None) -> dict | None:
        """Continue the last journaled cycle from where a killed pilot left
        it (module doc). None when there is nothing to resume (no cycles,
        or the last one reached a terminal state)."""
        records, _ = _journal.read_journal(self.journal_path)
        cycle, recs = _journal.last_cycle(records)
        if cycle is None:
            return None
        state = recs[-1]["state"]
        if state in _journal.TERMINAL_STATES:
            return None
        by_state = {r["state"]: r for r in recs}
        if state == "calibrating":
            # died before the fit was journaled: re-run the whole cycle
            # under the original trigger (prices required)
            if prices is None:
                raise ValueError(
                    "resume at 'calibrating' needs prices= — the fit was "
                    "never journaled, so it must be recomputed")
            rec = by_state["calibrating"]
            trigger = TriggerEvent(
                source=rec.get("trigger_source", "manual"),
                tenant=self.cfg.tenant,
                reason=rec.get("trigger_reason", "resumed cycle"),
                seq=rec.get("trigger_seq"))
            window = self._enter_calibrating(cycle, trigger, prices)
            incumbent = self.host.tenant_source(self.cfg.tenant)
            return self._finish_cycle(cycle, window, incumbent)
        train_rec = by_state.get("training")
        if train_rec is None:  # pragma: no cover - calibrating handled above
            raise ValueError(f"cycle {cycle} journal is incoherent: state "
                             f"{state!r} with no training record")
        window = _window_from_meta(train_rec["calibration"])
        if state == "canary":
            return self._finish_cycle(
                cycle, window, train_rec["incumbent"],
                skip_to_canary=pathlib.Path(by_state["canary"]["candidate"]))
        # training / exporting: re-enter training — the content-addressed
        # checkpoint dir replays every completed date, so this costs only
        # the dates the kill interrupted
        return self._finish_cycle(cycle, window, train_rec["incumbent"])

    # -- trigger polling -----------------------------------------------------

    def poll(self, *, flight_events=None, calibration_prices=None) -> list:
        """Gather pending trigger events from every source: new drift trips
        (``flight_events``: a flight-recorder snapshot), a significant
        calibration shift on ``calibration_prices``, and unconsumed manual
        requests from the journal. Debouncing happens in ``accept`` — this
        only COLLECTS."""
        events: list[TriggerEvent] = []
        if flight_events is not None:
            events.extend(self.hub.poll_drift(flight_events))
        if calibration_prices is not None:
            p = np.asarray(calibration_prices, np.float64)
            if p.shape[0] >= self.cfg.calib_window:
                window = calibrate_window(
                    p[-self.cfg.calib_window:],
                    vol_window=self.cfg.vol_window, n_boot=self.cfg.n_boot,
                    seed=self.cfg.boot_seed,
                    annualization=self.cfg.annualization)
                baseline = None
                source = self.host.tenant_source(self.cfg.tenant)
                if isinstance(source, (str, bytes)) or hasattr(
                        source, "__fspath__"):
                    baseline = read_calibration(source)
                ev = self.hub.check_calibration(window, baseline)
                if ev is not None:
                    events.append(ev)
        records, _ = _journal.read_journal(self.journal_path)
        events.extend(self.hub.poll_manual(records))
        return events
