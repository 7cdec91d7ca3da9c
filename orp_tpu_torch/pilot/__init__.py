"""orp_tpu_torch.pilot — the closed-loop model-CI/CD control plane
(counterpart of ``orp_tpu/pilot``).

The serving side (drift monitor, quality-banded canary, hash-linked
promotions chain) lives in ``serve/`` and ``obs/``; this package closes the
loop that feeds it:

- ``calibrate``  — rolling-window CIR calibration with RQMC-bootstrap CI
                   bands and the significance gate (a retrain fires only
                   when fitted params leave the SERVING bundle's baked
                   band — churn control);
- ``triggers``   — drift trips, calibration shifts and manual
                   retrain requests normalized into events,
                   all debounced through one ``guard.Cooldown`` (a flapping
                   signal cannot retrain-storm);
- ``controller`` — the explicit state machine (idle -> calibrating ->
                   training -> exporting -> canary -> promoted | rejected |
                   failed) that warm-starts the retrain from the serving
                   policy's weights, exports (optionally with AOT
                   executables), promotes through
                   ``ServeHost.reload_tenant(quality_band=…)``, and
                   journals every transition;
- ``journal``    — the append-only ``orp-pilot-v1`` cycle ledger (perf-
                   ledger torn-tail discipline) a killed pilot resumes
                   mid-cycle from.

Evidence: ``serve_bench(pilot=True)`` replays a synthetic market regime
shift through a live host and commits time-to-promote, ``rows_lost: 0``
during the swap, and the chain-verified verdicts.
"""

from orp_tpu_torch.pilot.calibrate import (CALIBRATION_FILE, CalibrationWindow,
                                     bake_calibration, bootstrap_ci,
                                     calibrate_rolling, calibrate_window,
                                     read_calibration, shift_significant)
from orp_tpu_torch.pilot.controller import (PilotConfig, PilotController,
                                      warm_params)
from orp_tpu_torch.pilot.journal import (JOURNAL_FILE, PILOT_SCHEMA, STATES,
                                   TERMINAL_STATES, journal_append,
                                   last_cycle, read_journal,
                                   unconsumed_requests,
                                   validate_pilot_record)
from orp_tpu_torch.pilot.triggers import TriggerEvent, TriggerHub

__all__ = [
    "CALIBRATION_FILE",
    "CalibrationWindow",
    "JOURNAL_FILE",
    "PILOT_SCHEMA",
    "PilotConfig",
    "PilotController",
    "STATES",
    "TERMINAL_STATES",
    "TriggerEvent",
    "TriggerHub",
    "bake_calibration",
    "bootstrap_ci",
    "calibrate_rolling",
    "calibrate_window",
    "journal_append",
    "last_cycle",
    "read_calibration",
    "read_journal",
    "shift_significant",
    "unconsumed_requests",
    "validate_pilot_record",
    "warm_params",
]
