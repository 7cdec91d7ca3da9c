"""The read side of training convergence telemetry (counterpart of ``orp_tpu/obs/report.py``).

``train/backward.backward_induction`` emits one ``train/convergence`` record
a telemetered walk (per-date loss / mae trajectories, epochs or GN
iterations, the GN Gram conditioning) and the NaN sentinel emits
``guard/degrade{date,to}`` counter events when a date walked down the
trainer ladder. :func:`load_convergence` merges them back into the per-date
table an operator reads: which dates struggled, on which rung each
finished, and whether the Gram was the reason. It reads either package's
bundle.
"""

from __future__ import annotations

import pathlib

from orp_tpu_torch.obs.sink import EVENTS_FILE, read_events


def load_convergence(events: str | pathlib.Path) -> dict:
    """Load the LAST ``train/convergence`` record from a telemetry bundle
    (a ``--telemetry DIR`` or its ``events.jsonl`` directly), overlaying
    per-date trainer-ladder demotions from ``guard/degrade`` counter events
    and NaN-sentinel trips from ``guard/nan_event``. Raises
    ``FileNotFoundError``/``ValueError`` like ``obs.read_events``."""
    p = pathlib.Path(events)
    if p.is_dir():
        p = p / EVENTS_FILE
    lines = read_events(p)
    records = [e for e in lines
               if e.get("type") == "record"
               and e.get("name") == "train/convergence"]
    if not records:
        return {}
    rec = dict(records[-1])
    # overlay only THIS walk's guard events: a multi-walk session's earlier
    # demotions must not be pinned on the last walk. The convergence record
    # is emitted at the END of its walk, so the walk's events sit between
    # the previous walk's END and this record — scope by seq. A CRASHED
    # earlier walk leaves no convergence record but still closes its
    # `train/walk` span (ok=False on the exception path), so the previous
    # walk's boundary is the later of: the previous record, and the
    # second-to-last train/walk span before this record (the last one is
    # this walk's own close, which sits AFTER its degrade events)
    hi = records[-1].get("seq", float("inf"))
    lo = records[-2].get("seq", -1) if len(records) > 1 else -1
    walk_spans = [e.get("seq", -1) for e in lines
                  if e.get("type") == "span" and e.get("name") == "train/walk"
                  and e.get("seq", -1) < hi]
    if len(walk_spans) > 1:
        lo = max(lo, walk_spans[-2])
    rungs = {d: rec["optimizer"] for d in range(rec.get("n_dates", 0))}
    nan_events: dict[int, int] = {}
    for e in lines:
        if e.get("type") != "counter":
            continue
        if not lo < e.get("seq", -1) < hi:
            continue
        labels = e.get("labels") or {}
        if e.get("name") == "guard/degrade" and "date" in labels:
            # walk order: the LAST demotion of a date is the rung that
            # produced its committed columns
            rungs[int(labels["date"])] = labels.get("to", "?")
        elif e.get("name") == "guard/nan_event" and "date" in labels:
            d = int(labels["date"])
            nan_events[d] = nan_events.get(d, 0) + e.get("inc", 1)
    rec["rungs"] = [rungs.get(d, rec["optimizer"])
                    for d in range(rec.get("n_dates", 0))]
    rec["nan_events"] = {str(d): n for d, n in sorted(nan_events.items())}
    return rec


def format_report(rec: dict) -> str:
    """The human ``orp report`` table: one row per rebalance date."""
    if not rec:
        return ("orp report: no train/convergence record found — run a "
                "training command with --telemetry DIR")
    head = [
        f"orp report — {rec.get('optimizer')} walk, "
        f"{rec.get('n_dates')} dates, dual_mode={rec.get('dual_mode')}"
        + (", fused" if rec.get("fused") else "")
        + (", nan_guard" if rec.get("nan_guard") else "")
    ]
    conds = rec.get("gram_cond")
    cols = f"{'date':>5}{'loss':>12}{'mae':>11}{'epochs':>8}{'rung':>14}"
    if conds:
        cols += f"{'gram_cond':>12}"
    head.append(cols)
    rungs = rec.get("rungs") or []
    nan_events = rec.get("nan_events") or {}
    for d in range(rec.get("n_dates", 0)):
        rung = rungs[d] if d < len(rungs) else rec.get("optimizer", "?")
        mark = "*" if str(d) in nan_events else " "
        row = (f"{d:>5}{rec['train_loss'][d]:>12.3e}"
               f"{rec['train_mae'][d]:>11.3e}"
               f"{rec['epochs_ran'][d]:>8}{rung:>13}{mark}")
        if conds:
            row += f"{conds[d]:>12.3g}"
        head.append(row)
    if nan_events:
        head.append(f"* NaN-sentinel trips at date(s) "
                    f"{', '.join(nan_events)} — the rung column shows the "
                    "ladder's final trainer")
    return "\n".join(head)
