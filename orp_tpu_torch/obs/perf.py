"""The perf ledger, roofline accounting and the noise-aware regression gate (counterpart of ``orp_tpu/obs/perf.py``).

Three pieces, with the JAX package's names and the ``orp-perf-v1`` schema, so
either package's :func:`validate_perf_record` accepts the other's records:

- **the ledger**: an append-only JSON-lines time series of measurements, one
  record per measured phase, each with its repeats, median and IQR and the
  fingerprint it is only comparable under (:func:`perf_fingerprint`: platform,
  device kind and count, the torch and CUDA versions; no ``jax`` key, so the
  two packages' records never pool in one history). A torn tail (a run killed
  mid-append) is tolerated on read and healed on the next append. The port
  has **no default ledger path**: every function takes it from the caller,
  and :func:`ledger_append` refuses the checkout's root ``PERF_LEDGER.jsonl``.
- **the roofline**: a program's analytic FLOPs and bytes (``utils/flops.py``
  and ``aot/compile.cost_summary``; the port has no XLA ``cost_analysis``)
  joined with a measured wall, against :data:`PEAK_TABLE`. The table holds
  one row, the H100, keyed by ``torch.cuda.get_device_name()``; its ceilings
  are ``utils/flops.py``'s. The port's products run in full f32
  (``utils/precision.full_f32``: TF32 off), so the f32 ceiling is the CUDA
  cores' 67 TFLOP/s; the bf16 tier runs the tensor cores (989 TFLOP/s); the
  int8 tier runs the f32 forward on dequantized weights
  (``serve/engine._eval_core``), so it is priced at the f32 ceiling. A kind
  the table lacks falls back to :func:`measured_matmul_peak` (a ``torch.matmul``
  under ``full_f32``, timed with CUDA events on the card), the reference's rule.
- **the gate**: the current median against the ledger's matching-fingerprint
  history, a regression being a median outside ``k * IQR`` of the history AND
  past a relative floor, with a minimum-repeats refusal in flag-speak. The
  measurement reaches obs before the verdict (:func:`gate_cli`).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

from orp_tpu_torch.utils.flops import HBM_BYTES_H100, PEAK_BF16_H100, PEAK_F32_H100

PERF_SCHEMA = "orp-perf-v1"
PERF_LEDGER_FILE = "PERF_LEDGER.jsonl"
#: the checkout's root ledger: never written by the port (the records it holds
#: are another tool's)
ROOT_LEDGER = pathlib.Path(__file__).resolve().parents[2] / PERF_LEDGER_FILE

#: gate defaults: the band multiplier and the honest-minimum repeat count
GATE_K = 4.0
GATE_MIN_REPEATS = 3
#: relative floor under which a median move is noise by fiat
GATE_REL_FLOOR = 0.05

_REQUIRED = {"schema": str, "workload": str, "phase": str, "unit": str,
             "repeats": int, "median": float, "iqr": float,
             "fingerprint": dict}


def summarize_repeats(samples) -> dict:
    """Median and IQR (and the quartiles and extremes) of repeated measurements.
    Raises on an empty sample set."""
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("summarize_repeats: no samples")
    p25, p50, p75 = (float(v) for v in np.percentile(xs, [25, 50, 75]))
    return {"repeats": len(xs), "median": p50, "iqr": p75 - p25, "p25": p25,
            "p75": p75, "min": xs[0], "max": xs[-1]}


def policy_digest(policy) -> str | None:
    """The 12-hex digest of the policy's fingerprint string (None without one)."""
    fp = getattr(policy, "fingerprint", None)
    if fp is None:
        return None
    return hashlib.sha256(str(fp).encode()).hexdigest()[:12]


def _device_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def perf_fingerprint(extra: dict | None = None) -> dict:
    """The identity a measurement is only comparable under: platform
    (``"gpu"`` / ``"cpu"``), device kind and count, torch and CUDA versions,
    plus the workload fields the caller adds."""
    import torch

    gpu = torch.cuda.is_available()
    fp = {"platform": "gpu" if gpu else "cpu", "device_kind": _device_kind(),
          "n_devices": torch.cuda.device_count() if gpu else 1,
          "torch": torch.__version__, "cuda": torch.version.cuda}
    if extra:
        fp.update(extra)
    return fp


def make_record(workload: str, phase: str, samples, *, unit: str = "s",
                direction: str = "lower", fingerprint_extra: dict | None = None,
                extra: dict | None = None) -> dict:
    """One stamped ``orp-perf-v1`` record from raw repeat samples."""
    rec = {"schema": PERF_SCHEMA, "ts_unix": time.time(), "workload": str(workload),
           "phase": str(phase), "unit": str(unit), "direction": str(direction),
           **summarize_repeats(samples), "fingerprint": perf_fingerprint(fingerprint_extra)}
    if extra:
        rec.update(extra)
    return rec


def make_record_from_summary(workload: str, phase: str, *, repeats: int, median: float,
                             iqr: float, unit: str = "s", direction: str = "lower",
                             fingerprint_extra: dict | None = None,
                             extra: dict | None = None) -> dict:
    """A stamped record from an already-summarized phase (median and IQR)."""
    rec = {"schema": PERF_SCHEMA, "ts_unix": time.time(), "workload": str(workload),
           "phase": str(phase), "unit": str(unit), "direction": str(direction),
           "repeats": int(repeats), "median": float(median), "iqr": float(iqr),
           "fingerprint": perf_fingerprint(fingerprint_extra)}
    if extra:
        rec.update(extra)
    return rec


def validate_perf_record(rec: dict) -> list[str]:
    """Schema check of one parsed ledger line; returns the problems (empty =
    valid)."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected dict"]
    for key, typ in _REQUIRED.items():
        if key not in rec:
            problems.append(f"missing key {key!r}")
        elif typ in (int, float) and isinstance(rec[key], bool):
            problems.append(f"{key}={rec[key]!r} is bool, expected {typ.__name__}")
        elif typ is float and isinstance(rec[key], int):
            continue  # JSON integers are honest floats
        elif not isinstance(rec[key], typ):
            problems.append(f"{key}={rec[key]!r} is {type(rec[key]).__name__}, expected "
                            f"{typ.__name__}")
    if rec.get("schema") not in (None, PERF_SCHEMA):
        problems.append(f"schema {rec['schema']!r} != {PERF_SCHEMA!r}")
    if isinstance(rec.get("repeats"), int) and rec["repeats"] < 1:
        problems.append(f"repeats={rec['repeats']} < 1")
    if rec.get("direction") not in (None, "lower", "higher"):
        problems.append(f"direction {rec.get('direction')!r} is neither 'lower' nor 'higher'")
    return problems


def read_ledger(path) -> tuple[list[dict], list[str]]:
    """``(records, problems)`` of a ledger. An unterminated last line that does
    not parse (a run killed mid-append) is skipped with a problem note; a line
    that does not parse anywhere else is corruption and raises."""
    p = pathlib.Path(path)
    if not p.exists():
        return [], []
    text = p.read_text()
    ends_nl = text.endswith("\n")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    records: list[dict] = []
    problems: list[str] = []
    for i, line in enumerate(lines):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1 and not ends_nl:
                problems.append(f"torn tail line skipped ({e})")
                continue
            raise ValueError(f"{p}: line {i + 1} does not parse ({e}) — not the torn tail; "
                             "the ledger was edited or corrupted") from None
    return records, problems


def _refuse_root_ledger(path: pathlib.Path) -> None:
    if path.resolve() == ROOT_LEDGER:
        raise ValueError(
            f"refusing to append to {path}: the checkout's root {PERF_LEDGER_FILE} is not "
            "this package's ledger — pass --ledger a path of your own (a temporary "
            "directory in tests and smoke runs)")


def ledger_append(path, record: dict) -> dict:
    """Append one validated record as a canonical JSON line, healing a torn tail
    first (an unterminated last line that does not parse is truncated away; one
    that parses gains its newline). Refuses an invalid record and the
    checkout's root ledger."""
    problems = validate_perf_record(record)
    if problems:
        raise ValueError(f"refusing to append an invalid perf record: {problems}")
    p = pathlib.Path(path)
    _refuse_root_ledger(p)
    p.parent.mkdir(parents=True, exist_ok=True)
    needs_nl = False
    if p.exists() and p.stat().st_size > 0:
        with open(p, "rb") as f:
            size = f.seek(0, 2)
            back = min(size, 65536)
            f.seek(size - back)
            chunk = f.read(back)
        if not chunk.endswith(b"\n"):
            nl = chunk.rfind(b"\n")
            if nl < 0 and back < size:
                chunk = p.read_bytes()
                nl = chunk.rfind(b"\n")
            tail = chunk[nl + 1:]
            try:
                json.loads(tail.decode("utf-8"))
                needs_nl = True
            except (ValueError, UnicodeDecodeError):
                with open(p, "ab") as f:
                    f.truncate(size - len(tail))
    with open(p, "a") as f:
        if needs_nl:
            f.write("\n")
        f.write(json.dumps(record, sort_keys=False, separators=(",", ":")) + "\n")
    return record


def matching_history(records, current: dict) -> list[dict]:
    """The records ``current`` compares against: same workload, phase and
    fingerprint, the current record itself excluded by its timestamp."""
    cur_fp = current.get("fingerprint")
    return [r for r in records
            if r.get("workload") == current.get("workload")
            and r.get("phase") == current.get("phase")
            and r.get("fingerprint") == cur_fp
            and r.get("ts_unix") != current.get("ts_unix")]


def gate(current: dict, history, *, k: float = GATE_K, min_repeats: int = GATE_MIN_REPEATS,
         rel_floor: float = GATE_REL_FLOOR) -> dict:
    """The noise-aware verdict of ``current`` against ``history``: ``refused``
    (too few repeats on either side), ``no_history`` (green: the record seeds
    the baseline), ``regression`` (outside ``k * scale`` of the history median
    in the bad direction AND past ``rel_floor``; ``scale`` the larger of the
    history's median IQR and the IQR of its medians) or ``ok``."""
    verdict: dict = {"k": float(k), "min_repeats": int(min_repeats),
                     "rel_floor": float(rel_floor), "current_median": current.get("median"),
                     "current_repeats": current.get("repeats")}
    if int(current.get("repeats") or 0) < min_repeats:
        verdict.update(ok=False, verdict="refused", reason=(
            f"current run has {current.get('repeats')} repeat(s), the gate needs >= "
            f"{min_repeats} — raise --repeats (a one-draw median has no noise band to "
            "judge against)"))
        return verdict
    thin = [h for h in history if int(h.get("repeats") or 0) < min_repeats]
    history = [h for h in history if int(h.get("repeats") or 0) >= min_repeats]
    if not history:
        if thin:
            verdict.update(ok=False, verdict="refused", reason=(
                f"all {len(thin)} matching-fingerprint history record(s) carry fewer than "
                f"{min_repeats} repeats — re-measure the baseline with --repeats raised (a "
                "one-draw history has no noise band to judge against)"))
            return verdict
        verdict.update(ok=True, verdict="no_history", reason=(
            "no matching-fingerprint history — this record seeds the baseline"))
        return verdict
    meds = [float(h["median"]) for h in history]
    iqrs = [float(h.get("iqr") or 0.0) for h in history]
    hist_median = float(np.median(meds))
    scale = max(float(np.median(iqrs)), float(np.subtract(*np.percentile(meds, [75, 25]))))
    cur = float(current["median"])
    direction = current.get("direction", "lower")
    delta = cur - hist_median if direction == "lower" else hist_median - cur
    rel = delta / abs(hist_median) if hist_median else 0.0
    regressed = delta > k * scale and rel > rel_floor
    verdict.update(
        ok=not regressed, verdict="regression" if regressed else "ok",
        history_runs=len(history), history_median=hist_median, band=k * scale,
        delta=delta, rel_delta=round(rel, 4),
        reason=(f"median {cur:.6g}{current.get('unit', '')} vs history {hist_median:.6g} "
                f"({'+' if rel >= 0 else ''}{rel * 100:.1f}%), band k*scale={k * scale:.3g}"
                + (" — REAL regression (outside the noise band and past the relative floor)"
                   if regressed else " — within noise")))
    return verdict


# -- roofline -----------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"

#: published ceilings keyed by ``torch.cuda.get_device_name()``: the f32
#: FLOP/s (the port's products: full f32, TF32 off) and the HBM bytes/s
PEAK_TABLE: dict[str, dict] = {
    H100: {"flops_per_s": PEAK_F32_H100, "bytes_per_s": HBM_BYTES_H100,
           "note": "H100 SXM data sheet: 67T f32 (CUDA cores), 3.35 TB/s HBM3"},
}

#: the serving tiers' FLOP ceilings over the table's f32 base: bf16 runs the
#: tensor cores (989T), int8 runs the f32 forward on dequantized weights
TIER_PEAK_FACTOR: dict[str, float] = {"f32": 1.0, "bf16": PEAK_BF16_H100 / PEAK_F32_H100,
                                      "int8": 1.0}

_MEASURED_PEAK: dict[str, float] = {}
_PEAK_WARNED: set = set()


def measured_matmul_peak(n: int = 512, repeats: int = 5) -> float:
    """FLOP/s of the best of ``repeats`` dense f32 ``n x n`` matmuls under
    ``full_f32`` (CUDA events on the card, the host clock on the CPU); cached
    per process."""
    import torch

    from orp_tpu_torch.utils.precision import full_f32

    key = f"{n}"
    hit = _MEASURED_PEAK.get(key)
    if hit is not None:
        return hit
    full_f32()
    gpu = torch.cuda.is_available()
    a = torch.ones((n, n), dtype=torch.float32, device="cuda" if gpu else "cpu")
    a @ a  # warm-up off the record
    best = float("inf")
    for _ in range(repeats):
        if gpu:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            a @ a
            t1.record()
            t1.synchronize()
            s = t0.elapsed_time(t1) / 1e3
        else:
            c = time.perf_counter()
            a @ a
            s = time.perf_counter() - c
        best = min(best, s)
    peak = 2.0 * n ** 3 / best
    _MEASURED_PEAK[key] = peak
    return peak


def peak_for(device_kind: str | None = None, precision: str = "f32") -> tuple[dict, str]:
    """``(peak_entry, source)`` for a device kind at a serving tier: the table's
    row scaled by :data:`TIER_PEAK_FACTOR` (``"table"``), or the measured
    matmul fallback (``"measured_matmul"``, bytes/s None). ``device_kind=None``
    reads this process's card. Fallbacks warn once per (kind, tier)."""
    import warnings

    if device_kind is None:
        device_kind = _device_kind()
    factor = TIER_PEAK_FACTOR.get(str(precision))
    if factor is None:
        if (device_kind, precision) not in _PEAK_WARNED:
            _PEAK_WARNED.add((device_kind, precision))
            warnings.warn(f"precision tier {precision!r} not in TIER_PEAK_FACTOR "
                          f"({sorted(TIER_PEAK_FACTOR)}) — pricing against the f32 peak "
                          "(fractions-of-peak will read conservative)", stacklevel=2)
        factor, precision = 1.0, "f32"
    entry = PEAK_TABLE.get(str(device_kind))
    if entry is not None:
        out = dict(entry)
        if factor != 1.0:
            out["flops_per_s"] = entry["flops_per_s"] * factor
            out["note"] = f"{entry['note']}; x{factor:g} {precision} tier"
        return out, "table"
    if factor != 1.0 and (device_kind, precision) not in _PEAK_WARNED:
        _PEAK_WARNED.add((device_kind, precision))
        warnings.warn(f"device kind {device_kind!r} not in PEAK_TABLE: no published "
                      f"{precision} peak — using the measured f32 matmul peak, so the "
                      f"{precision} fraction-of-peak will read conservative", stacklevel=2)
    return {"flops_per_s": measured_matmul_peak(), "bytes_per_s": None,
            "note": f"measured f32 matmul peak ({device_kind!r} not in PEAK_TABLE)"}, \
        "measured_matmul"


def roofline(flops: float | None, bytes_accessed: float | None, wall_s: float, *,
             device_kind: str | None = None, precision: str = "f32") -> dict:
    """Join FLOPs and bytes with a measured wall: achieved FLOP/s and bytes/s
    and their fractions of peak (None where a cost or a peak is missing)."""
    if wall_s <= 0:
        raise ValueError(f"roofline: wall_s={wall_s} must be > 0")
    peak, source = peak_for(device_kind, precision)
    out: dict = {"wall_s": round(float(wall_s), 9), "peak_source": source,
                 "peak_flops_per_s": peak["flops_per_s"],
                 "peak_bytes_per_s": peak["bytes_per_s"]}
    if flops:
        achieved = float(flops) / wall_s
        out["achieved_flops_per_s"] = round(achieved, 1)
        out["frac_peak_flops"] = round(achieved / peak["flops_per_s"], 12)
    else:
        out["achieved_flops_per_s"] = out["frac_peak_flops"] = None
    if bytes_accessed and peak["bytes_per_s"]:
        bps = float(bytes_accessed) / wall_s
        out["achieved_bytes_per_s"] = round(bps, 1)
        out["frac_peak_bytes"] = round(bps / peak["bytes_per_s"], 12)
    else:
        out["achieved_bytes_per_s"] = out["frac_peak_bytes"] = None
    return out


# -- the perf-gate measurement and driver ---------------------------------------


def measure_serve_phase(policy, *, repeats: int = 5, evals: int = 32, rows: int = 64,
                        seed: int = 0, device=None) -> dict:
    """The gate's measurement: ``repeats`` timed passes of ``evals`` blocking
    engine evaluations at ``rows`` rows (prewarmed), one ledger record. The
    ``serve/dispatch`` and ``serve/execute`` fault sites sit inside the
    measured path, so an injected delay shows as a slowdown."""
    from orp_tpu_torch.serve.engine import HedgeEngine

    engine = HedgeEngine(policy, device=device)
    nf = engine.model.n_features
    feats = (1.0 + 0.1 * np.random.default_rng(seed).standard_normal((rows, nf))
             ).astype(np.float32)
    engine.prewarm([rows])
    samples = []
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        for i in range(int(evals)):
            engine.evaluate(i % engine.n_dates, feats)  # waits for the device's rows
        samples.append(time.perf_counter() - t0)
    fp_extra = {"rows": int(rows), "evals": int(evals)}
    digest = policy_digest(policy)
    if digest is not None:
        fp_extra["policy"] = digest
    return make_record("serve_engine", "evaluate", samples, fingerprint_extra=fp_extra,
                       extra={"rows": int(rows), "evals": int(evals)})


def gate_cli(*, ledger, bundle=None, workload: str | None = None, phase: str | None = None,
             repeats: int = 5, evals: int = 32, rows: int = 64, k: float = GATE_K,
             min_repeats: int = GATE_MIN_REPEATS, device=None) -> dict:
    """The perf-gate driver. With ``bundle`` (a directory or a loaded policy):
    measure the serve phase now, gate it against the matching history, and
    append it only on a green verdict. Without: gate the ledger's newest record
    (optionally selected by workload and phase) against its own history. The
    measurement reaches obs (``perf/gate_median``) before the verdict."""
    from orp_tpu_torch.obs.spans import count as obs_count
    from orp_tpu_torch.obs.spans import observe as obs_observe

    _refuse_root_ledger(pathlib.Path(ledger))
    records, problems = read_ledger(ledger)
    valid: list[dict] = []
    for i, r in enumerate(records):
        why = validate_perf_record(r)
        if why:
            problems.append(f"record {i + 1} excluded (not a valid orp-perf-v1 record: "
                            f"{'; '.join(why)})")
        else:
            valid.append(r)
    records = valid
    appended = False
    if bundle is not None:
        policy = bundle
        if isinstance(bundle, (str, pathlib.Path)):
            from orp_tpu_torch.serve.bundle import load_bundle

            policy = load_bundle(bundle)
        current = measure_serve_phase(policy, repeats=repeats, evals=evals, rows=rows,
                                      device=device)
        history = matching_history(records, current)
    else:
        pool = [r for r in records
                if (workload is None or r.get("workload") == workload)
                and (phase is None or r.get("phase") == phase)]
        if not pool:
            excluded = "; ".join(p for p in problems if "excluded" in p)
            raise ValueError(
                f"no ledger records match workload={workload!r} phase={phase!r} in {ledger} "
                "— run profile_run / serve_bench (or gate_cli(bundle=DIR)) to seed one"
                + (f" ({excluded} — move the corrupt ledger aside)" if excluded else ""))
        current = pool[-1]
        history = matching_history(pool, current)
    obs_observe("perf/gate_median", float(current["median"]),
                workload=str(current["workload"]), phase=str(current.get("phase", "")),
                unit=str(current.get("unit", "")))
    verdict = gate(current, history, k=k, min_repeats=min_repeats)
    if not verdict["ok"]:
        obs_count("perf/gate_trip", verdict=verdict["verdict"])
    elif bundle is not None:
        try:
            ledger_append(ledger, current)
            appended = True
        except (OSError, ValueError) as e:
            print(f"perf-ledger append failed: {e}", file=sys.stderr)
            problems.append(f"append failed: {e}")
    return {"ledger": str(ledger), "ledger_problems": problems, "record": current,
            "appended": appended, **verdict}
