"""Run manifests and the hash-linked chain (counterpart of ``orp_tpu/obs/manifest.py``).

A ``manifest.json`` answers "what exactly produced these numbers?". It
records:

- the run-config fingerprint (``config_fingerprint``: the joined reprs of the
  run's config dataclasses, whose reprs equal the JAX package's, so a
  manifest of either package string-compares against the same configs);
- the numerics environment: torch and CUDA versions, platform and device
  count;
- the code identity: git revision and dirty flag (best effort: a deployed
  tree has no ``.git`` and the manifest must still write).

``write_manifest`` is what the telemetry session drops next to
``events.jsonl`` and ``metrics.prom``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import threading
import time

MANIFEST_SCHEMA = "orp-obs-manifest-v1"
MANIFEST_FILE = "manifest.json"

CHAIN_SCHEMA = "orp-chain-v1"
CHAIN_FILE = "promotions.jsonl"


def config_fingerprint(*configs) -> str:
    """Canonical fingerprint of a run configuration: the joined reprs of its
    (frozen-dataclass) config objects. Same property the checkpoint/bundle
    fingerprints lean on — reprs are total over fields, so ANY config change
    changes the string; equal configs always agree."""
    return " | ".join(repr(c) for c in configs)


def git_revision(cwd: str | pathlib.Path | None = None) -> dict:
    """``{"rev": str | None, "dirty": bool | None}`` — best-effort (no git,
    no repo, or a timeout all degrade to None rather than failing the run)."""
    base = pathlib.Path(cwd) if cwd else pathlib.Path(__file__).resolve().parent
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=base, capture_output=True,
            text=True, timeout=10,
        )
        if rev.returncode != 0:
            return {"rev": None, "dirty": None}
        status = subprocess.run(
            ["git", "status", "--porcelain"], cwd=base, capture_output=True,
            text=True, timeout=10,
        )
        return {
            "rev": rev.stdout.strip(),
            "dirty": bool(status.stdout.strip()) if status.returncode == 0 else None,
        }
    except (OSError, subprocess.SubprocessError):
        return {"rev": None, "dirty": None}


def build_manifest(*, run_fingerprint: str | None = None,
                   extra: dict | None = None) -> dict:
    """Assemble the manifest dict: the JAX package's fields, with the port's
    stack where it names JAX's (``torch_version`` and ``cuda_version`` for
    ``jax_version`` and ``jaxlib_version``, ``torch_error`` for
    ``jax_error``). ``platform`` is ``"gpu"`` when a card is visible (the
    port's default device) and ``"cpu"`` otherwise; ``device_count`` is
    ``torch.cuda.device_count()``."""
    m: dict = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": time.time(),
        "run_fingerprint": run_fingerprint,
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
    }
    try:
        import torch

        m["torch_version"] = torch.__version__
        m["cuda_version"] = torch.version.cuda
        m["platform"] = "gpu" if torch.cuda.is_available() else "cpu"
        m["device_count"] = torch.cuda.device_count()
    except Exception as e:  # orp: noqa[ORP009] -- the error is recorded: provenance must not kill the run
        m["torch_error"] = f"{type(e).__name__}: {e}"
    m["git"] = git_revision()
    if extra:
        m.update(extra)
    return m


def write_manifest(directory: str | pathlib.Path, *,
                   run_fingerprint: str | None = None,
                   extra: dict | None = None) -> pathlib.Path:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / MANIFEST_FILE
    path.write_text(json.dumps(
        build_manifest(run_fingerprint=run_fingerprint, extra=extra),
        indent=1, sort_keys=False) + "\n")
    return path


def read_manifest(directory: str | pathlib.Path) -> dict:
    return json.loads(
        (pathlib.Path(directory) / MANIFEST_FILE).read_text())


# -- manifest chains ----------------------------------------------------------
#
# An append-only hash-linked JSONL ledger: each record carries ``prev`` = the
# SHA-256 of the previous record's exact serialized line (the first links to
# "genesis"), so any in-place edit, deletion or reordering breaks every later
# link and ``chain_verify`` reports exactly where. The JAX package's
# ``ServeHost.reload_tenant`` appends every promotion verdict here; the
# lines are byte-identical across the two packages for the same records.

# appends from one process serialize here; the hash link makes cross-process
# interleaving detectable rather than silently corrupting
_CHAIN_LOCK = threading.Lock()


def _chain_line(record: dict) -> str:
    """The canonical serialization whose bytes are hashed: sorted keys, no
    whitespace variance — re-serializing a parsed record reproduces it."""
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


def _chain_tail(p: pathlib.Path) -> tuple[str | None, int, bool]:
    """``(last_line, next_seq, ends_with_newline)`` read from the file TAIL
    only — appends must stay O(1) in ledger size, not re-read the whole
    history. ``next_seq`` comes from the last complete record's own ``seq``;
    a torn or seq-less tail falls back to counting every line (rare, and
    correctness beats speed exactly then)."""
    size = p.stat().st_size
    if size == 0:
        return None, 0, True
    with open(p, "rb") as f:
        f.seek(max(0, size - 65536))
        chunk = f.read().decode("utf-8", errors="replace")
    ends_nl = chunk.endswith("\n")
    tail_lines = [ln for ln in chunk.splitlines() if ln]
    last = tail_lines[-1] if tail_lines else None
    try:
        seq = json.loads(last)["seq"]
        if isinstance(seq, int):
            return last, seq + 1, ends_nl
    except (TypeError, ValueError, KeyError):
        pass
    # torn/seq-less tail (or a last line longer than the tail chunk):
    # count honestly
    lines = [ln for ln in p.read_text().splitlines() if ln]
    return (lines[-1] if lines else None), len(lines), ends_nl


def chain_append(path: str | pathlib.Path, record: dict) -> dict:
    """Append ``record`` to the chain at ``path``, stamping ``schema`` /
    ``seq`` / ``ts_unix`` / ``prev`` (the previous line's SHA-256, or
    ``"genesis"``). Returns the stamped record as written.

    ``seq``/``prev`` are derived from the file TAIL — appends are O(1) in
    ledger size — and a torn tail (a crash mid-append) must not make every
    later verdict append raise. The successor links to the torn line's raw
    bytes (its hash chain stays intact past it); the damage is detected by
    ``chain_verify``'s PARSE check on the torn line itself, so the ledger
    reports the crash without the appender masking a reload's real
    outcome."""
    p = pathlib.Path(path)
    with _CHAIN_LOCK:
        p.parent.mkdir(parents=True, exist_ok=True)
        if p.exists():
            last, seq, ends_nl = _chain_tail(p)
        else:
            last, seq, ends_nl = None, 0, True
        prev = ("genesis" if last is None
                else hashlib.sha256(last.encode("utf-8")).hexdigest())
        # integrity stamps LAST: a caller's record must never override the
        # derived prev/seq (e.g. a record read back via read_chain during a
        # ledger merge) — forged or stale stamps would break, or worse
        # satisfy, the very links verify checks
        stamped = {**record, "schema": CHAIN_SCHEMA, "seq": int(seq),
                   "ts_unix": time.time(), "prev": prev}
        with open(p, "a") as f:  # orp: noqa[ORP021] -- _CHAIN_LOCK exists to serialize tail-read + append; the file I/O IS the critical section
            if not ends_nl:
                # a torn tail has no newline — never concatenate the new
                # record onto it (that would corrupt THIS record too)
                f.write("\n")
            f.write(_chain_line(stamped) + "\n")
    return stamped


def read_chain(path: str | pathlib.Path) -> list[dict]:
    """Parse a chain back into records (strict: a torn line raises)."""
    p = pathlib.Path(path)
    if not p.exists():
        return []
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln]


def chain_verify(path: str | pathlib.Path) -> dict:
    """Walk the chain re-deriving every hash link. Returns ``{"ok", "length",
    "problems"}`` — any edited, dropped or reordered record breaks the link
    at its successor and lands in ``problems`` with its seq."""
    p = pathlib.Path(path)
    problems: list[str] = []
    if not p.exists():
        return {"ok": True, "length": 0, "problems": []}
    lines = [ln for ln in p.read_text().splitlines() if ln]
    prev_hash = "genesis"
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            # keep WALKING: the hash link is over raw line bytes, so every
            # later record stays verifiable past a torn line — stopping
            # here would let an edit further down hide behind the known
            # crash artifact
            problems.append(f"line {i}: does not parse ({e})")
            prev_hash = hashlib.sha256(line.encode("utf-8")).hexdigest()
            continue
        if rec.get("schema") != CHAIN_SCHEMA:
            problems.append(
                f"seq {rec.get('seq', i)}: schema {rec.get('schema')!r} != "
                f"{CHAIN_SCHEMA!r}")
        if rec.get("seq") != i:
            problems.append(f"line {i}: seq {rec.get('seq')!r} != {i}")
        if rec.get("prev") != prev_hash:
            problems.append(
                f"seq {rec.get('seq', i)}: prev-hash link broken (the "
                "preceding record was edited, removed or reordered)")
        # hash the line EXACTLY as stored; also catch non-canonical storage
        # (a rewritten line with reordered keys re-hashes differently)
        if _chain_line(rec) != line:
            problems.append(
                f"seq {rec.get('seq', i)}: non-canonical serialization "
                "(rewritten in place?)")
        prev_hash = hashlib.sha256(line.encode("utf-8")).hexdigest()
    return {"ok": not problems, "length": len(lines), "problems": problems}
