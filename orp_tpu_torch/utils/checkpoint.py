"""Step-indexed checkpoints of the backward walk (counterpart of ``orp_tpu/utils/checkpoint.py``).

After each backward date the walk saves that date's increment (its params and
ledger columns), so a walk that was killed resumes at the next date. The
on-disk format is the port's own (the JAX package's is orbax's):

- a step is ``orp_step_<step>.npz``, written by ``np.savez`` and read back with
  ``np.load(allow_pickle=False)``. Leaves go to host numpy first, so the
  layout names no device: a step saved on the card restores on the CPU;
- the payload commits atomically (temp file + fsync + ``os.replace``), then
  its integrity digest ``orp_digest_<step>.sha256``, also atomically: a digest
  never exists for a payload that did not commit;
- the digest is SHA-256 over each leaf's key, dtype, shape and bytes
  (:func:`state_digest`), recomputed and compared on every restore. A
  truncated or bit-flipped step, or a middle step with no digest, is refused
  with a ValueError instead of resuming a walk from garbage.

A state is a dict whose values are tensors, arrays, Python scalars or dicts
of those (one level of nesting: ``{"params1": {"w0": ...}, "v_col": ...}``);
it restores as the same dict of numpy arrays (scalars as 0-d arrays). The
run-fingerprint guard is ``utils/fingerprint.check_fingerprint``.
"""

from __future__ import annotations

import hashlib
import io
import pathlib
import re
import warnings

import numpy as np
import torch

from orp_tpu_torch.utils.atomic import atomic_write_bytes, atomic_write_text
from orp_tpu_torch.utils.fingerprint import check_fingerprint

__all__ = ["check_fingerprint", "latest_complete_step", "latest_step", "load_checkpoint",
           "load_checkpoints", "save_checkpoint", "state_digest"]

_STEP_FILE = "orp_step_{step}.npz"
_DIGEST_FILE = "orp_digest_{step}.sha256"
_STEP_RE = re.compile(r"orp_step_(\d+)\.npz")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(state: dict) -> dict[str, np.ndarray]:
    """``{"a": {"b": x}, "c": y}`` -> ``{"a/b": host(x), "c": host(y)}``."""
    flat = {}
    for k, v in state.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": _host(vv) for kk, vv in v.items()})
        else:
            flat[k] = _host(v)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    state: dict = {}
    for key, v in flat.items():
        head, _, leaf = key.partition("/")
        if leaf:
            state.setdefault(head, {})[leaf] = v
        else:
            state[head] = v
    return state


def state_digest(state: dict) -> str:
    """SHA-256 over every leaf's key, dtype, shape and raw bytes, in key order:
    the integrity identity of one checkpoint step."""
    h = hashlib.sha256()
    for key, x in sorted(_flatten(state).items()):
        h.update(key.encode())
        h.update(str(x.dtype).encode())
        h.update(str(x.shape).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def save_checkpoint(directory: str | pathlib.Path, step: int, state: dict) -> None:
    """Persist ``state`` as step ``step``, then its integrity digest. Redoing a
    step (a torn save recomputed on resume) drops its old digest first, so a
    stale digest never vouches for a new payload."""
    d = pathlib.Path(directory)
    flat = _flatten(state)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    (d / _DIGEST_FILE.format(step=step)).unlink(missing_ok=True)
    atomic_write_bytes(d / _STEP_FILE.format(step=step), buf.getvalue())
    atomic_write_text(d / _DIGEST_FILE.format(step=step), state_digest(flat))


def _steps(directory: str | pathlib.Path) -> list[int]:
    d = pathlib.Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for p in d.iterdir() if (m := _STEP_RE.fullmatch(p.name)))


def latest_step(directory: str | pathlib.Path) -> int | None:
    """Highest saved step in ``directory``, or None if nothing is saved."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def latest_complete_step(directory: str | pathlib.Path) -> int | None:
    """Highest step whose payload AND integrity digest landed: the step a
    resume may trust. A kill between the payload's commit and the digest's
    leaves the latest step unverifiable; that step is treated as unsaved (its
    date is recomputed) rather than refusing the whole directory. Only the
    latest step can lack its digest legitimately, so a digest-less middle step
    still refuses in the loaders."""
    last = latest_step(directory)
    if last is None:
        return None
    if (pathlib.Path(directory) / _DIGEST_FILE.format(step=last)).exists():
        return last
    warnings.warn(
        f"checkpoint step {last} in {pathlib.Path(directory)} committed without its "
        "integrity digest (save was interrupted between commit and digest write); "
        "treating it as unsaved — that step will be recomputed on resume", stacklevel=2)
    return last - 1 if last > 0 else None


def load_checkpoint(directory: str | pathlib.Path, step: int) -> dict:
    """Restore the state saved at ``step``, integrity-verified."""
    d = pathlib.Path(directory)
    df = d / _DIGEST_FILE.format(step=step)
    if not df.exists():
        raise ValueError(
            f"checkpoint step {step} in {d} has no integrity digest ({df.name}) — a "
            "partial copy, or a save torn between commit and digest write; refusing to "
            "resume from unverifiable state (resume callers should pick their step via "
            "latest_complete_step)")
    try:
        with np.load(d / _STEP_FILE.format(step=step), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:  # the zip and npy layers raise a zoo of types on a torn file
        raise ValueError(
            f"checkpoint step {step} in {d} could not be restored ({type(e).__name__}: "
            f"{e}) — truncated or corrupted on disk; refusing to resume") from e
    want, got = df.read_text().strip(), state_digest(flat)
    if got != want:
        raise ValueError(
            f"checkpoint step {step} in {d} failed its integrity check (digest "
            f"{got[:12]}… != recorded {want[:12]}…) — truncated or corrupted on disk; "
            "refusing to resume")
    return _unflatten(flat)


def load_checkpoints(directory: str | pathlib.Path, steps):
    """Yield the states saved at each of ``steps``, each integrity-verified; a
    corrupt middle step refuses the whole resume."""
    for step in steps:
        yield load_checkpoint(directory, step)
