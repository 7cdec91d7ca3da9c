"""Atomic small-file writes (counterpart of ``orp_tpu/utils/atomic.py``).

Every side file the walk's persistence writes beside its payloads (the run
fingerprint, a checkpoint step, its integrity digest) is written to a temp
file in the same directory, fsynced, then moved over the target with
``os.replace``, which is atomic on POSIX and Windows: a reader sees the old
content or the complete new content, never a torn write. A write that fails
leaves no temp file behind.
"""

from __future__ import annotations

import os
import pathlib
import tempfile


def _atomic_write(path: str | pathlib.Path, data, *, binary: bool) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=p.parent, prefix=f".{p.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        # a failed write (ENOSPC, an interrupt mid-fsync) leaves no temp file
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str | pathlib.Path, text: str) -> None:
    """Write ``text`` to ``path`` atomically (temp file + fsync + ``os.replace``)."""
    _atomic_write(path, text, binary=False)


def atomic_write_bytes(path: str | pathlib.Path, blob: bytes) -> None:
    """Write ``blob`` to ``path`` atomically (temp file + fsync + ``os.replace``)."""
    _atomic_write(path, blob, binary=True)
