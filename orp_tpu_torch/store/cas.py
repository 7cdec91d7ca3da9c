"""Content-addressed blob store (counterpart of ``orp_tpu/store/cas.py``): every
artifact exactly once, keyed by hash.

A liability book is thousands of near-identical tenants whose params trees,
per-topology AOT executables and baseline/quality sidecars are massively
shareable (Buehler et al. frame hedging as one policy per book — the book's
tenants mostly reference the SAME trained policy). Storing bundles as
directory copies multiplies that shared payload per tenant; a
content-addressed store holds each distinct byte string exactly once, no
matter how many tenant manifests point at it.

The layout, the digest and ``gc`` are the JAX package's, so a store written by
either package is read by the other.

Layout: ``<root>/blobs/<aa>/<sha256-hex>`` — two-hex-char fan-out so a
million blobs never land in one directory. Three invariants this module
owns:

- **atomic**: every blob lands via ``utils/atomic.py``'s
  write-temp-then-``os.replace``; concurrent ``put``
  of the same digest is idempotent — both writers replace the path with
  identical bytes, readers never observe a torn blob.
- **tamper-refusing**: ``get`` re-hashes what it read and refuses a
  mismatch loudly (a flipped bit in a params tree must never silently
  serve), counted on ``store/cas_corrupt``.
- **refcounted gc**: ``gc`` removes only blobs outside the caller-supplied
  referenced set (the catalog's closure); a referenced blob is never
  collected.
"""

from __future__ import annotations

import hashlib
import pathlib

from orp_tpu_torch.obs.spans import count as obs_count
from orp_tpu_torch.utils.atomic import atomic_write_bytes

BLOBS_SUBDIR = "blobs"
#: sha256 hex — the one digest this store speaks (the policy fingerprint
#: digest in perf records is the first 12 chars of the same function)
DIGEST_HEX_LEN = 64


class CasIntegrityError(ValueError):
    """A blob's bytes no longer hash to its name: bit rot, truncation or
    tampering. The read is refused — a corrupt params tree or executable
    must never reach an engine."""


def blob_digest(data: bytes) -> str:
    """The store's one addressing function: sha256 hex of the bytes."""
    return hashlib.sha256(data).hexdigest()


class CasStore:
    """sha256-addressed blob store under ``root`` (created lazily)."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)

    @property
    def blobs_dir(self) -> pathlib.Path:
        return self.root / BLOBS_SUBDIR

    def _blob_path(self, digest: str) -> pathlib.Path:
        if len(digest) != DIGEST_HEX_LEN or not all(
                c in "0123456789abcdef" for c in digest):
            raise ValueError(
                f"not a sha256 hex digest: {digest!r} (expected "
                f"{DIGEST_HEX_LEN} lowercase hex chars)")
        return self.blobs_dir / digest[:2] / digest

    # -- write path ----------------------------------------------------------

    def put(self, data: bytes) -> str:
        """Store ``data``, returning its digest. Idempotent and
        concurrency-safe: an existing blob short-circuits (the dedup hit
        the whole store exists for, counted on ``store/cas_hit``); two
        racing writers of the same digest both atomically replace the path
        with identical bytes."""
        digest = blob_digest(data)
        p = self._blob_path(digest)
        if p.exists():
            obs_count("store/cas_hit")
            return digest
        atomic_write_bytes(p, data)
        obs_count("store/cas_write")
        return digest

    def put_file(self, path: str | pathlib.Path) -> tuple[str, int]:
        """``put`` the contents of ``path``; returns ``(digest, n_bytes)``."""
        data = pathlib.Path(path).read_bytes()
        return self.put(data), len(data)

    # -- read path -----------------------------------------------------------

    def has(self, digest: str) -> bool:
        return self._blob_path(digest).exists()

    def get(self, digest: str) -> bytes:
        """The blob's bytes, re-hashed on every read. A missing blob is a
        ``KeyError`` (dangling reference); a hash mismatch is a
        :class:`CasIntegrityError` — the blob is NOT returned."""
        p = self._blob_path(digest)
        if not p.exists():
            raise KeyError(
                f"blob {digest[:12]}… not in store {self.root} — a dangling "
                "reference (gc'd out from under a manifest, or a partial "
                "copy); re-publish the tenant with `orp store put`")
        data = p.read_bytes()
        if blob_digest(data) != digest:
            obs_count("store/cas_corrupt")
            raise CasIntegrityError(
                f"blob {digest[:12]}… in {self.root} does not hash to its "
                "name — bit rot or tampering; refusing to serve it. Delete "
                f"{p} and re-publish the referencing tenant(s)")
        return data

    def size_of(self, digest: str) -> int:
        return self._blob_path(digest).stat().st_size

    # -- accounting + gc -----------------------------------------------------

    def digests(self):
        """Every digest physically present (sorted, for stable output)."""
        d = self.blobs_dir
        if not d.is_dir():
            return
        for fan in sorted(d.iterdir()):
            if not fan.is_dir():
                continue
            for blob in sorted(fan.iterdir()):
                if len(blob.name) == DIGEST_HEX_LEN:
                    yield blob.name

    def stats(self) -> dict:
        """Physical footprint: ``{"blobs": n, "bytes": total}``."""
        n = total = 0
        for digest in self.digests():
            n += 1
            total += self.size_of(digest)
        return {"blobs": n, "bytes": total}

    def gc(self, referenced, *, dry_run: bool = False) -> dict:
        """Remove every blob NOT in ``referenced`` (a set of digests — the
        catalog's full closure: manifests plus everything they point at).
        A referenced blob is never touched, even if its fan-out directory
        otherwise empties. Returns counts + reclaimed bytes."""
        referenced = set(referenced)
        removed = removed_bytes = kept = 0
        for digest in list(self.digests()):
            if digest in referenced:
                kept += 1
                continue
            p = self._blob_path(digest)
            size = p.stat().st_size
            if not dry_run:
                p.unlink()
                try:
                    p.parent.rmdir()  # drop an emptied fan-out dir
                except OSError:
                    pass
            removed += 1
            removed_bytes += size
        if removed and not dry_run:
            obs_count("store/cas_gc", n=removed)
        return {"removed": removed, "removed_bytes": removed_bytes,
                "kept": kept, "dry_run": bool(dry_run)}
