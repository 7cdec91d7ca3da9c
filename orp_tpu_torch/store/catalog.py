"""Versioned tenant→manifest catalog over the content-addressed store
(counterpart of ``orp_tpu/store/catalog.py``).

A published "bundle" stops being a directory copy and becomes a MANIFEST of
CAS pointers: one ``orp-manifest-v1`` document per tenant version recording
the policy identity (the same 12-hex policy digest the JAX package binds into perf
fingerprints), the bundle's file tree as ``relpath -> sha256`` pointers
(params tree, per-topology AOT executable blobs, baseline/quality
sidecars), and a TREE digest over the pointer set. The manifest itself
lives in the CAS (content-addressed like everything else); the catalog —
one atomic ``catalog.json`` at the store root — maps tenant names to their
manifest-version chains.

Tiering hangs off the tree digest: ``materialize`` lands a manifest's files
under ``<root>/warm/<tree-digest>`` — keyed by CONTENT, not tenant — so a
thousand tenants publishing the same trained policy share ONE warm
directory, and a cold activation after the first pays catalog resolution
plus an existence check, not a second copy.

The documents are canonical JSON with no clock or random field, so one bundle
directory published by either package gives byte-identical blobs, manifests and
``catalog.json``. ``aot_topologies`` lists the bundle's ``aot/`` entries (the
port's sets, ``aot/bundle_exec.py``, under their ``<topo>[+tier]`` keys), read
off the published tree as the JAX package reads its own.

``serve/bundle.py`` speaks this layer through ``store://<root>#<tenant>``
source URIs (``load_bundle`` resolves them here) and ``export_bundle``'s
``store=``/``tenant=`` publish hook.
"""

from __future__ import annotations

import json
import pathlib

from orp_tpu_torch.store.cas import CasStore, blob_digest
from orp_tpu_torch.utils.atomic import atomic_write_bytes, atomic_write_text
from orp_tpu_torch.utils.fingerprint import FINGERPRINT_FILE

CATALOG_FILE = "catalog.json"
CATALOG_FORMAT = "orp-catalog-v1"
MANIFEST_FORMAT = "orp-manifest-v1"
WARM_SUBDIR = "warm"
#: ``load_bundle`` source-string prefix: ``store://<root>#<tenant>[@<ver>]``
STORE_URI_PREFIX = "store://"


def parse_store_uri(uri: str) -> tuple[str, str, int | None]:
    """``store://<root>#<tenant>[@<version>]`` → ``(root, tenant, version)``.
    The fragment separator is ``#`` so the root may be any filesystem path
    (including ones containing ``@``)."""
    body = uri[len(STORE_URI_PREFIX):]
    root, sep, tenant = body.rpartition("#")
    if not sep or not root or not tenant:
        raise ValueError(
            f"malformed store URI {uri!r} — expected "
            "store://<root-dir>#<tenant>[@<version>]")
    version: int | None = None
    name, at, ver = tenant.rpartition("@")
    if at and ver.isdigit():
        tenant, version = name, int(ver)
    return root, tenant, version


def _canonical_json(doc: dict) -> bytes:
    """One byte encoding per document — manifests are content-addressed,
    so their serialization must be deterministic."""
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


class BundleStore:
    """CAS + catalog under one root directory; the unit ``orp store``,
    doctor and the serve plane operate on."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.cas = CasStore(self.root)
        self._doc: dict | None = None

    # -- catalog document ----------------------------------------------------

    @property
    def catalog_file(self) -> pathlib.Path:
        return self.root / CATALOG_FILE

    def _load(self) -> dict:
        if self._doc is None:
            f = self.catalog_file
            if f.exists():
                doc = json.loads(f.read_text())
                if doc.get("format") != CATALOG_FORMAT:
                    raise ValueError(
                        f"{f} carries format {doc.get('format')!r}, this "
                        f"build reads {CATALOG_FORMAT!r} — not a catalog "
                        "written by this framework")
                self._doc = doc
            else:
                self._doc = {"format": CATALOG_FORMAT, "tenants": {}}
        return self._doc

    def flush(self) -> None:
        """Persist the catalog atomically (readers see old or new, never a
        torn document)."""
        if self._doc is not None:
            atomic_write_text(
                self.catalog_file,
                json.dumps(self._doc, indent=1, sort_keys=True) + "\n")

    # -- publish -------------------------------------------------------------

    def _tree_of(self, bundle_dir: pathlib.Path) -> tuple[dict, str]:
        """CAS-ingest every file under ``bundle_dir``; returns the
        ``relpath -> {digest, bytes}`` tree plus its tree digest (hash of
        the canonical pointer set — the warm-directory key)."""
        tree: dict = {}
        for f in sorted(bundle_dir.rglob("*")):
            if not f.is_file():
                continue
            rel = f.relative_to(bundle_dir).as_posix()
            digest, size = self.cas.put_file(f)
            tree[rel] = {"digest": digest, "bytes": size}
        if not tree:
            raise ValueError(f"{bundle_dir} holds no files to publish")
        return tree, blob_digest(_canonical_json(tree))

    def publish(self, tenant: str, bundle_dir, *, flush: bool = True) -> dict:
        """Publish the exported bundle at ``bundle_dir`` as a new catalog
        version of ``tenant``. Every file lands in the CAS (shared files
        dedup to existing blobs); the tenant entry grows one manifest
        pointer. Returns ``{tenant, version, manifest, tree, files}``."""
        return self.publish_many([tenant], bundle_dir, flush=flush)[tenant]

    def publish_many(self, tenants, bundle_dir, *,
                     flush: bool = True) -> dict:
        """Publish ONE bundle directory under many tenant names — the
        whole-book case (an insurer's near-identical tenants referencing
        the same trained policy). The directory is hashed once; each
        tenant gets its own manifest (distinct blob — the tenant name is
        part of the document) over the shared file tree."""
        d = pathlib.Path(bundle_dir)
        fp_file = d / FINGERPRINT_FILE
        if not fp_file.exists():
            raise ValueError(
                f"{d} has no {FINGERPRINT_FILE} — not an exported bundle "
                "(run `orp export --out` first)")
        fingerprint = fp_file.read_text()
        tree, tree_digest = self._tree_of(d)
        aot_topos = sorted(
            rel.split("/")[1] for rel in tree
            if rel.startswith("aot/") and rel.endswith("/aot.json"))
        doc = self._load()
        out: dict = {}
        for tenant in tenants:
            manifest = {
                "format": MANIFEST_FORMAT,
                "tenant": str(tenant),
                "fingerprint": fingerprint,
                "policy": blob_digest(fingerprint.encode())[:12],
                "tree": tree_digest,
                "aot_topologies": aot_topos,
                "files": tree,
            }
            m_digest = self.cas.put(_canonical_json(manifest))
            ent = doc["tenants"].setdefault(
                str(tenant), {"version": 0, "manifests": []})
            if not ent["manifests"] or ent["manifests"][-1] != m_digest:
                ent["version"] += 1
                ent["manifests"].append(m_digest)
            out[str(tenant)] = {
                "tenant": str(tenant), "version": ent["version"],
                "manifest": m_digest, "tree": tree_digest,
                "files": len(tree)}
        if flush:
            self.flush()
        return out

    # -- resolve / materialize / load ----------------------------------------

    def tenants(self) -> dict:
        """``{name: {"version": n, "manifest": <latest digest>}}``."""
        doc = self._load()
        return {name: {"version": ent["version"],
                       "manifest": ent["manifests"][-1]}
                for name, ent in sorted(doc["tenants"].items())}

    def resolve(self, tenant: str, version: int | None = None) -> dict:
        """The tenant's manifest document (latest, or a specific catalog
        ``version``), fetched digest-verified from the CAS."""
        doc = self._load()
        ent = doc["tenants"].get(str(tenant))
        if ent is None:
            raise KeyError(
                f"tenant {tenant!r} not in catalog {self.catalog_file} — "
                f"published: {sorted(doc['tenants'])[:8]}; publish with "
                "`orp store put`")
        chain = ent["manifests"]
        if version is None:
            m_digest = chain[-1]
        elif 1 <= version <= len(chain):
            m_digest = chain[version - 1]
        else:
            raise KeyError(
                f"tenant {tenant!r} has versions 1..{len(chain)}, "
                f"not {version}")
        return json.loads(self.cas.get(m_digest).decode())

    def materialize(self, tenant: str, version: int | None = None,
                    dest: str | pathlib.Path | None = None) -> pathlib.Path:
        """Land the tenant's manifest files on local disk (the warm tier)
        and return the directory. Default destination is keyed by TREE
        digest — every tenant sharing the policy shares the directory, and
        a re-materialization only fills in what is missing (size-checked;
        the bytes were digest-verified coming out of the CAS)."""
        manifest = self.resolve(tenant, version)
        d = (pathlib.Path(dest) if dest is not None
             else self.root / WARM_SUBDIR / manifest["tree"][:16])
        for rel, ent in manifest["files"].items():
            target = d / rel
            if target.is_file() and target.stat().st_size == ent["bytes"]:
                continue
            atomic_write_bytes(target, self.cas.get(ent["digest"]))
        return d

    def load(self, tenant: str, version: int | None = None):
        """Cold→warm→hot entry point: resolve the manifest, materialize
        the warm directory, hand it to ``load_bundle`` — bitwise the same
        policy a direct directory load would produce (the port's
        ``load_bundle``)."""
        from orp_tpu_torch.serve.bundle import load_bundle

        return load_bundle(str(self.materialize(tenant, version)))

    def remove(self, tenant: str, *, flush: bool = True) -> None:
        """Drop a tenant's catalog entry (its blobs become gc-collectable
        once nothing else references them)."""
        doc = self._load()
        doc["tenants"].pop(str(tenant), None)
        if flush:
            self.flush()

    # -- accounting + gc -----------------------------------------------------

    def referenced(self) -> set:
        """The catalog's full closure: every retained manifest digest plus
        every file digest those manifests point at. The gc root set — a
        digest in here is never collected."""
        doc = self._load()
        refs: set = set()
        for ent in doc["tenants"].values():
            for m_digest in ent["manifests"]:
                refs.add(m_digest)
                try:
                    manifest = json.loads(self.cas.get(m_digest).decode())
                except KeyError:
                    continue  # dangling manifest ref — stats() reports it
                for f in manifest["files"].values():
                    refs.add(f["digest"])
        return refs

    def gc(self, *, dry_run: bool = False) -> dict:
        """Collect every blob outside the catalog closure. Referenced
        blobs — any manifest in any retained version, and every file they
        point at — are never touched."""
        return self.cas.gc(self.referenced(), dry_run=dry_run)

    def stats(self) -> dict:
        """The store's accounting in one document: tenant/manifest counts,
        physical blob footprint, logical referenced bytes, the dedup ratio
        (logical/physical — 1.0 means no sharing), plus the two health
        counters doctor speaks in flag-speak: dangling refs (catalog
        points at a missing blob) and orphan blobs (physical bytes nothing
        references — reclaimable via gc)."""
        doc = self._load()
        refs = self.referenced()
        physical = self.cas.stats()
        on_disk = set(self.cas.digests())
        ref_bytes = manifests = dangling = 0
        for ent in doc["tenants"].values():
            manifests += len(ent["manifests"])
            for m_digest in ent["manifests"]:
                if m_digest not in on_disk:
                    dangling += 1
                    continue
                ref_bytes += self.cas.size_of(m_digest)
                manifest = json.loads(self.cas.get(m_digest).decode())
                for f in manifest["files"].values():
                    if f["digest"] in on_disk:
                        ref_bytes += f["bytes"]
                    else:
                        dangling += 1
        orphans = on_disk - refs
        return {
            "tenants": len(doc["tenants"]),
            "manifests": manifests,
            "blobs": physical["blobs"],
            "blob_bytes": physical["bytes"],
            "ref_bytes": ref_bytes,
            "dedup_ratio": (round(ref_bytes / physical["bytes"], 3)
                            if physical["bytes"] else 0.0),
            "dangling_refs": dangling,
            "orphan_blobs": len(orphans),
            "orphan_bytes": sum(self.cas.size_of(d) for d in orphans),
        }


def open_store(root: str | pathlib.Path) -> BundleStore:
    """The one constructor callers outside the package use."""
    return BundleStore(root)
