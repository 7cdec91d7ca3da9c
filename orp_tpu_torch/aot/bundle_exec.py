"""Per-bucket CUDA graphs and the card's libraries inside policy bundles (counterpart of ``orp_tpu/aot/bundle_exec.py``).

A bundle (``serve/bundle.py``) ships params and metadata; a cold serve
process still built its libraries with ``nvcc`` and dispatched each bucket op
by op. This module adds the missing artifact, keyed by the topology and tier
it was made for::

    <bundle>/aot/aot.json                  index: format + the topology set
    <bundle>/aot/<topo>[+tier]/aot.json    manifest: device fingerprint, policy
                                           fingerprint, tier, libraries, buckets
    <bundle>/aot/<topo>[+tier]/lib<name>-<digest>.so

``<topo>`` is ``parallel.mesh.topology_fingerprint`` (``gpu-NVIDIA_H100_80GB_HBM3-n1``),
``+tier`` marks the non-f32 tiers. The port's "executable" has two parts:

1. the ``sm_90a`` libraries the engine's lanes call (``libmixed_head``,
   ``libfused_mf``), copied under their source digest
   (``cuda_build.lib_path``);
2. one CUDA graph for each bucket of the manifest: the tiled per-date forward
   (``serve/engine._eval_tiled``, cuBLAS and elementwise kernels) on static
   input buffers, the date a 0-d device tensor copied in before each replay.
   Graphs cannot be serialized, so :func:`load_aot` captures them from the
   engine's params once the bundle's libraries are installed.

:func:`load_aot` checks the format, the device fingerprint, the policy
fingerprint, the tier and each library's digest against the current
``csrc/``; it installs the libraries into the build cache when they are
absent (so ``nvcc`` runs 0 times), then returns ``{bucket: AotExecutable}``.

Fallback contract (the reference's): any mismatch or capture failure warns
once (``warnings.warn`` + an ``aot/fingerprint_mismatch`` counter event) and
returns ``{}``; the engine then serves on its eager path, which launches the
same kernels on the same card. ``AOT_FORMAT`` is the port's own string, so
each package refuses the other's set through that path.

Topology: one set per topology, as in the JAX package. A mesh of N ranks is N
processes here, each serving its contiguous shard of every bucket and
gathering the shards (``serve/engine.py``): its set (``<platform>-<kind>-nN``)
is a manifest of the padded buckets (``pad_to_mesh(next_bucket(b))``) that
one process writes without a group, and lists no library, since the mesh
engine launches no kernel (the per-date path). Each rank's :func:`load_aot`
captures one graph per bucket of THAT RANK'S SHARD's forward; the gather stays
outside the graph (a ``gloo`` collective cannot be captured).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import warnings

import torch

from orp_tpu_torch.aot.compile import (AotUnsupported, _need_card, aot_compile, cost_summary,
                                       device_fingerprint)
from orp_tpu_torch.obs import count as obs_count
# the JAX package's ``_topo_entry``: a topology's index row, built without a group
from orp_tpu_torch.parallel.mesh import topology_entry as _topo_entry
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.atomic import atomic_write_text

AOT_SUBDIR = "aot"
AOT_META = "aot.json"
AOT_FORMAT = "orp-aot-torch-v1"
#: the libraries a set ships (every source the engine's lanes may load)
LIBRARIES = cuda_build.SOURCES

#: every power-of-two bucket up to the serve-bench schedule's 1000-row max
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


class AotExecutable:
    """One bucket's captured CUDA graph of the tiled forward and its static
    inputs. :meth:`call` copies a request's padded rows and its date in,
    replays, and returns copies of the outputs (the next replay overwrites the
    graph's own), all on the calling thread's current stream, under a lock so
    that two dispatching threads never interleave their copy-in and replay."""

    __slots__ = ("bucket", "captured", "meta", "_lock")

    def __init__(self, bucket: int, captured, meta: dict):
        self.bucket = int(bucket)
        self.captured = captured
        self.meta = meta
        self._lock = threading.Lock()

    @classmethod
    def capture(cls, engine, bucket: int) -> "AotExecutable":
        """Capture ``engine``'s forward of one ``bucket`` (its params, tier,
        combines and cost of capital are baked in): all of its rows, or on a
        mesh engine this rank's shard of them."""
        from orp_tpu_torch.parallel.mesh import mesh_size
        from orp_tpu_torch.serve.engine import _eval_tiled

        dev = engine.device
        dt = engine.model.dtype
        rows = int(bucket) // mesh_size(engine.mesh)
        date = torch.zeros((), dtype=torch.int64, device=dev)
        feats = torch.zeros((rows, engine.model.n_features), dtype=dt, device=dev)
        prices = torch.zeros((rows, engine.n_instruments), dtype=dt, device=dev)
        model, p1, p2, coc = engine.model, engine._p1, engine._p2, engine.cost_of_capital

        def forward(d, f, p, **kw):
            return _eval_tiled(model, p1, p2, d, f, p, coc, **kw)

        captured, meta = aot_compile(
            forward, date, feats, prices, label=f"eval_tiled/{bucket}", site="serve_bucket",
            cost=cost_summary(model, rows, n_heads=1 if engine.dual_mode == "mse_only" else 2,
                              precision=engine.precision.tier),
            dual_mode=engine.dual_mode, holdings_combine=engine.holdings_combine,
            precision=engine.precision.tier)
        return cls(bucket, captured, meta)

    def call(self, date_idx: int, feats: torch.Tensor, prices: torch.Tensor):
        """``(phi, psi, value)`` of the padded rows (a mesh rank's shard of
        them) at ``date_idx``: fresh tensors on the device, bitwise the eager
        forward's."""
        date, f, p = self.captured.args
        with self._lock:
            f.copy_(feats)
            p.copy_(prices)
            date.fill_(int(date_idx))
            outs = self.captured.replay()
            return tuple(o.clone() for o in outs)


def _tier_key(topo_key: str, tier: str) -> str:
    """The set's directory: the bare topology for f32, ``<topo>+<tier>`` else."""
    return topo_key if tier == "f32" else f"{topo_key}+{tier}"


def _time_replays(captured, n: int = 3) -> float:
    """Median of ``n`` replays' CUDA-event seconds (after one off the record)."""
    captured.replay()
    walls = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        captured.replay()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b) / 1e3)
    return sorted(walls)[n // 2]


def _export_one_topology(adir: pathlib.Path, engine, buckets, policy_fingerprint) -> dict:
    """Ship the libraries and stamp every bucket's capture into ``adir``."""
    from orp_tpu_torch.obs import perf as _perf

    adir.mkdir(parents=True, exist_ok=True)
    cuda_build.build_all(LIBRARIES)
    libs = {}
    for name in LIBRARIES:
        src = cuda_build.lib_path(name)
        shutil.copyfile(src, adir / src.name)
        libs[name] = src.name
    for stale in adir.glob("lib*.so"):
        if stale.name not in libs.values():
            stale.unlink()
    entries = {}
    for n in sorted({int(b) for b in buckets}):
        b = engine.bucket_for(n)
        if str(b) in entries:
            continue
        ex = AotExecutable.capture(engine, b)
        exec_s = _time_replays(ex.captured)
        meta = {k: v for k, v in ex.meta.items() if k != "fn"}
        entries[str(b)] = {**meta, "execute_wall_s": round(exec_s, 9),
                           "roofline": _perf.roofline(meta.get("flops"),
                                                      meta.get("bytes_accessed"), exec_s,
                                                      precision=engine.precision.tier)}
        del ex
    manifest = {"format": AOT_FORMAT, "fingerprint": device_fingerprint(engine.device),
                "topology": _topo_entry(None, engine.device),
                "policy_fingerprint": policy_fingerprint,
                "precision": engine.precision.tier, "libraries": libs, "buckets": entries}
    # written last: the manifest never names a library that did not finish copying
    atomic_write_text(adir / AOT_META, json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def _export_mesh_set(adir: pathlib.Path, engine, spec, buckets, policy_fingerprint) -> dict:
    """The set of an ``spec.n_devices``-rank mesh into ``adir``: the manifest
    of its padded buckets, each with its shard's rows and the shard forward's
    analytic cost. No library (the mesh engine launches no kernel) and no graph
    (each rank captures its shard's at load), so one process writes it, with
    no group and on any device."""
    from orp_tpu_torch.parallel.mesh import pad_to_mesh
    from orp_tpu_torch.serve.engine import next_bucket

    adir.mkdir(parents=True, exist_ok=True)
    for stale in adir.glob("lib*.so"):
        stale.unlink()
    n_dev = spec.n_devices
    tier = engine.precision.tier
    entries = {}
    for n in sorted({int(b) for b in buckets}):
        b = pad_to_mesh(next_bucket(n, min_bucket=engine.min_bucket), spec)
        if b > engine.max_bucket:
            raise ValueError(f"bucket {b} (for {n} rows on {n_dev} ranks) exceeds "
                             f"max_bucket={engine.max_bucket}")
        entries[str(b)] = {"fn": f"eval_tiled/{b}", "shard_rows": b // n_dev, "precision": tier,
                           **cost_summary(engine.model, b // n_dev, precision=tier,
                                          n_heads=1 if engine.dual_mode == "mse_only" else 2)}
    manifest = {"format": AOT_FORMAT, "fingerprint": device_fingerprint(engine.device),
                "topology": _topo_entry(spec, engine.device),
                "policy_fingerprint": policy_fingerprint, "precision": tier, "libraries": {},
                "libraries_note": ("none: a mesh engine serves on the per-date path, which "
                                   "launches no kernel of the package"),
                "buckets": entries}
    atomic_write_text(adir / AOT_META, json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def _kept_topologies(adir: pathlib.Path, policy_fingerprint) -> dict:
    """The index rows a re-export keeps: this format's sets built for this
    policy. Stale sets (another policy, or torn) lose their row and their files."""
    index_f = adir / AOT_META
    kept: dict = {}
    try:
        prev = json.loads(index_f.read_text())
    except (OSError, json.JSONDecodeError):
        return kept
    if prev.get("format") != AOT_FORMAT:
        return kept
    for key, row in prev.get("topologies", {}).items():
        tdir = adir / row.get("dir", key)
        try:
            old = json.loads((tdir / AOT_META).read_text())
        except (OSError, json.JSONDecodeError):
            old = {}
        if old.get("policy_fingerprint") == policy_fingerprint and old.get("format") == AOT_FORMAT:
            kept[key] = row
        else:
            shutil.rmtree(tdir, ignore_errors=True)
    return kept


def export_aot(directory: str | pathlib.Path, policy, *, buckets=DEFAULT_BUCKETS,
               meshes=(None,), precision="f32", device=None) -> dict:
    """Ship ``policy``'s AOT sets into ``<directory>/aot/<topo>[+tier]/``, one
    per topology of ``meshes`` (``directory`` is the policy's bundle dir).
    ``meshes`` entries are None (one device), ints, ``MeshSpec`` s or built
    meshes; a 1-rank mesh is the single-device topology. The single-device
    set holds the libraries and each bucket's graph captured, timed and
    stamped with its roofline (the graphs themselves are captured again by
    :func:`load_aot`), and needs a card (:class:`AotUnsupported` without
    one); a mesh's set is the manifest :func:`_export_mesh_set` writes, from
    this one process. ``buckets`` are request sizes, rounded up as a live
    request on that topology would be. Returns the index with the manifests
    inlined under ``"topologies"``."""
    from orp_tpu_torch.parallel.mesh import spec_of
    from orp_tpu_torch.serve.engine import HedgeEngine

    specs = []
    for m in meshes:
        spec = spec_of(m)
        if spec is not None and spec.n_devices is None:
            import torch.distributed as dist

            spec = spec_of(dist.get_world_size() if dist.is_initialized() else 1)
        specs.append(None if spec is None or spec.n_devices == 1 else spec)
    if None in specs:
        _need_card("export_aot of the single-device set")
    engine = HedgeEngine(policy, use_aot=False, precision=precision, device=device)
    if None in specs and engine.device.type != "cuda":
        raise AotUnsupported("export_aot captures CUDA graphs for the single-device set: "
                             f"pass a CUDA device (got {engine.device})")
    adir = pathlib.Path(directory) / AOT_SUBDIR
    adir.mkdir(parents=True, exist_ok=True)
    pf = getattr(policy, "fingerprint", None)
    index = {"format": AOT_FORMAT, "topologies": _kept_topologies(adir, pf)}
    out = {"format": AOT_FORMAT, "topologies": {}}
    for spec in dict.fromkeys(specs):
        key = _tier_key(_topo_entry(spec, engine.device)["dir"], engine.precision.tier)
        if spec is None:
            manifest = _export_one_topology(adir / key, engine, buckets, pf)
        else:
            manifest = _export_mesh_set(adir / key, engine, spec, buckets, pf)
        index["topologies"][key] = {**manifest["topology"], "dir": key}
        out["topologies"][key] = manifest
    atomic_write_text(adir / AOT_META, json.dumps(index, indent=1, sort_keys=True))
    return out


def _fingerprint_diffs(saved: dict, device=None) -> list[str]:
    here = device_fingerprint(device)
    return [f"{k}: bundle={saved.get(k)!r} here={v!r}" for k, v in here.items()
            if saved.get(k) != v]


def _check_set(adir: pathlib.Path, *, mesh, precision: str, device,
               policy_fingerprint=None) -> tuple[str | None, dict | None, pathlib.Path | None]:
    """The one check of the set for the caller's topology (``mesh``: None, a
    rank count, a ``MeshSpec`` or the engine's built mesh) and tier under
    ``adir`` (whose index exists), shared by :func:`load_aot` and
    :func:`aot_status`: ``(reason it cannot be used or None, manifest, set
    directory)``. It checks the index and manifest format, the topology and
    tier key, the manifest's rank count, the device fingerprint, the policy
    fingerprint (when given), the tier, and that each library was built from
    this checkout's ``csrc/`` and is in the cache or the set; it installs
    nothing."""
    try:
        index = json.loads((adir / AOT_META).read_text())
    except json.JSONDecodeError as e:
        return f"unreadable {AOT_META}: {e}", None, None
    if index.get("format") != AOT_FORMAT:
        return (f"format {index.get('format')!r} != {AOT_FORMAT} (not this package's set — "
                "re-export it with this package)"), None, None
    topo = _topo_entry(mesh, device)
    key = _tier_key(topo["dir"], precision)
    topos = index.get("topologies", {})
    if key not in topos:
        return f"no set for topology+tier {key!r} (bundle ships: {sorted(topos)})", None, None
    tdir = adir / topos[key].get("dir", key)
    try:
        manifest = json.loads((tdir / AOT_META).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return f"topology {key!r} manifest unreadable: {e}", None, None
    if manifest.get("format") != AOT_FORMAT:
        return f"format {manifest.get('format')!r} != {AOT_FORMAT}", None, None
    got_n = (manifest.get("topology") or {}).get("n_devices")
    if got_n != topo["n_devices"]:
        return (f"topology mesh size mismatch: set n_devices={got_n} here="
                f"{topo['n_devices']}"), None, None
    diffs = _fingerprint_diffs(manifest.get("fingerprint") or {}, device)
    if diffs:
        return "device/runtime fingerprint mismatch — " + "; ".join(diffs), None, None
    if (policy_fingerprint is not None
            and manifest.get("policy_fingerprint") != policy_fingerprint):
        return ("policy fingerprint mismatch (the set was exported for a different policy)",
                None, None)
    saved_tier = manifest.get("precision", "f32")
    if saved_tier != precision:
        return (f"precision tier mismatch: the set was exported for {saved_tier!r}, this engine "
                f"serves {precision!r}"), None, None
    for name, fname in (manifest.get("libraries") or {}).items():
        if name not in LIBRARIES:
            return f"unknown library {name!r}", None, None
        want = cuda_build.lib_path(name)
        if fname != want.name:
            return (f"library {fname} was built from another csrc/ than this checkout's "
                    f"({want.name}): re-export the set"), None, None
        if not want.exists() and not (tdir / fname).exists():
            return f"library {fname} missing from the set", None, None
    return None, manifest, tdir


def aot_status(directory: str | pathlib.Path, *, mesh=None, precision: str = "f32",
               device=None) -> dict:
    """Non-loading coverage probe: does the bundle ship a usable set for the
    caller's topology (``mesh``, as :func:`load_aot`) and tier?
    ``{"present", "ok", "detail", "topologies"}``,
    without the load path's warning; "covered" exactly where :func:`load_aot`
    would install the set (the same check)."""
    adir = pathlib.Path(directory) / AOT_SUBDIR
    out = {"present": False, "ok": True, "detail": "no AOT artifacts", "topologies": []}
    if not (adir / AOT_META).exists():
        return out
    out["present"] = True
    try:
        out["topologies"] = sorted(json.loads((adir / AOT_META).read_text())
                                   .get("topologies", {}))
    except json.JSONDecodeError:
        pass
    why, manifest, tdir = _check_set(adir, mesh=mesh, precision=precision, device=device)
    if why is not None:
        return {**out, "ok": False, "detail": why}
    buckets = sorted(int(b) for b in manifest.get("buckets", {}))
    return {**out, "detail": f"set {tdir.name!r} covered (buckets {buckets})"}


#: this process's fallbacks to the eager path by kind: a bucket graph whose
#: capture failed (``"capture"``) or a set refused before any capture
#: (``"set"``) — read by the smoke's [pilot], which builds engines while
#: another tenant's batcher is launching
FALLBACKS = {"capture": 0, "set": 0}


def _fallback(directory, reason: str) -> dict:
    """The one warning an unusable set gives before the engine keeps its eager path."""
    FALLBACKS["capture" if reason.startswith("capture failed") else "set"] += 1
    warnings.warn(f"AOT set under {directory} is unusable ({reason}); serving on the eager "
                  "path (correct, but a cold start pays its builds and op-by-op dispatch)",
                  stacklevel=3)
    obs_count("aot/fingerprint_mismatch", reason=reason[:160])
    return {}


def _install(tdir: pathlib.Path, libs: dict) -> None:
    """Each shipped library (checked by :func:`_check_set`) into the build
    cache where absent."""
    for name, fname in libs.items():
        want = cuda_build.lib_path(name)
        if want.exists():
            continue
        want.parent.mkdir(parents=True, exist_ok=True)
        tmp = want.with_suffix(f".{os.getpid()}.tmp")
        shutil.copyfile(tdir / fname, tmp)
        os.replace(tmp, want)


def load_aot(directory: str | pathlib.Path, *, policy_fingerprint: str | None = None,
             mesh=None, precision: str = "f32", engine=None, device=None) -> dict | None:
    """The AOT set for the caller's topology (``mesh``: None, a rank count, a
    ``MeshSpec`` or the engine's built mesh) and tier from ``<directory>/aot/``.

    Returns None when the bundle ships no AOT artifacts, ``{}`` after ONE
    warning when they exist but cannot be used here (format, topology or tier
    not exported, device or runtime fingerprint, policy fingerprint, a library
    built from another ``csrc/``, a capture failure), else ``{bucket:
    AotExecutable}`` captured on ``engine`` (``{bucket: None}`` when no engine
    is given: the set checked and its libraries installed). On a mesh engine
    each rank captures its shard's graph of every bucket."""
    adir = pathlib.Path(directory) / AOT_SUBDIR
    if not (adir / AOT_META).exists():
        return None
    if engine is not None:
        device, mesh = engine.device, engine.mesh
    why, manifest, tdir = _check_set(adir, mesh=mesh, precision=precision, device=device,
                                     policy_fingerprint=policy_fingerprint)
    if why is not None:
        return _fallback(directory, why)
    _install(tdir, manifest.get("libraries") or {})
    buckets = sorted(int(b) for b in manifest.get("buckets", {}))
    if engine is None:
        return {b: None for b in buckets}
    try:
        return {b: AotExecutable.capture(engine, b) for b in buckets}
    except Exception as e:  # orp: noqa[ORP009] -- every failure here has one answer: the eager path
        return _fallback(directory, f"capture failed: {type(e).__name__}: {e}")
