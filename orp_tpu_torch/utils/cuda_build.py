"""Build the port's CUDA sources with ``nvcc`` and load them through ``ctypes``.

Each ``orp_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``lib<name>-<hash>.so`` under the build cache
(:func:`build_dir`: the directory ``aot.cache.enable_persistent_cache`` set,
else ``$ORP_TORCH_CACHE_DIR``, else ``build/orp_tpu_torch/`` at the root of the
checkout, which ``.gitignore`` lists). The directory is resolved at each build
and load, so a redirect mid-process takes effect. The file name carries
a hash of the source and of the shared ``csrc/*.cuh`` headers, so an edited
kernel is rebuilt and a stale library is never loaded. :func:`build_all` starts one ``nvcc`` per source at once and
waits for all of them, so the build costs the slowest source, not their sum.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` and deliberately no
``--use_fast_math``: ``__logf``/``__expf`` would move the AS241 tail and the
knots' ``exp`` away from the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "orp_tpu_torch"
#: environment override of the build cache (the counterpart of ``ORP_JAX_CACHE_DIR``)
ENV_CACHE_DIR = "ORP_TORCH_CACHE_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
SOURCES = ("mixed_head", "fused_mf")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what this process has built, loaded and captured: ``nvcc`` runs started and
#: their wall seconds, libraries loaded, and CUDA graphs captured by the port's
#: capture sites and their seconds (a warm re-activation of a served policy moves
#: none of them)
BUILD_STATS = {"nvcc": 0, "nvcc_s": 0.0, "loads": 0, "captures": 0, "capture_s": 0.0}
#: the port's build and capture sites, by name: ``nvcc`` runs; CUDA graphs
#: captured of an Adam epoch (``fit_epoch``), a GN iteration
#: (``gn_iteration``), a served bucket (``serve_bucket``) and any other
#: ``aot.aot_compile`` (``aot_graph``); and the programs the fused walk builds
#: before its date loop (``walk_program``, on any device: the card captures
#: each once)
CAPTURE_SITES = ("nvcc", "fit_epoch", "gn_iteration", "serve_bucket", "aot_graph",
                 "walk_program")
#: this process's count at each site (what ``lint/trace_audit.CompileAudit``
#: budgets)
SITE_COUNTS = dict.fromkeys(CAPTURE_SITES, 0)
#: the directory ``aot.cache.enable_persistent_cache`` pointed the cache at
_override: pathlib.Path | None = None


def build_dir() -> pathlib.Path:
    """Where libraries are built and loaded from, resolved now: the redirect of
    :func:`set_build_dir`, else ``$ORP_TORCH_CACHE_DIR``, else :data:`BUILD_DIR`."""
    if _override is not None:
        return _override
    env = os.environ.get(ENV_CACHE_DIR)
    return pathlib.Path(env) if env else BUILD_DIR


def set_build_dir(directory) -> None:
    """Redirect the build cache for the rest of the process (None: back to the
    environment / default resolution). Libraries already loaded stay loaded."""
    global _override
    _override = None if directory is None else pathlib.Path(directory)


def count_capture(seconds: float, site: str = "aot_graph") -> None:
    """One CUDA graph captured at ``site`` in ``seconds`` (the ``aot`` plane's
    compile bill)."""
    with _lock:
        BUILD_STATS["captures"] += 1
        BUILD_STATS["capture_s"] += float(seconds)
        SITE_COUNTS[site] += 1


def count_site(site: str) -> None:
    """One event at ``site`` (:data:`CAPTURE_SITES`) that is not a capture."""
    with _lock:
        SITE_COUNTS[site] += 1


def nvcc_path() -> str:
    """The ``nvcc`` binary: ``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []):
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> pathlib.Path:
    """The library file ``csrc/<name>.cu`` builds to in the current cache: its
    name carries the digest of the source, the shared headers (part of every
    source's identity) and the flags."""
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temp file; None when already built."""
    out = lib_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_STATS["nvcc"] += 1
    SITE_COUNTS["nvcc"] += 1
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns ``{name: ptxas report}``.

    Raises with the compiler's output when any source fails to build."""
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        reports, failed = {}, []
        for n, job in jobs.items():
            if job is None:
                reports[n] = "cached"
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc rc {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
            reports[n] = log
        if any(job is not None for job in jobs.values()):
            BUILD_STATS["nvcc_s"] += time.perf_counter() - t0
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
            BUILD_STATS["loads"] += 1
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function.

    Every source exports ``orp_cuda_error_string`` for the message."""
    if rc == 0:
        return
    fn = lib.orp_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{what}: CUDA launch failed: {fn(rc).decode()} (cudaError_t {rc})")
