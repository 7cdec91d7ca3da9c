"""The native (C++) host QMC engine through ``ctypes`` (counterpart of ``orp_tpu/native``).

``qmc_host.cc`` (this package's own copy) is built with ``g++`` at first use
into ``lib_qmc_host-<digest>.so`` under the port's build cache
(``utils/cuda_build.build_dir``: ``build/orp_tpu_torch/`` by default, which
``.gitignore`` lists), the file name carrying the source's digest so an
edited source is rebuilt; the JAX package builds next to its source. It
generates scrambled-Sobol uniforms and normals on the host with no torch
tensor involved, from the port's Joe-Kuo table (``qmc/sobol._directions_host``),
and is an independent implementation the tests hold bitwise against the
port's ``qmc.sobol_uniform`` in float64.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "qmc_host.cc"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_SCRAMBLE_MODES = {"none": 0, "owen": 1, "shift": 2}
_lib = None
_lock = threading.Lock()


def _so_path() -> pathlib.Path:
    from orp_tpu_torch.utils.cuda_build import build_dir

    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib_qmc_host-{digest[:16]}.so"


def _build(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native QMC library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.sobol_uniform_host.argtypes = [u32p, u32p, ctypes.c_uint64, u32p, ctypes.c_uint64,
                                           ctypes.c_uint32, ctypes.c_int, f64p]
        lib.sobol_normal_host.argtypes = lib.sobol_uniform_host.argtypes
        lib.ndtri_host.argtypes = [f64p, ctypes.c_uint64, f64p]
        for fn in (lib.sobol_uniform_host, lib.sobol_normal_host, lib.ndtri_host):
            fn.restype = None
        _lib = lib
        return lib


def _run(fn_name: str, indices, dims, seed: int, scramble: str) -> np.ndarray:
    from orp_tpu_torch.qmc.sobol import _directions_host

    if scramble not in _SCRAMBLE_MODES:
        raise ValueError(f"scramble={scramble!r}: expected one of {sorted(_SCRAMBLE_MODES)}")
    lib = load_library()
    dirs = np.ascontiguousarray(_directions_host(), dtype=np.uint32)
    idx = np.ascontiguousarray(indices, dtype=np.uint32)
    dm = np.ascontiguousarray(np.atleast_1d(dims), dtype=np.uint32)
    if dm.max(initial=0) >= dirs.shape[0]:
        raise ValueError(f"dim {dm.max()} exceeds direction table ({dirs.shape[0]})")
    out = np.empty((idx.shape[0], dm.shape[0]), dtype=np.float64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    getattr(lib, fn_name)(dirs.ctypes.data_as(u32p), idx.ctypes.data_as(u32p),
                          ctypes.c_uint64(idx.shape[0]), dm.ctypes.data_as(u32p),
                          ctypes.c_uint64(dm.shape[0]), ctypes.c_uint32(seed & 0xFFFFFFFF),
                          ctypes.c_int(_SCRAMBLE_MODES[scramble]),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def sobol_uniform_host(indices, dims, seed: int = 0, scramble: str = "owen") -> np.ndarray:
    """Host scrambled-Sobol uniforms ``(n, d)`` in float64, bitwise
    ``qmc.sobol_uniform(..., dtype=torch.float64)``."""
    return _run("sobol_uniform_host", indices, dims, seed, scramble)


def sobol_normal_host(indices, dims, seed: int = 0, scramble: str = "owen") -> np.ndarray:
    """Host Sobol N(0,1) draws (Wichura AS241 inverse normal)."""
    return _run("sobol_normal_host", indices, dims, seed, scramble)


def ndtri_host(u) -> np.ndarray:
    """Inverse normal CDF on the host (AS241, ~1e-16 relative accuracy)."""
    lib = load_library()
    arr = np.ascontiguousarray(u, dtype=np.float64)
    out = np.empty_like(arr)
    lib.ndtri_host(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   ctypes.c_uint64(arr.size), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out.reshape(arr.shape)
