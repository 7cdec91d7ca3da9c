"""Ahead-of-time builds and captures of the hot programs, with the bill itemised (counterpart of ``orp_tpu/aot/compile.py``).

The port compiles no XLA programs. Its one-time costs are the ``nvcc`` runs
that build the ``sm_90a`` libraries (``utils/cuda_build``) and the CUDA-graph
captures of the serve buckets and of the fused walk's iterations. This module
makes them measured artifacts, with the reference's names:

- :class:`CompileTimeMonitor`: the seconds of ``nvcc`` runs and graph captures
  inside a ``with`` region (read from ``cuda_build.BUILD_STATS``, which every
  build and every capture site of the port feeds), so one run reports its
  compile wall beside its execute wall;
- :func:`cost_summary`: the analytic FLOPs and bytes of one bucket of the
  serve forward, from ``utils/flops.py`` and the program's shapes (there is no
  XLA ``cost_analysis``);
- :func:`aot_compile`: one CUDA graph of ``fn`` captured on static inputs
  (a warm-up call on a side stream, then the capture), the walls and the cost
  in the ``aot/lower`` (warm-up) and ``aot/compile`` (capture) spans and the
  ``aot/compiles`` counter and ``aot_flops`` / ``aot_bytes_accessed`` gauges;
- :func:`device_fingerprint`: the platform, device name, compute capability,
  device count and the torch, CUDA runtime and driver versions a shipped
  library and a bundle's bucket set are only valid under;
- :func:`warm_fused_walk`: the fused walk's library into the persistent
  cache (``aot/cache.py``), so that a fresh process with the same cache runs
  ``nvcc`` 0 times; then the fused walk's programs captured on empty tensors
  of the walk's shapes, no path simulated, which measures their capture
  seconds and persists nothing.

CUDA graphs and ``nvcc`` need a card: on the CPU :func:`aot_compile` and
:func:`warm_fused_walk` raise :class:`AotUnsupported`.
"""

from __future__ import annotations

import ctypes
import time

import torch

from orp_tpu_torch.obs import count as obs_count
from orp_tpu_torch.obs import set_gauge as obs_set_gauge
from orp_tpu_torch.obs import span as obs_span
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils import flops as _flops


class AotUnsupported(RuntimeError):
    """This process cannot build or capture what an AOT artifact needs (no
    card); the caller keeps the eager path, which is always correct."""


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise AotUnsupported(
            f"{what} needs a CUDA device (CUDA graphs and nvcc builds run on the card); this "
            "process sees none — serve on the eager path, or run on a card")


class CompileTimeMonitor:
    """The ``nvcc`` and graph-capture seconds inside a ``with`` region.

    ``seconds`` is their sum, ``nvcc`` and ``captures`` their counts and
    ``events`` the two counts together; ``supported`` is always True (the
    port's build and capture sites all report to ``cuda_build.BUILD_STATS``)."""

    def __init__(self) -> None:
        self.supported = True
        self._t0 = None
        self._t1 = None

    @staticmethod
    def _snap() -> dict:
        return dict(cuda_build.BUILD_STATS)

    def __enter__(self) -> "CompileTimeMonitor":
        self._t0, self._t1 = self._snap(), None
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = self._snap()

    def _delta(self, key: str):
        if self._t0 is None:
            return 0
        end = self._t1 if self._t1 is not None else cuda_build.BUILD_STATS
        return end[key] - self._t0[key]

    @property
    def nvcc(self) -> int:
        return int(self._delta("nvcc"))

    @property
    def captures(self) -> int:
        return int(self._delta("captures"))

    @property
    def events(self) -> int:
        return self.nvcc + self.captures

    @property
    def seconds(self) -> float:
        return float(self._delta("nvcc_s") + self._delta("capture_s"))

    def split(self, total_wall_s: float) -> dict:
        """``{"compile_wall_s", "execute_wall_s"}`` of a region that took
        ``total_wall_s`` in all."""
        return {"compile_wall_s": round(self.seconds, 3),
                "execute_wall_s": round(max(total_wall_s - self.seconds, 0.0), 3)}


def cost_summary(model, n_rows: int, *, n_heads: int = 1, precision: str = "f32") -> dict:
    """FLOPs and bytes of one ``n_rows``-row bucket of the serve forward
    (``serve/engine._eval_core``): ``n_heads`` forwards of the model (2 for a
    dual policy), each a multiply-add of every layer (2 FLOPs); bytes are the
    rows read once (features and prices in the model's dtype), one date's
    weights per head at the tier's element size, and the outputs written
    once (holdings, psi and value in f32)."""
    n_features, n_outputs = model.n_features, model.n_outputs
    fwd = _flops.mlp_forward_flops(n_features, tuple(model.hidden), n_outputs)
    n_params = _flops.mlp_param_count(n_features, tuple(model.hidden), n_outputs)
    elem = torch.empty((), dtype=model.dtype).element_size()
    n_instruments = 2 if model.constrain_self_financing else n_outputs
    w_elem = {"bf16": 2, "int8": 1}.get(precision, elem)
    rows_in = n_rows * (n_features + n_instruments) * elem
    rows_out = n_rows * (max(n_outputs - 1, 1) + 2) * 4
    return {"flops": float(n_heads * n_rows * fwd),
            "bytes_accessed": float(rows_in + rows_out + n_heads * n_params * w_elem)}


class CapturedGraph:
    """One captured CUDA graph: its static inputs (``args``, refilled by the
    caller before :meth:`replay`) and its static outputs."""

    __slots__ = ("graph", "args", "outputs")

    def __init__(self, graph, args, outputs):
        self.graph, self.args, self.outputs = graph, args, outputs

    def replay(self):
        self.graph.replay()
        return self.outputs


def aot_compile(fn, *args, label: str, cost: dict | None = None, site: str = "aot_graph",
                **static_kwargs):
    """Capture ``fn(*args, **static_kwargs)`` as one CUDA graph on the static
    tensors ``args``; returns ``(captured, meta)``. The warm-up call (cuBLAS
    handles, workspaces) runs on a side stream under ``aot/lower``, the
    capture under ``aot/compile``; ``meta`` carries both walls, the ``nvcc``
    seconds inside them and ``cost``'s FLOPs and bytes. ``site`` names the
    capture site it is counted at (``cuda_build.CAPTURE_SITES``)."""
    _need_card("aot_compile")
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    with CompileTimeMonitor() as mon:
        t0 = time.perf_counter()
        with obs_span("aot/lower", attrs={"fn": label}):
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn(*args, **static_kwargs)
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        with obs_span("aot/compile", attrs={"fn": label}):
            graph = torch.cuda.CUDAGraph()
            # thread-local: other threads keep launching (a batcher's worker, a
            # degraded engine's replays) while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = fn(*args, **static_kwargs)
        t2 = time.perf_counter()
        cuda_build.count_capture(t2 - t1, site=site)
    meta = {"fn": label, "lower_wall_s": round(t1 - t0, 6),
            "compile_wall_s": round(t2 - t1, 6),
            "backend_compile_s": round(mon.seconds - (t2 - t1), 6), **(cost or {})}
    if "precision" in static_kwargs:
        meta["precision"] = static_kwargs["precision"]
    obs_count("aot/compiles", fn=label)
    for key in ("flops", "bytes_accessed"):
        if key in meta:
            obs_set_gauge(f"aot_{key}", meta[key], fn=label)  # orp: noqa[ORP015] -- the name set is the two-element literal tuple above (aot_flops / aot_bytes_accessed): bounded by construction
    return CapturedGraph(graph, args, outputs), meta


def _driver_version() -> int | None:
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        return int(v.value) if lib.cuDriverGetVersion(ctypes.byref(v)) == 0 else None
    except OSError:
        return None


def device_fingerprint(device=None) -> dict:
    """What a shipped library set and its bucket graphs are only valid under:
    ``platform`` (``"gpu"`` / ``"cpu"``), ``device_kind``,
    ``compute_capability``, ``n_devices``, and the ``torch``, ``cuda``
    (runtime) and ``driver`` versions."""
    gpu = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    if not gpu:
        return {"platform": "cpu", "device_kind": "cpu", "compute_capability": None,
                "n_devices": 1, "torch": torch.__version__, "cuda": None, "driver": None}
    idx = torch.device(device).index if device is not None else None
    idx = torch.cuda.current_device() if idx is None else idx
    major, minor = torch.cuda.get_device_capability(idx)
    return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(idx),
            "compute_capability": f"{major}.{minor}", "n_devices": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "driver": _driver_version()}


def warm_fused_walk(model, cfg, *, n_paths: int, n_dates: int, dtype=None) -> dict:
    """Build the library the fused walk launches (``fused_mf``: its
    simulation kernels) into the persistent cache, so that a fresh process on
    that cache runs ``nvcc`` 0 times; then capture the fused walk's programs
    (``train/backward._fused_programs``: the GN legs' LM iterations, or Adam's
    epochs) on empty tensors of the walk's shapes, without simulating any
    path. The capture only measures the capture seconds a run will pay: CUDA
    graphs cannot be serialized, so it persists nothing. ``cfg`` is the
    ``BackwardConfig`` the run will use (``fused=True``). Returns the bill:
    ``nvcc`` runs and seconds, captures and their seconds, the wall."""
    from orp_tpu_torch.train.backward import _fused_programs

    if not cfg.fused:
        raise ValueError("warm_fused_walk captures the fused walk; pass a cfg with fused=True "
                         "(the program being warmed)")
    _need_card("warm_fused_walk")
    dt = model.dtype if dtype is None else dtype
    dev = torch.device("cuda", torch.cuda.current_device())
    label = f"fused_walk/{n_paths}x{n_dates}"
    with CompileTimeMonitor() as mon:
        t0 = time.perf_counter()
        with obs_span("aot/lower", attrs={"fn": label}):
            built = cuda_build.build_all(("fused_mf",))
        t1 = time.perf_counter()
        feats = torch.empty((n_paths, model.n_features), dtype=dt, device=dev)
        prices = torch.empty((n_paths, model.n_hedge_assets + 1), dtype=model.dtype, device=dev)
        target = torch.empty((n_paths,), dtype=dt, device=dev)
        with obs_span("aot/compile", attrs={"fn": label}):
            _fused_programs(model, cfg, feats, prices, target)
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
    obs_count("aot/compiles", fn=label)
    return {"fn": label, "n_paths": int(n_paths), "n_dates": int(n_dates),
            "libraries": sorted(built), "nvcc_runs": mon.nvcc,
            "lower_wall_s": round(t1 - t0, 3), "compile_wall_s": round(t2 - t1, 3),
            "captures": mon.captures, "backend_compile_s": round(mon.seconds, 3),
            "cache_dir": str(cuda_build.build_dir())}
