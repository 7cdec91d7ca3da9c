"""Measurements on a CUDA card for ``chip_smoke.py`` and the ``tools/torch_*.py``
scripts: CUDA-event times, the synchronizing calls of a run, a scope in which a
host sync raises, and one Gauss-Newton LM iteration's launch and graph census.

Nothing in the library calls these; each one needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import time
import warnings

import torch

#: host-side CUDA calls that each queue one piece of work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls.

    Before each round a sleep kernel holds the card while the host queues the
    round's calls, so a call's host cost (a wrapper's checks and its launch)
    does not show between the launches of a kernel shorter than it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # 2e9 cycles a second: at least the wall asked for at the H100's clocks
        torch.cuda._sleep(int(min(2.0 * reps * host_s, 0.2) * 2e9))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result and the
    synchronizing CUDA calls it made (one warning each). Inside a
    :func:`no_host_sync` scope a sync raises instead."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On a CUDA ``device``, make any host sync in the scope raise
    (``torch.cuda.set_sync_debug_mode("error")``, restored on exit). The mode
    holds for every thread of the process while the scope is open. Installed
    as ``train/backward.fused_loop_scope``, it checks that the fused walk's
    date loop reads nothing back."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def graph_nodes(graph) -> tuple[int, int] | None:
    """``(nodes, kernel nodes)`` of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``,
    read through ``libcuda`` (``cuGraphGetNodes``, ``cuGraphNodeGetType``); None if
    that library cannot be loaded."""
    import ctypes

    try:
        cu = ctypes.CDLL("libcuda.so.1")
        g = ctypes.c_void_p(graph.raw_cuda_graph())
    except (OSError, TypeError, AttributeError, RuntimeError):
        return None
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        return None
    kinds = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kinds))
        kernels += kinds.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return n.value, kernels


def lm_census(problem) -> dict:
    """One LM iteration of a ``train/gn.gn_program`` at its shapes, launched op by op
    and as a CUDA graph: ms each (CUDA events, median of rounds), host launch calls
    and device kernels of the eager iteration (``torch.profiler``), and a second
    capture of the same iteration kept as a graph: capture and instantiate seconds
    and its nodes (kernel nodes)."""
    from torch.profiler import ProfilerActivity, profile

    theta = problem.theta.clone()
    problem.start(theta)
    out = {"eager_ms": cuda_ms(problem.iterate, reps=3, rounds=5)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        problem.iterate()
        torch.cuda.synchronize()
    out["host_launches"] = sum(e.count for e in prof.key_averages() if e.key in HOST_LAUNCHES)
    out["device_kernels"] = sum(1 for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:  # a torch without keep_graph: capture and instantiate as one
        graph = None
    kept = graph is not None
    graph = graph or torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        problem.iterate()
    out["capture_s"] = time.perf_counter() - t0  # orp: noqa[ORP017] -- times the capture itself: kernels are recorded, not launched, under torch.cuda.graph
    t0 = time.perf_counter()
    if kept:
        graph.instantiate()
    torch.cuda.synchronize()
    out["instantiate_s"] = time.perf_counter() - t0 if kept else None
    out["nodes"] = graph_nodes(graph) if kept else None
    problem.start(theta)
    out["graph_ms"] = cuda_ms(graph.replay, reps=3, rounds=5)
    del graph
    return out
