"""Tracing and timing helpers (counterpart of ``orp_tpu/utils/profiling.py``).

- ``trace(name)``: ``torch.profiler.record_function`` while a profiler runs,
  the counterpart of ``jax.profiler.TraceAnnotation``, so phases (simulate /
  fit / analytics) show up as named spans in a ``torch.profiler`` capture;
  outside one it is a no-op, as a ``TraceAnnotation`` costs nothing outside
  a trace (a ``record_function`` region costs ~10 us of host time even with
  no profiler, which a 1-row serve request would pay three times);
- ``timed(fn, *args)``: wall timing that waits for the CUDA device of
  every tensor in the result tree before it stops the clock, so the figure
  is the device's time, not the launch queue's;
- ``block_until_ready(name, tree)``: that wait, shared with ``obs``'s
  device-complete spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


def trace(name: str):
    """A ``record_function`` region named ``name`` while a ``torch.profiler``
    (or ``torch.autograd.profiler``) capture runs, else a no-op context."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in ``tree``: tensors, dicts, lists,
    tuples and dataclasses (``BackwardResult``) nest; numpy arrays, Python
    scalars and anything else hold no device work."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


def block_until_ready(name: str, tree) -> None:
    """Wait until the current stream of every CUDA device holding a tensor of
    ``tree`` has finished (a CPU tree needs no wait). Under a CUDA-graph
    capture a wait cannot happen: it raises, naming ``name`` (a span, or
    what ``tree`` is)."""
    devices = _cuda_devices(tree, set())
    if not devices:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name!r} waits for its result inside a CUDA-graph capture, where "
            "nothing has run yet; close it outside the captured region")
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def timed(fn, *args, **kwargs):
    """Run ``fn`` and return ``(result, seconds)``, waiting until every CUDA
    device that holds a tensor of the result is done."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    block_until_ready(getattr(fn, "__name__", "timed"), out)
    return out, time.perf_counter() - t0
