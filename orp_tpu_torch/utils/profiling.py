"""Tracing and timing helpers (counterpart of ``orp_tpu/utils/profiling.py``).

- ``trace(name)``: ``torch.profiler.record_function``, the counterpart of
  ``jax.profiler.TraceAnnotation``, so phases (simulate / fit / analytics)
  show up as named spans in a ``torch.profiler`` capture;
- ``timed(fn, *args)``: wall timing that synchronizes the CUDA device of
  every tensor in the result tree before it stops the clock, so the figure
  is the device's time, not the launch queue's.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def trace(name: str):
    with torch.profiler.record_function(name):
        yield


def timed(fn, *args, **kwargs):
    """Run ``fn`` and return ``(result, seconds)``, waiting until every CUDA
    device that holds a tensor of the result is done."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    devices = {leaf.device for leaf in pytree.tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
