"""The traced run's instruments: ``torch.profiler`` over the first jobs of the
window, and a telemetry session of the program over the jobs after them.

:func:`summarize` reduces the profiler's events to what the per-layer readers
and the result line take: the seconds in which a kernel, copy or set ran on
the card (the union of their intervals), the traced wall, the kernels and
their time by name, and the longest idle gaps, each named by the innermost
host operation that was running across it. Only the event list is read; no
trace file is written.
"""

from __future__ import annotations

import collections

import torch


def start(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)


def telemetry_session():
    """The program's telemetry, in memory: its spans wait for their work on
    the card, so it is open only in the traced run, after the profiled jobs."""
    from orp_tpu_torch import obs

    ctx = obs.telemetry(None)
    state = ctx.__enter__()
    return ctx, state


def span_durations(session) -> dict[str, float]:
    """The spans the job just closed, by name (summed), then forgotten."""
    _, state = session
    events = state.sink.events
    out = collections.defaultdict(float)
    for ev in events:
        if ev.get("type") == "span" and "dur_s" in ev:
            out[ev["name"]] += float(ev["dur_s"])
    events.clear()
    return dict(out)


def close_session(session) -> None:
    ctx, _ = session
    ctx.__exit__(None, None, None)


def _intervals(events):
    """``(device intervals, host intervals)`` in seconds, from the profiler."""
    dev, host = [], []
    for e in events:
        start = e.time_range.start * 1e-6
        end = e.time_range.end * 1e-6
        if end <= start:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    return dev, host


def summarize(prof, wall_s: float) -> dict:
    """The trace's numbers (module docstring); ``wall_s`` is the traced wall."""
    dev, host = _intervals(prof.events())
    dev.sort()
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    kernels = 0
    for s, e, name in dev:
        by_name[name][0] += e - s
        by_name[name][1] += 1
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:10]
    named = []
    for length, g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = min((h for h in host if h[0] <= mid <= h[1]), key=lambda h: h[1] - h[0],
                    default=None)
        named.append([(inner[2] if inner else "host, no traced operation")[:200], length])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy, "window_s": wall_s, "kernels": kernels,
            "by_name": {k: (v[0], v[1]) for k, v in by_name.items()},
            "device_ops": [[k[:200], v[0]] for k, v in top], "idle_gaps": named}
