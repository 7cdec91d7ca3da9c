"""Trace reconstruction: one frame's span tree back out of ``events.jsonl`` (counterpart of ``orp_tpu/obs/tracetree.py``).

Trace-linked span events (``obs.emit_trace_span``) carry ``trace_id`` /
``span_id`` / ``parent_span``; this module filters a bundle's event log by
``trace_id``, rebuilds the parent / child tree and renders it. Spans whose
parent never logged locally (the producer's root span lives in another
process) are treated as roots. It reads either package's bundle.
"""

from __future__ import annotations

import json
import pathlib

from orp_tpu_torch.obs.sink import EVENTS_FILE
from orp_tpu_torch.obs.spans import parse_trace_id, trace_hex

#: the serving-chain segment order, for stable rendering of sibling spans
_SEGMENT_ORDER = {"trace/decode": 0, "trace/queue": 1, "trace/dispatch": 2,
                  "trace/resolve": 3, "trace/encode": 4}


def resolve_events_path(path) -> pathlib.Path:
    """Accept either an ``events.jsonl`` file or the telemetry DIR holding
    one — the two spellings ``--telemetry`` users actually have on hand."""
    p = pathlib.Path(path)
    if p.is_dir():
        p = p / EVENTS_FILE
    if not p.exists():
        raise FileNotFoundError(
            f"{p}: no events.jsonl — point at a --telemetry DIR (the "
            "gateway must run with --telemetry for trace spans to land)")
    return p


def spans_for_trace(events: list[dict], trace_id) -> list[dict]:
    """Every span event of ``trace_id`` (hex/int accepted), in emit order."""
    want = trace_hex(parse_trace_id(trace_id))
    return [e for e in events
            if e.get("type") == "span" and e.get("trace_id") == want]


def build_trace_tree(spans: list[dict]) -> list[dict]:
    """Nest spans by ``parent_span``: returns the root list, each node a
    copy of its event with a ``children`` list. Orphans (parent not in this
    log) root the tree — the one-process-slice reality."""
    by_id = {}
    for e in spans:
        node = dict(e)
        node["children"] = []
        by_id[e.get("span_id")] = node
    roots = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_span"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)

    def order(n):
        return (_SEGMENT_ORDER.get(n.get("name"), 99), n.get("seq", 0))

    for node in by_id.values():
        node["children"].sort(key=order)
    roots.sort(key=order)
    return roots


def trace_summary(spans: list[dict]) -> dict:
    """The numbers the acceptance pin checks: per-segment walls and their
    sum (which must fit inside the producer-measured round trip)."""
    segments = {}
    for e in spans:
        segments.setdefault(e["name"], 0.0)
        segments[e["name"]] += float(e.get("dur_s", 0.0))
    return {
        "spans": len(spans),
        "segments": {k: round(v, 9) for k, v in sorted(
            segments.items(), key=lambda kv: _SEGMENT_ORDER.get(kv[0], 99))},
        "sum_s": round(sum(segments.values()), 9),
    }


def format_trace_tree(trace_id, roots: list[dict], summary: dict) -> str:
    """Human rendering: one line per span, indentation = nesting."""
    want = trace_hex(parse_trace_id(trace_id))
    lines = [f"trace {want}: {summary['spans']} span(s), "
             f"segment sum {summary['sum_s'] * 1e3:.3f} ms"]

    def walk(node, depth):
        dur_ms = float(node.get("dur_s", 0.0)) * 1e3
        attrs = node.get("attrs") or {}
        extra = ("  " + " ".join(f"{k}={v}" for k, v in attrs.items())
                 if attrs else "")
        lines.append(f"{'  ' * depth}{node['name']:<18} {dur_ms:9.3f} ms  "
                     f"span={node.get('span_id')}{extra}")
        for child in node["children"]:
            walk(child, depth + 1)

    for root in roots:
        walk(root, 1)
    return "\n".join(lines)


def read_events_tolerant(path) -> list[dict]:
    """Parse an ``events.jsonl``, tolerating a torn FINAL line — a killed
    process is exactly when this viewer gets used, and the line it died
    mid-write must not void every line before it. Corruption anywhere
    else still raises (``obs.read_events`` stays strict for consumers
    that want the loud failure)."""
    lines = [ln for ln in pathlib.Path(path).read_text().splitlines() if ln]
    events = []
    for i, line in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # the kill landed mid-line; everything before stands
            raise
    return events


def load_trace(path, trace_id) -> tuple[list[dict], list[dict], dict]:
    """The ``orp trace`` workhorse: ``(spans, tree_roots, summary)`` for
    ``trace_id`` out of the bundle at ``path``."""
    events = read_events_tolerant(resolve_events_path(path))
    spans = spans_for_trace(events, trace_id)
    return spans, build_trace_tree(spans), trace_summary(spans)
