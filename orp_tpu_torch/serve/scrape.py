"""Live scrape surfaces (counterpart of ``orp_tpu/serve/scrape.py``): the HTTP
metrics endpoint + exposition tooling.

The obs spine exported ``metrics.prom`` only at clean session exit; the
telemetry plane makes the LIVE process scrapeable through two fronts over
one renderer (``ServeGateway.metrics_text``):

- the **METRICS wire kind** (``serve/wire.py``) — in-band, for orp-ingest
  speakers: ``GatewayClient.metrics()``, ``orp top``, ``orp doctor
  --metrics``;
- :class:`MetricsServer` — a plain-HTTP sidecar (``orp serve-gateway
  --metrics-port``) any stock Prometheus scraper can poll: ``GET /metrics``
  answers the text exposition, ``GET /healthz`` the JSON health document.
  Stdlib ``ThreadingHTTPServer`` on a daemon thread: no dependency, no
  interference with the ingest plane's sockets.

The read side lives here too: :func:`parse_prometheus` (enough of the
text format 0.0.4 to round-trip what ``obs.sink.prometheus_text``
renders), :func:`top_snapshot` (one scrape digested into the numbers an
operator watches) and :func:`render_top` (the ``orp top`` table).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: one sample line: name{labels} value  (labels optional)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class MetricsServer:
    """Plain-HTTP Prometheus scrape sidecar.

    ``metrics_fn`` returns the exposition text; ``health_fn`` (optional)
    returns the JSON-able health document. ``port=0`` binds a free port —
    read it back from :attr:`address`. Serves until :meth:`close`.
    """

    def __init__(self, metrics_fn, *, health_fn=None,
                 addr: str = "127.0.0.1", port: int = 0):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — the stdlib handler contract
                if self.path.split("?")[0] == "/metrics":
                    body = outer.metrics_fn().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] in ("/healthz", "/health"):
                    doc = (outer.health_fn() if outer.health_fn is not None
                           else {"ok": True})
                    body = json.dumps(doc).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "serve /metrics or /healthz")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes are periodic; stderr noise helps nobody

        self.metrics_fn = metrics_fn
        self.health_fn = health_fn
        self._httpd = ThreadingHTTPServer((addr, int(port)), _Handler)
        self._httpd.timeout = 1.0
        self.address: tuple[str, int] = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="orp-metrics-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    """Single left-to-right scan — chained ``str.replace`` mis-decodes a
    literal backslash followed by ``n`` (``\\\\n`` on the wire) into a
    newline, corrupting label-matched lookups."""
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse a text exposition into ``{name: [(labels, value), ...]}``.

    Covers what this repo renders (counters/gauges/summaries; ``# TYPE``
    and comment lines skipped). Unparseable sample lines are skipped, not
    fatal — a probe validates presence of series, and one mangled line
    must not hide every other series from it."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def _series_sum(series: dict, name: str, **want) -> float:
    """Sum every sample of ``name`` whose labels contain ``want``."""
    total = 0.0
    for labels, value in series.get(name, ()):
        if all(labels.get(k) == v for k, v in want.items()):
            total += value
    return total


def _quantile(series: dict, name: str, q: str, **want) -> float | None:
    for labels, value in series.get(name, ()):
        if labels.get("quantile") == q and all(
                labels.get(k) == v for k, v in want.items()):
            return value
    return None


def top_snapshot(text: str, *, previous: dict | None = None,
                 interval_s: float | None = None,
                 health: dict | None = None) -> dict:
    """Digest one scrape into the ``orp top`` numbers. With ``previous``
    (the last snapshot) and ``interval_s``, lifetime counters become RATES
    (req/s, rows/s, shed/s, busy/s); a single scrape reports totals with
    the rates at None — counters cannot yield a rate without a baseline."""
    series = parse_prometheus(text)
    tenants: dict[str, dict] = {}
    for labels, value in series.get("serve_requests_total", ()):
        key = labels.get("tenant") or labels.get("phase") or ""
        t = tenants.setdefault(key, {})
        t["requests"] = t.get("requests", 0.0) + value
    for labels, value in series.get("serve_rows_total", ()):
        key = labels.get("tenant") or labels.get("phase") or ""
        tenants.setdefault(key, {})["rows"] = value
    # model-health drift (quality/drift_max{tenant} gauges set by the block
    # lane's per-tenant DriftMonitor): a tenant serving perfect p99 with a
    # drifted input distribution shows it HERE, not in the latency columns
    for labels, value in series.get("quality_drift_max", ()):
        key = labels.get("tenant") or ""
        tenants.setdefault(key, {})["drift"] = round(value, 3)
    for key, t in tenants.items():
        want = ({"tenant": key} if any(
            lb.get("tenant") == key
            for lb, _ in series.get("serve_request_latency_seconds", ()))
            else {"phase": key} if key else {})
        for q, field in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            v = _quantile(series, "serve_request_latency_seconds", q, **want)
            t[field] = None if v is None else round(v * 1e3, 4)
    snap = {
        "requests": _series_sum(series, "serve_requests_total"),
        "rows": _series_sum(series, "serve_rows_total"),
        # bucket-padding rows billed but never requested (the ragged
        # planner's target): first-class next to the served rows, so the
        # waste fraction is one division on the same screen
        "pad_waste": _series_sum(series, "serve_pad_waste_rows_total"),
        "gateway_rows": _series_sum(series, "serve_gateway_rows"),
        "shed": _series_sum(series, "guard_shed"),
        "busy": _series_sum(series, "serve_gateway_busy"),
        "errors": _series_sum(series, "serve_gateway_errors"),
        "queue_age_p99_ms": (lambda v: None if v is None else
                             round(v * 1e3, 4))(
            _quantile(series, "serve_queue_age_seconds", "0.99",
                      outcome="served")),
        # device-time attribution (obs/devprof, flag-gated): the rolling
        # busy-fraction gauge — None when the serving process runs without
        # the profiling mode, a 0..1 fraction when it does
        "device_util": next(
            (value for _, value in
             series.get("serve_device_utilization", ())), None),
        "tenants": tenants,
    }
    if health is not None:
        snap["draining"] = health.get("draining")
        snap["sessions"] = health.get("sessions")
        for name, info in (health.get("tenants") or {}).items():
            tenants.setdefault(name, {})["pending"] = info.get("pending")
            tenants.setdefault(name, {})["live"] = info.get("live")
    rates = {}
    if previous is not None and interval_s and interval_s > 0:
        for field in ("requests", "rows", "pad_waste", "gateway_rows",
                      "shed", "busy"):
            prev = previous.get(field)
            if prev is not None:
                rates[field + "_per_s"] = round(
                    max(0.0, snap[field] - prev) / interval_s, 2)
    snap["rates"] = rates
    return snap


def render_top(snap: dict, *, target: str = "") -> str:
    """The human ``orp top`` screen: headline rates + per-tenant table."""
    r = snap.get("rates", {})

    def rate(field):
        v = r.get(field + "_per_s")
        return "-" if v is None else f"{v:,.1f}/s"

    head = [f"orp top — {target}"
            + ("  [DRAINING]" if snap.get("draining") else "")]
    head.append(
        f"req {rate('requests')}  gw-rows {rate('gateway_rows')}  "
        f"pad-waste {rate('pad_waste')}  "
        f"shed {rate('shed')}  busy {rate('busy')}  "
        f"errors {snap['errors']:,.0f}  "
        f"queue-age p99 "
        + ("-" if snap["queue_age_p99_ms"] is None
           else f"{snap['queue_age_p99_ms']:.3f} ms")
        + ("" if snap.get("device_util") is None
           else f"  dev-util {snap['device_util'] * 100:.0f}%"))
    lines = head
    tenants = snap.get("tenants") or {}
    if tenants:
        lines.append(f"{'tenant':<16}{'requests':>12}{'rows':>12}"
                     f"{'pending':>9}{'p50 ms':>10}{'p99 ms':>10}"
                     f"{'drift':>8}")
        for name in sorted(tenants):
            t = tenants[name]

            def cell(v, fmt):
                return "-" if v is None else format(v, fmt)

            lines.append(
                f"{name or '(default)':<16}"
                f"{cell(t.get('requests'), ',.0f'):>12}"
                f"{cell(t.get('rows'), ',.0f'):>12}"
                f"{cell(t.get('pending'), ',.0f'):>9}"
                f"{cell(t.get('p50_ms'), '.3f'):>10}"
                f"{cell(t.get('p99_ms'), '.3f'):>10}"
                f"{cell(t.get('drift'), '.3f'):>8}")
    return "\n".join(lines)
