"""orp_tpu_torch.obs: the telemetry spine of the port (counterpart of ``orp_tpu/obs``).

The JAX package's bundle, schemas and names, in PyTorch's idiom, so either
package reads the other's files:

- ``registry``  - process-wide thread-safe counters / gauges / bounded
                  histograms with labels (``obs.REGISTRY`` the scratch
                  default);
- ``spans``     - nested device-complete span timers (a
                  ``utils/profiling.trace`` region, ``record_function``
                  while a profiler runs, + the wall waited on the result
                  tree's CUDA streams) with a zero-cost disabled mode, and
                  the trace-id primitives;
- ``sink``      - the schema-versioned JSONL event log (``orp-obs-v1``) and
                  the Prometheus text of the registry;
- ``manifest``  - run manifests (``orp-obs-manifest-v1``: the config
                  fingerprint, torch / CUDA versions, platform, git rev) and
                  the hash-linked chain (``orp-chain-v1``);
- ``flight``    - the per-process flight recorder ring, dumped as
                  ``orp-flight-v1`` JSONL;
- ``report``    - the read side of the walk's convergence record;
- ``tracetree`` - the read side of tracing: one frame's span tree;
- ``devprof``   - device-time attribution (the serial completion chain, the
                  queue / device split, ``serve/device_utilization``) and
                  the profile workloads (``profile_north_star``,
                  ``profile_serve``, ``profile_run``);
- ``perf``      - the ``orp-perf-v1`` ledger, the noise-aware gate and the
                  roofline against the H100's row (imported from its module).

Instrumented call sites: ``train/backward`` (``train/walk``, the host
loop's per-date ``train/fit`` / ``train/fit_quantile`` / ``train/outputs``,
the ``train/convergence`` record and ``train/gram_cond{date}`` gauges),
``guard/sentinel`` (``guard/nan_event``, ``guard/degrade``,
``guard/target_sanitized``), ``api/pipelines`` (the run manifest,
``pipeline/simulate`` and ``pipeline/report``) and ``serve/engine``
(``serve/pad`` / ``serve/dispatch`` / ``serve/unpad`` and the ``serve/*``
counters). They pay nothing until a session is active.

Not ported yet: the ``train/xla_compiles`` counter (with
``lint/trace_audit.py``; the port compiles no XLA programs) and the CLI's
``--telemetry DIR`` (with ``cli.py``).

The one-call entry point is the session::

    with obs.telemetry("runs/tonight"):
        european_hedge(...)           # the pipeline binds its fingerprint
                                      # and emits its spans
    # -> runs/tonight/{events.jsonl, metrics.prom, manifest.json,
    #                  flight.jsonl}

``events.jsonl`` streams live, ``metrics.prom`` is rewritten every
``flush_every_s`` seconds by a background flusher, and
``install_signal_flush`` chains a SIGTERM hook that flushes the bundle and
dumps the flight ring before the process dies.
"""

from __future__ import annotations

import contextlib
import pathlib
import threading

from orp_tpu_torch.obs import devprof, flight
from orp_tpu_torch.obs.flight import (FLIGHT_FILE, FLIGHT_SCHEMA, FlightRecorder, read_flight,
                                      validate_flight_event)
from orp_tpu_torch.obs.manifest import (CHAIN_FILE, CHAIN_SCHEMA, MANIFEST_SCHEMA,
                                        build_manifest, chain_append, chain_verify,
                                        config_fingerprint, read_chain, read_manifest,
                                        write_manifest)
from orp_tpu_torch.obs.registry import Counter, Gauge, Histogram, Registry
from orp_tpu_torch.obs.sink import (EVENTS_FILE, METRICS_FILE, SCHEMA, JsonlSink, ListSink,
                                    prometheus_text, read_events, validate_event,
                                    write_prometheus)
from orp_tpu_torch.obs.spans import (NOOP_SPAN, ObsState, Span, active, bind_manifest, count,
                                     disable, emit_record, emit_trace_span, emit_trace_spans,
                                     enable, enabled, new_span_id, new_trace, observe,
                                     parse_trace_id, set_gauge, span, spanned, state,
                                     suspended, timed, trace_hex)

#: a process-wide scratch registry for ad-hoc, session-independent
#: instruments. NOTE: ``telemetry()`` exports its OWN per-session registry
#: (fresh by default — bundles describe one run); to publish a façade's
#: series into the bundle, pass ``obs.state().registry`` (or hand
#: ``telemetry(registry=...)`` this one explicitly)
REGISTRY = Registry()


def flush_active() -> None:
    """Write the active session's exportable state NOW: ``metrics.prom``
    re-rendered from the registry, the sink's buffer pushed to disk, and
    the flight ring dumped next to them. No-op without an exporting session
    — safe to call from a signal handler, a periodic flusher, or a drain
    path at any time."""
    st = state()
    if st is None or st.export_dir is None:
        return
    d = pathlib.Path(st.export_dir)
    write_prometheus(d / METRICS_FILE, st.registry)
    if st.sink is not None and hasattr(st.sink, "flush"):
        st.sink.flush()
    flight.RECORDER.dump()


def install_signal_flush() -> bool:
    """Chain a SIGTERM hook that flushes the active bundle + flight ring
    before the process dies, then hands the signal to the previous handler
    (default: die, as a supervisor expects). Main-thread only (the signal
    module's rule); a handler installed after this one wins. SIGINT needs
    no hook: KeyboardInterrupt unwinds the ``telemetry()`` context manager,
    which writes the bundle. Returns True when installed."""
    import os
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False
    previous = signal.getsignal(signal.SIGTERM)

    def _flush_then_die(signum, frame):
        # the flush runs on a HELPER thread with a bounded join: the
        # handler interrupts the main thread wherever it was, possibly
        # mid-emit holding the sink/ring/instrument lock; flushing on this
        # thread would self-deadlock on that non-reentrant lock. A helper
        # that blocks on the held lock just times the join out, and the
        # process still dies (with whatever the periodic flusher and the
        # line-buffered event stream already persisted).
        flusher = threading.Thread(target=flush_active,
                                   name="orp-obs-sigterm-flush", daemon=True)
        flusher.start()
        flusher.join(timeout=5.0)
        if callable(previous):
            previous(signum, frame)
        else:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    signal.signal(signal.SIGTERM, _flush_then_die)
    return True


@contextlib.contextmanager
def telemetry(directory: str | pathlib.Path | None = None, *,
              registry: Registry | None = None,
              run_fingerprint: str | None = None,
              manifest_extra: dict | None = None,
              flush_every_s: float | None = 30.0):
    """One telemetry session: enable the spine, export a bundle at exit (the
    bundle is written, and the exception re-raised, when the body fails).

    With ``directory`` set, drops ``events.jsonl`` (streamed live),
    ``metrics.prom`` and ``manifest.json`` there, arms the flight recorder
    at the same directory (``flight.jsonl`` on any guard trip / signal
    flush / session exit), and runs a background flusher rewriting
    ``metrics.prom`` every ``flush_every_s`` seconds (None disables) — so a
    KILLED process still leaves its telemetry, not an empty dir. With
    ``directory=None`` events go to an in-memory ``ListSink``
    (introspection without files). The manifest's ``run_fingerprint`` can
    be passed here or bound from inside the session by the pipeline
    (``obs.bind_manifest``) — the pipeline's binding wins, since it knows
    the actual run config.
    """
    reg = registry if registry is not None else Registry()
    sink = (JsonlSink(pathlib.Path(directory) / EVENTS_FILE)
            if directory is not None else ListSink())
    st = enable(reg, sink)
    if run_fingerprint is not None:
        st.manifest_extra.setdefault("run_fingerprint", run_fingerprint)
    if manifest_extra:
        st.manifest_extra.update(manifest_extra)
    stop = None
    flusher = None
    if directory is not None:
        st.export_dir = pathlib.Path(directory)
        flight.RECORDER.arm(st.export_dir)
        if flush_every_s is not None and flush_every_s > 0:
            stop = threading.Event()

            def _flush_loop():
                while not stop.wait(flush_every_s):
                    flush_active()

            flusher = threading.Thread(target=_flush_loop,
                                       name="orp-obs-flusher", daemon=True)
            flusher.start()
    try:
        yield st
    finally:
        if stop is not None:
            stop.set()
            flusher.join(timeout=5.0)
        disable()
        if directory is not None:
            d = pathlib.Path(directory)
            extra = dict(st.manifest_extra)
            fp = extra.pop("run_fingerprint", None)
            write_prometheus(d / METRICS_FILE, reg)
            write_manifest(d, run_fingerprint=fp, extra=extra)
            flight.RECORDER.dump(d / FLIGHT_FILE)
            flight.RECORDER.disarm()
        sink.close()
