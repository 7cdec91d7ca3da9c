"""The port's telemetry spine (``orp_tpu_torch/obs``) held against the JAX package's ``orp_tpu.obs`` on the CPU.

- the package-agnostic contract tests of ``tests/test_obs.py``,
  ``tests/test_perf.py``, ``tests/test_quality.py`` (the chain) and
  ``tests/test_telemetry_plane.py`` (the flight ring, the periodic and
  signal flushes), each one test parametrised over both packages;
- byte-identical output: the same registry operations give the same
  Prometheus text and the same records the same chain lines; each package's
  readers (``read_events``, ``validate_event``, ``read_flight``,
  ``chain_verify``, ``load_convergence``, ``format_trace_tree``) accept the
  other's files and give equal results;
- the mini walk: the same 128-path, 4-date float64 GN walk (``mse_only`` and
  ``separate``, from the JAX package's initial params) under a session in
  both packages, after a telemetered ``european_hedge``: the same (span name,
  parent) multiset, the same counter, gauge and registry series less
  ``train/xla_compiles`` (the port compiles no XLA programs), the
  ``train/convergence`` record (losses at ``rtol=1e-7``, equal epochs,
  ``gram_cond`` at ``rtol=1e-5``) and the manifest's ``pipeline`` and
  ``run_fingerprint`` equal strings; the four ``*_hedge`` pipelines'
  fingerprints equal the JAX package's for the same configs;
- the guarded walk under ``FaultPlan(seed=3, nan_dates={1})``: the
  ``guard/*`` events and ``load_convergence``'s rungs equal the JAX
  package's;
- telemetry off: the walk (host loop and fused) and the engine leave a planted
  sink and ``REGISTRY`` untouched, and their results are bitwise a telemetered
  run's;
- the engine's spans and counters, and the devprof partition
  ``queue_s + device_s == t_done - t_dispatch``;
- a 2-rank ``gloo`` mesh with telemetry on rank 0 only
  (``tools/torch_mesh_ranks.py``): no hang, the manifest records the mesh,
  ``train/walk``'s ``n_paths`` is the global count.
"""

import collections
import importlib.util
import json
import pathlib
import threading
import time
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu import api as japi
from orp_tpu import guard as jguard
from orp_tpu import obs as jobs
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.obs import devprof as jdevprof
from orp_tpu.obs import flight as jflight
from orp_tpu.obs import report as jreport
from orp_tpu.obs import tracetree as jtracetree
from orp_tpu.train import backward as jbackward
from orp_tpu_torch import NORTH_STAR_POLICY
from orp_tpu_torch import api as tapi
from orp_tpu_torch import guard as tguard
from orp_tpu_torch import obs as tobs
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.obs import devprof as tdevprof
from orp_tpu_torch.obs import flight as tflight
from orp_tpu_torch.obs import report as treport
from orp_tpu_torch.obs import tracetree as ttracetree
from orp_tpu_torch.sde import TimeGrid, simulate_gbm_log
from orp_tpu_torch.serve import HedgeEngine, load_bundle
from orp_tpu_torch.train import backward as tbackward
from orp_tpu_torch.utils import profiling as tprofiling

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the two packages' obs planes: (obs, devprof, flight, report, tracetree, api)
PKGS = {"jax": (jobs, jdevprof, jflight, jreport, jtracetree, japi),
        "torch": (tobs, tdevprof, tflight, treport, ttracetree, tapi)}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


@pytest.fixture(autouse=True)
def _planes_off():
    """Both packages' sessions off and flight rings empty around every test."""
    for obs, devprof, flight, *_ in PKGS.values():
        obs.disable()
        devprof.disable()
        flight.RECORDER.reset()
        flight.RECORDER.disarm()
    yield
    for obs, devprof, flight, *_ in PKGS.values():
        obs.disable()
        devprof.disable()
        flight.RECORDER.reset()
        flight.RECORDER.disarm()


# -- the contract tests, both packages -------------------------------------------


@BOTH
def test_registry_interning_and_labels(pkg):
    reg = PKGS[pkg][0].Registry()
    c1 = reg.counter("requests", {"phase": "engine"})
    c2 = reg.counter("requests", {"phase": "engine"})
    c3 = reg.counter("requests", {"phase": "batcher"})
    assert c1 is c2 and c1 is not c3
    c1.inc(3)
    assert c2.value == 3 and c3.value == 0
    g = reg.gauge("requests", {"phase": "engine"})
    g.set(7.5)
    assert c1.value == 3 and g.value == 7.5
    with pytest.raises(ValueError, match="inc"):
        c1.inc(-1)


@BOTH
def test_registry_counter_concurrency(pkg):
    c = PKGS[pkg][0].Registry().counter("hammered")
    n = 20_000

    def work():
        for _ in range(n):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 2 * n


@BOTH
def test_histogram_window_bounds_and_lifetime(pkg):
    reg = PKGS[pkg][0].Registry()
    h = reg.histogram("lat", window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        h.observe(v)
    assert h.count == 6 and h.sum == pytest.approx(21.0)
    assert list(h.snapshot()) == [3.0, 4.0, 5.0, 6.0]
    with pytest.raises(ValueError, match="window"):
        reg.histogram("lat", window=8)
    assert h.percentiles((50,)) == [4.5] and h.fraction_over(4.5) == 0.5
    h.reset()
    assert h.count == 0 and h.snapshot().size == 0 and h.percentiles((50,)) == [0.0]


@BOTH
def test_jsonl_sink_schema_pin(pkg, tmp_path):
    obs = PKGS[pkg][0]
    path = tmp_path / "events.jsonl"
    with obs.JsonlSink(path) as sink:
        sink.emit({"type": "span", "name": "a", "dur_s": 0.5, "parent": None, "ok": True})
        sink.emit({"type": "counter", "name": "c", "inc": 2, "labels": {}})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["seq"] for x in lines] == [0, 1]
    for line in lines:
        assert line["schema"] == "orp-obs-v1"
        assert obs.validate_event(line) == []
    assert obs.validate_event({"type": "span"})
    assert obs.validate_event({**lines[0], "type": "mystery"})
    assert obs.validate_event({**lines[1], "schema": "orp-obs-v0"})
    with obs.JsonlSink(path) as sink:  # reopening truncates: one session a file
        sink.emit({"type": "gauge", "name": "g", "value": 1.0, "labels": {}})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["seq"] for x in lines] == [0] and lines[0]["type"] == "gauge"


@BOTH
def test_jsonl_sink_emit_many_matches_emit_contract(pkg, tmp_path):
    obs = PKGS[pkg][0]
    path = tmp_path / "events.jsonl"
    with obs.JsonlSink(path) as sink:
        sink.emit({"type": "counter", "name": "a", "inc": 1, "labels": {}})
        sink.emit_many([{"type": "span", "name": f"s{i}", "dur_s": 0.1, "parent": None,
                         "ok": True} for i in (1, 2)])
        assert sink.emitted == 3
    lines = obs.read_events(path)
    assert [x["seq"] for x in lines] == [0, 1, 2]
    assert all(obs.validate_event(x) == [] for x in lines)


def _prom_ops(obs):
    """The reference's exposition pin, as registry operations."""
    reg = obs.Registry()
    reg.counter("serve_rows_total", {"phase": "engine"}).inc(5)
    reg.gauge("depth").set(2.0)
    h = reg.histogram("span_seconds", {"name": "serve/pad"})
    for v in (0.001, 0.002, 0.003):
        h.observe(v)
    reg.counter("weird", {"cfg": 'a"b\\c\nd'}).inc()
    reg.counter("depth").inc(2)
    reg.histogram("depth", {"k": "h"}).observe(1.0)
    reg.gauge("train/gram_cond", {"date": "3"}).set(1234.5)
    return reg


@BOTH
def test_prometheus_exposition_pin(pkg):
    obs = PKGS[pkg][0]
    text = obs.prometheus_text(_prom_ops(obs))
    assert '# TYPE serve_rows_total counter' in text
    assert 'serve_rows_total{phase="engine"} 5' in text
    assert '# TYPE span_seconds summary' in text
    assert 'span_seconds{name="serve/pad",quantile="0.5"} 0.002' in text
    assert 'span_seconds_count{name="serve/pad"} 3' in text
    assert 'weird{cfg="a\\"b\\\\c\\nd"} 1' in text
    assert "# TYPE depth counter" in text and "# TYPE depth gauge" in text
    assert "# TYPE depth summary" in text and 'depth_count{k="h"} 1' in text
    assert 'train_gram_cond{date="3"} 1234.5' in text and text.endswith("\n")
    assert obs.prometheus_text(obs.Registry()) == ""


@BOTH
def test_manifest_fingerprint_roundtrip(pkg, tmp_path):
    obs, api = PKGS[pkg][0], PKGS[pkg][5]
    cfgs = (api.EuropeanConfig(), api.SimConfig(n_paths=64, T=0.5, dt=0.25),
            api.TrainConfig(dual_mode="mse_only"))
    fp = obs.config_fingerprint(*cfgs)
    obs.write_manifest(tmp_path, run_fingerprint=fp, extra={"pipeline": "euro"})
    man = obs.read_manifest(tmp_path)
    assert man["schema"] == "orp-obs-manifest-v1" and man["pipeline"] == "euro"
    assert man["run_fingerprint"] == obs.config_fingerprint(
        api.EuropeanConfig(), api.SimConfig(n_paths=64, T=0.5, dt=0.25),
        api.TrainConfig(dual_mode="mse_only"))
    assert man["run_fingerprint"] != obs.config_fingerprint(
        api.EuropeanConfig(strike=110.0), *cfgs[1:])
    assert man["platform"] == "cpu" and "git" in man
    if pkg == "jax":
        assert man["jax_version"] and man["device_count"] >= 1
    else:
        assert man["torch_version"] == torch.__version__
        assert man["cuda_version"] == torch.version.cuda
        assert man["device_count"] == torch.cuda.device_count()
        assert not any(k.startswith("jax") for k in man)


class _Exploding:
    """A registry whose every instrument lookup raises."""

    def _intern(self, *a, **k):
        raise AssertionError("disabled-path code touched the registry")


@BOTH
def test_disabled_span_is_shared_noop_and_touches_nothing(pkg):
    obs = PKGS[pkg][0]
    s1, s2 = obs.span("a"), obs.span("b", attrs={"x": 1})
    assert s1 is s2 is obs.NOOP_SPAN
    with s1 as sp:
        assert sp.set_result(123) == 123
        sp.annotate(ignored=True)
    fn = lambda x: x + 1  # noqa: E731
    assert obs.spanned("a", fn) is fn
    obs.count("x", 5, phase="hot")
    obs.set_gauge("y", 1.0)
    obs.observe("z", 1.0)
    obs.bind_manifest(run_fingerprint="z")
    obs.emit_record("r", {"a": 1})
    exploding = type("Reg", (_Exploding, obs.Registry), {})()
    with obs.active(registry=exploding):
        with pytest.raises(AssertionError, match="touched the registry"):
            obs.count("x")


@BOTH
def test_span_stack_survives_exceptions(pkg):
    obs = PKGS[pkg][0]
    sink = obs.ListSink()
    with obs.active(sink=sink):
        with pytest.raises(RuntimeError, match="boom"):
            with obs.span("outer"):
                with obs.span("inner"):
                    raise RuntimeError("boom")
        with obs.span("after"):
            pass
    by_name = {e["name"]: e for e in sink.events if e["type"] == "span"}
    assert by_name["inner"]["ok"] is False and by_name["inner"]["parent"] == "outer"
    assert by_name["outer"]["ok"] is False
    assert by_name["after"]["parent"] is None


@BOTH
def test_trace_ids_are_hex_strings_and_roundtrip(pkg):
    obs = PKGS[pkg][0]
    tid, sid = obs.new_trace()
    assert 1 <= tid < (1 << 64) and sid
    h = obs.trace_hex(tid)
    assert len(h) == 16 and int(h, 16) == tid
    assert obs.parse_trace_id(h) == obs.parse_trace_id(f"0x{h}") == obs.parse_trace_id(tid) == tid
    assert obs.new_span_id() != obs.new_span_id()


@BOTH
def test_emit_trace_spans_one_burst_one_stamp(pkg):
    obs = PKGS[pkg][0]
    sink = obs.ListSink()
    with obs.active(sink=sink):
        tid, sid = obs.new_trace()
        obs.emit_trace_spans(tid, sid, (("trace/queue", 0.001), ("trace/dispatch", 0.002),
                                        ("trace/resolve", 0.003)))
    assert len(sink.events) == 3 and len({e["ts_unix"] for e in sink.events}) == 1
    assert [e["seq"] for e in sink.events] == [0, 1, 2]
    for e in sink.events:
        assert obs.validate_event(e) == [] and e["trace_id"] == obs.trace_hex(tid)
        assert e["parent_span"] == obs.trace_hex(sid)
    obs.disable()
    obs.emit_trace_spans(1, 2, (("trace/queue", 0.001),))
    assert obs.emit_trace_span("trace/decode", 1, 2, 0.001) is None


@BOTH
def test_suspended_detaches_and_restores_session(pkg):
    obs = PKGS[pkg][0]
    sink = obs.ListSink()
    with obs.active(sink=sink) as st:
        with obs.suspended():
            assert not obs.enabled()
            obs.count("x")
        assert obs.state() is st
        obs.count("y", sink_event=False)
        assert st.registry.counter("y").value == 1
    assert not obs.enabled() and sink.events == []


@BOTH
def test_device_split_partitions_the_dispatch_wall(pkg):
    """``queue_s + device_s == t_done - t_dispatch`` (``tests/test_perf.py``),
    a dispatch stamped while the device is busy waiting as queue time."""
    devprof = PKGS[pkg][1]
    with devprof.profiling() as prof:
        t_d1 = time.perf_counter()
        time.sleep(0.01)
        q1, d1 = prof.complete(t_d1, time.perf_counter(), bucket=64)
        assert q1 == 0.0 and d1 >= 0.01 - 1e-6
        t_d2 = t_d1 + 0.001
        time.sleep(0.005)
        t_b2 = time.perf_counter()
        q2, d2 = prof.complete(t_d2, t_b2, bucket=64)
        assert q2 > 0.005
        assert q2 + d2 == pytest.approx(prof._last_complete - t_d2, abs=1e-9)
        assert prof.bucket_stats()["64"]["count"] == 2 and prof.utilization() > 0.0
    assert devprof.active() is None


@BOTH
def test_span_split_sums_to_the_span_wall(pkg):
    obs, devprof = PKGS[pkg][:2]
    result = jnp.arange(8) * 2 if pkg == "jax" else torch.arange(8) * 2
    sink = obs.ListSink()
    with obs.active(sink=sink) as st:
        with devprof.profiling():
            with obs.span("perf/probe") as sp:
                sp.set_result(result)
        with obs.span("perf/off") as sp:
            sp.set_result(None)
    probe, off = sink.events
    assert abs(probe["host_s"] + probe["device_s"] - probe["dur_s"]) < 1e-6
    assert "host_s" not in off and "device_s" not in off
    assert st.registry.histogram("span_device_seconds", {"name": "perf/probe"}).count == 1


@BOTH
def test_chain_append_verify_and_tamper(pkg, tmp_path):
    obs = PKGS[pkg][0]
    p = tmp_path / "chain.jsonl"
    assert obs.chain_verify(p) == {"ok": True, "length": 0, "problems": []}
    for rec in ({"tenant": "a", "action": "promote", "version": 2},
                {"tenant": "a", "action": "reject", "stage": "bits"},
                {"tenant": "b", "action": "promote", "version": 2}):
        obs.chain_append(p, rec)
    assert obs.chain_verify(p)["ok"] is True
    recs = obs.read_chain(p)
    assert [r["seq"] for r in recs] == [0, 1, 2] and recs[0]["prev"] == "genesis"
    lines = p.read_text().splitlines()
    p.write_text("\n".join([lines[0], lines[1].replace('"reject"', '"promote"'), lines[2]])
                 + "\n")
    assert any("link broken" in x for x in obs.chain_verify(p)["problems"])
    p.write_text("\n".join([lines[0], lines[2]]) + "\n")
    assert obs.chain_verify(p)["ok"] is False
    # a torn tail: the next append neither raises nor concatenates onto it
    p.write_text(lines[0] + "\n" + '{"schema": "orp-chain-v1", "seq": 1, "tor')
    assert obs.chain_append(p, {"tenant": "a", "action": "reject"})["seq"] == 2
    assert json.loads(p.read_text().splitlines()[-1])["action"] == "reject"
    assert obs.chain_verify(p) == {**obs.chain_verify(p), "ok": False, "length": 3}


@BOTH
def test_flight_ring_bounded_and_dump_schema(pkg, tmp_path):
    flight = PKGS[pkg][2]
    rec = flight.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("shed", reason="deadline", i=i)
    snap = rec.snapshot()
    assert len(snap) == 4 and snap[0]["i"] == 6 and rec.recorded == 10
    lines = flight.read_flight(rec.dump(tmp_path / "flight.jsonl"))
    assert lines[0]["kind"] == "flight_dump"
    assert lines[0]["retained"] == 4 and lines[0]["recorded"] == 10
    assert all(flight.validate_flight_event(e) == [] for e in lines)
    assert flight.validate_flight_event({"kind": "x"})
    assert flight.validate_flight_event({**lines[1], "schema": "orp-flight-v0"})
    assert rec.dump() is None


@BOTH
def test_flight_trip_autodumps_when_armed(pkg, tmp_path):
    flight = PKGS[pkg][2]
    flight.RECORDER.arm(tmp_path)
    flight.record("shed", reason="deadline")
    assert not (tmp_path / "flight.jsonl").exists()
    flight.record("watchdog_trip", tag="bucket:64")
    assert [e["kind"] for e in flight.read_flight(tmp_path / "flight.jsonl")] == [
        "flight_dump", "shed", "watchdog_trip"]


@BOTH
def test_periodic_flush_writes_bundle_mid_session(pkg, tmp_path):
    obs, _, flight = PKGS[pkg][:3]
    with obs.telemetry(tmp_path, flush_every_s=0.05):
        obs.count("serve/gateway_rows", 7)
        flight.record("shed", reason="quota")
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if (tmp_path / "metrics.prom").exists() and (tmp_path / "flight.jsonl").exists():
                break
            time.sleep(0.02)
        assert "serve_gateway_rows 7" in (tmp_path / "metrics.prom").read_text()
        assert flight.read_flight(tmp_path / "flight.jsonl")


@BOTH
def test_flush_active_and_signal_hook(pkg, tmp_path):
    import signal

    obs, _, flight = PKGS[pkg][:3]
    with obs.telemetry(tmp_path, flush_every_s=None):
        obs.count("serve/gateway_rows", 3)
        flight.record("shed", reason="quota")
        assert not (tmp_path / "metrics.prom").exists()
        obs.flush_active()
        assert "serve_gateway_rows 3" in (tmp_path / "metrics.prom").read_text()
        assert (tmp_path / "flight.jsonl").exists()
    obs.flush_active()  # no session: a no-op
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert obs.install_signal_flush() is True
        assert signal.getsignal(signal.SIGTERM) is not previous
    finally:
        signal.signal(signal.SIGTERM, previous)


@BOTH
def test_telemetry_bundle_written_and_error_reraised(pkg, tmp_path):
    """The session's bundle holds the four files, and a failing body still
    writes it and re-raises (no session swallows an error)."""
    obs, _, flight = PKGS[pkg][:3]
    with pytest.raises(RuntimeError, match="device lost"):
        with obs.telemetry(tmp_path, run_fingerprint="fp", flush_every_s=None):
            flight.record("shed", reason="deadline")
            with obs.span("doomed"):
                raise RuntimeError("device lost")
    for name in ("events.jsonl", "metrics.prom", "manifest.json", "flight.jsonl"):
        assert (tmp_path / name).exists(), name
    assert obs.read_manifest(tmp_path)["run_fingerprint"] == "fp"
    assert obs.read_events(tmp_path / "events.jsonl")[0]["ok"] is False
    assert not obs.enabled() and flight.RECORDER.armed is None


# -- the port's own: the device-complete wait ------------------------------------


def test_span_wait_covers_every_tree_and_refuses_under_capture(monkeypatch):
    """``set_result`` takes tensors, dicts, tuples, dataclasses, numpy arrays and
    scalars; a CPU tree waits for nothing; a wait under a CUDA-graph capture
    raises naming the span instead of skipping the wait."""
    res = tbackward.BackwardResult(values=torch.zeros(2), phi=None, psi=None, var_residuals=None,
                                   train_loss=np.zeros(1), train_mae=np.zeros(1),
                                   train_mape=np.zeros(1), epochs_ran=np.zeros(1))
    tree = {"a": (torch.ones(1), [np.ones(2), 3.0]), "b": res}
    assert tprofiling._cuda_devices(tree, set()) == set()
    synced = []
    monkeypatch.setattr(tprofiling, "_cuda_devices", lambda t, out: {torch.device("cuda", 0)})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"synchronize": lambda s: synced.append(dev)})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with tobs.active(sink=tobs.ListSink()):
        with tobs.span("train/fit") as sp:
            sp.set_result(tree)
    assert synced == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    sink = tobs.ListSink()
    with tobs.active(sink=sink):
        with pytest.raises(RuntimeError, match="'train/fit'.*CUDA-graph capture"):
            with tobs.span("train/fit") as sp:
                sp.set_result(tree)
    assert sink.events[0]["ok"] is False and len(synced) == 1


def test_spans_are_profiler_regions_only_while_a_profiler_runs():
    """A span (and the engine's off-path region) opens a ``record_function``
    region inside a ``torch.profiler`` capture, named as the span, and no
    region outside one (a region costs host time even with no profiler)."""
    import contextlib

    from orp_tpu_torch.serve.engine import span as serve_span
    from orp_tpu_torch.utils.profiling import trace

    assert isinstance(trace("serve/pad"), contextlib.nullcontext)
    assert isinstance(serve_span("serve/pad"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.active(sink=tobs.ListSink()):
            with tobs.span("train/walk") as sp:
                sp.set_result(torch.ones(8) * 2.0)
        with serve_span("serve/unpad"):
            torch.ones(8) * 3.0
    assert {"train/walk", "serve/unpad"} <= {e.key for e in prof.key_averages()}


# -- byte-identical output, and each package reads the other's files ---------------


def test_prometheus_text_and_chain_lines_are_byte_identical(tmp_path, monkeypatch):
    assert jobs.prometheus_text(_prom_ops(jobs)) == tobs.prometheus_text(_prom_ops(tobs))
    from orp_tpu.obs import manifest as jmanifest
    from orp_tpu_torch.obs import manifest as tmanifest

    for mod in (jmanifest, tmanifest):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
    recs = [{"tenant": "a", "action": "promote", "version": 2},
            {"tenant": "a", "action": "reject", "stage": "bits", "why": 'q"\n'},
            {"seq": 99, "prev": "forged", "nested": {"b": [1, 2.5, None]}}]
    for obs, name in ((jobs, "jax.jsonl"), (tobs, "torch.jsonl")):
        for rec in recs:
            obs.chain_append(tmp_path / name, rec)
    assert (tmp_path / "jax.jsonl").read_bytes() == (tmp_path / "torch.jsonl").read_bytes()


def _write_bundle(obs, flight, directory):
    """One of each event kind, a trace, a convergence record with a demotion,
    a flight dump and a chain line, through ``obs``'s own writers."""
    with obs.telemetry(directory, run_fingerprint="fp", flush_every_s=None):
        with obs.span("train/walk", attrs={"n_paths": 8}):
            with obs.span("train/fit") as sp:
                sp.set_result(None)
        obs.count("guard/nan_event", date="1", trainer="adam", where="post-fit date state")
        obs.count("guard/degrade", date="1", to="gauss_newton")
        obs.set_gauge("train/gram_cond", 12.5, date="0")
        obs.emit_record("train/convergence", {
            "optimizer": "adam", "dual_mode": "mse_only", "fused": False, "nan_guard": True,
            "n_dates": 2, "train_loss": [0.5, 0.25], "train_mae": [0.1, 0.2],
            "train_mape": [1.0, 2.0], "epochs_ran": [3, 4], "gram_cond": [12.5, 3.0]})
        tid, sid = 0x1234ABCD, 0x77
        obs.emit_trace_spans(tid, sid, (("trace/decode", 0.001), ("trace/queue", 0.002)))
        flight.record("shed", reason="deadline")
    obs.chain_append(directory / "promotions.jsonl", {"tenant": "a", "action": "promote"})
    return tid


def test_each_package_reads_the_others_bundle(tmp_path):
    for (wobs, _, wflight, *_), (robs, _, rflight, rreport, rtree, _) in (
            (PKGS["jax"], PKGS["torch"]), (PKGS["torch"], PKGS["jax"])):
        d = tmp_path / f"{wobs.__name__}"
        tid = _write_bundle(wobs, wflight, d)
        own = wobs.read_events(d / "events.jsonl")
        other = robs.read_events(d / "events.jsonl")
        assert own == other and all(robs.validate_event(e) == [] for e in other)
        assert [e["kind"] for e in rflight.read_flight(d / "flight.jsonl")] == [
            "flight_dump", "shed"]
        assert all(rflight.validate_flight_event(e) == []
                   for e in rflight.read_flight(d / "flight.jsonl"))
        assert robs.chain_verify(d / "promotions.jsonl") == wobs.chain_verify(
            d / "promotions.jsonl") == {"ok": True, "length": 1, "problems": []}
        conv = rreport.load_convergence(d)
        assert conv == PKGS["jax"][3].load_convergence(d)
        assert conv["rungs"] == ["adam", "gauss_newton"] and conv["nan_events"] == {"1": 1}
        assert rreport.format_report(conv) == PKGS["jax"][3].format_report(conv)
        spans, roots, summary = rtree.load_trace(d, f"{tid:016x}")
        assert len(spans) == 2 and summary["sum_s"] == 0.003
        assert rtree.format_trace_tree(tid, roots, summary) == PKGS["jax"][4].format_trace_tree(
            tid, *PKGS["jax"][4].load_trace(d, tid)[1:])
        assert robs.read_manifest(d)["run_fingerprint"] == "fp"


# -- the mini walk, both packages --------------------------------------------------


def _jax_init(dtype, n: int = 2) -> tuple:
    """The JAX walk's cold-start params, ``params1`` and ``params2``."""
    ks = jax.random.split(jax.random.key(1234), 3)
    m = JHedgeMLP(n_features=1, dtype=dtype)
    return tuple({k: np.asarray(v) for k, v in m.init(ks[i], bias_init=(0.1, 0.0)).items()}
                 for i in range(n))


def _gbm_inputs(n_paths: int):
    """GBM paths in float64 (the port's Sobol sim, 8 steps stored every 2: 4
    dates): features S/S0, prices S/S0 and B/S0, the call payoff / S0."""
    s = simulate_gbm_log(torch.arange(n_paths), TimeGrid(1.0, 8), 1.0, 0.08, 0.2, 7,
                         store_every=2, dtype=torch.float64).numpy()
    b = np.exp(0.08 * np.linspace(0.0, 1.0, 5))
    return s[:, :, None], s, b, np.maximum(s[:, -1] - 1.0, 0.0)


MINI_SIM = dict(n_paths=128, T=1.0, dt=1 / 8, rebalance_every=2)
MINI_GN = dict(optimizer="gauss_newton", gn_iters_first=6, gn_iters_warm=3)


def _sinks(events):
    """The walk-comparable parts of a bundle's events."""
    spans = collections.Counter((e["name"], e["parent"]) for e in events if e["type"] == "span")
    series = sorted((e["type"], e["name"], json.dumps(e.get("labels"), sort_keys=True))
                    for e in events if e["type"] in ("counter", "gauge")
                    and e["name"] != "train/xla_compiles")
    return spans, series


def _run_mini(pkg: str, mode: str, directory):
    obs, _, _, report, _, api = PKGS[pkg]
    train = dict(MINI_GN, dual_mode=mode)
    feats, s, b, term = _gbm_inputs(128)
    with obs.telemetry(directory, flush_every_s=None) as st:
        kw = {} if pkg == "jax" else {"device": "cpu"}
        api.european_hedge(api.EuropeanConfig(constrain_self_financing=False),
                           api.SimConfig(**MINI_SIM), api.TrainConfig(**train),
                           warm_start=_jax_init(jnp.float32, 1) + (None,), **kw)
        if pkg == "jax":
            res = jbackward.backward_induction(
                JHedgeMLP(n_features=1, dtype=jnp.float64),
                *(jnp.asarray(a) for a in (feats, s, b, term)),
                jbackward.BackwardConfig(**train), initial_params=_jax_init(jnp.float64))
        else:
            res = tbackward.backward_induction(
                HedgeMLP(n_features=1, dtype=torch.float64),
                *(torch.tensor(a) for a in (feats, s, b, term)),
                tbackward.BackwardConfig(**train), initial_params=_jax_init(jnp.float64))
    keys = {k for k in st.registry.collect() if not k.startswith("train/xla_compiles")}
    return res, keys, obs.read_events(directory / "events.jsonl"), report.load_convergence(
        directory)


@pytest.mark.parametrize("mode", ["mse_only", "separate"])
def test_mini_walk_telemetry_matches_jax(mode, tmp_path):
    _, jkeys, jev, jconv = _run_mini("jax", mode, tmp_path / "jax")
    _, tkeys, tev, tconv = _run_mini("torch", mode, tmp_path / "torch")
    jspans, jseries = _sinks(jev)
    tspans_, tseries = _sinks(tev)
    assert tspans_ == jspans
    n_fits = 4 * (2 if mode == "separate" else 1)
    assert tspans_[("train/fit", "train/walk")] == 2 * 4  # two walks of 4 dates
    assert sum(v for (n, p), v in tspans_.items() if n.startswith("train/fit")) == 2 * n_fits
    assert tspans_[("train/walk", None)] == 2 and tspans_[("pipeline/report", None)] == 1
    assert tseries == jseries and tkeys == jkeys
    assert ("gauge", "train/gram_cond", '{"date": "3"}') in tseries
    # the last walk's record: the float64 walk
    for k in ("optimizer", "dual_mode", "fused", "nan_guard", "n_dates", "rungs", "nan_events"):
        assert tconv[k] == jconv[k], k
    for k in ("train_loss", "train_mae", "train_mape"):
        np.testing.assert_allclose(tconv[k], jconv[k], rtol=1e-7, err_msg=k)
    assert tconv["epochs_ran"] == jconv["epochs_ran"]
    np.testing.assert_allclose(tconv["gram_cond"], jconv["gram_cond"], rtol=1e-5)
    walk = [e for e in tev if e["type"] == "span" and e["name"] == "train/walk"][-1]
    assert walk["attrs"] == [e for e in jev if e["type"] == "span"
                             and e["name"] == "train/walk"][-1]["attrs"]
    jman, tman = jobs.read_manifest(tmp_path / "jax"), tobs.read_manifest(tmp_path / "torch")
    assert tman["pipeline"] == jman["pipeline"] == "european_hedge"
    assert tman["run_fingerprint"] == jman["run_fingerprint"]
    assert "mesh" not in tman and tman["platform"] == "cpu"
    # each package reads the other's walk bundle alike
    assert treport.load_convergence(tmp_path / "jax") == jconv
    assert jreport.load_convergence(tmp_path / "torch") == tconv


def _pipelines():
    """``(name, port call, JAX fingerprint configs)`` for the other three ``*_hedge``."""
    sim = dict(n_paths=64, T=1.0, dt=0.25, rebalance_every=1)
    gn = dict(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=2,
              gn_iters_warm=1)
    return [
        ("heston_hedge",
         lambda: tapi.heston_hedge(None, tapi.SimConfig(**sim), tapi.TrainConfig(**gn),
                                   device="cpu"),
         (japi.HestonConfig(), japi.SimConfig(**sim), japi.TrainConfig(**gn),
          "quantile_method=sort")),
        ("basket_hedge",
         lambda: tapi.basket_hedge(sim=tapi.SimConfig(**sim), train=tapi.TrainConfig(**gn),
                                   instruments="assets", device="cpu"),
         (japi.BasketConfig(), japi.SimConfig(**sim), japi.TrainConfig(**gn),
          "instruments=assets", "quantile_method=sort")),
        ("pension_hedge",
         lambda: tapi.pension_hedge(tapi.HedgeRunConfig(
             sim=tapi.SimConfig(**dict(sim, T=2.0, dt=0.5), binomial_mode="normal"),
             train=tapi.TrainConfig(**dict(gn, dual_mode="separate"))), device="cpu"),
         (japi.HedgeRunConfig(
             sim=japi.SimConfig(**dict(sim, T=2.0, dt=0.5), binomial_mode="normal"),
             train=japi.TrainConfig(**dict(gn, dual_mode="separate"))),
          "quantile_method=sort")),
    ]


@pytest.mark.parametrize("name, run, jcfgs", _pipelines(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_pipelines_bind_the_jax_fingerprint_and_span(name, run, jcfgs, tmp_path):
    with tobs.telemetry(tmp_path, flush_every_s=None):
        run()
    man = tobs.read_manifest(tmp_path)
    assert man["pipeline"] == name
    assert man["run_fingerprint"] == jobs.config_fingerprint(*jcfgs)
    spans = [(e["name"], e["parent"]) for e in tobs.read_events(tmp_path / "events.jsonl")
             if e["type"] == "span"]
    assert spans[0] == ("pipeline/simulate", None) and spans[-1] == ("pipeline/report", None)
    assert spans.count(("train/walk", None)) == 1


# -- the guarded walk ------------------------------------------------------------------


@pytest.mark.parametrize("train, rung", [
    (MINI_GN, "final_solve"),
    (dict(optimizer="adam", epochs_first=4, epochs_warm=2, batch_size=128, shuffle=False),
     "gauss_newton"),
], ids=["gauss_newton", "adam"])
def test_guarded_walk_guard_events_match_jax(train, rung, tmp_path):
    """The poisoned date's ``guard/*`` events, rungs and spans, the degraded
    retry's spanned fits included (the Adam walk lands on the GN rung)."""
    feats, s, b, term = _gbm_inputs(256)
    train = dict(train, dual_mode="separate", nan_guard=True)
    plan = dict(seed=3, nan_dates=frozenset({1}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jobs.telemetry(tmp_path / "jax", flush_every_s=None), \
                jguard.faults(jguard.FaultPlan(**plan)):
            jbackward.backward_induction(
                JHedgeMLP(n_features=1, dtype=jnp.float64),
                *(jnp.asarray(a) for a in (feats, s, b, term)),
                jbackward.BackwardConfig(**train), initial_params=_jax_init(jnp.float64))
        with tobs.telemetry(tmp_path / "torch", flush_every_s=None), \
                tguard.faults(tguard.FaultPlan(**plan)):
            tbackward.backward_induction(
                HedgeMLP(n_features=1, dtype=torch.float64),
                *(torch.tensor(a) for a in (feats, s, b, term)),
                tbackward.BackwardConfig(**train), initial_params=_jax_init(jnp.float64))

    def guard_events(d):
        return [(e["name"], e["labels"], e["inc"]) for e in jobs.read_events(d / "events.jsonl")
                if e["type"] == "counter" and e["name"].startswith("guard/")]

    want = guard_events(tmp_path / "jax")
    assert guard_events(tmp_path / "torch") == want
    assert {n for n, _, _ in want} == {"guard/nan_event", "guard/degrade",
                                       "guard/target_sanitized"}
    jconv = jreport.load_convergence(tmp_path / "jax")
    tconv = treport.load_convergence(tmp_path / "torch")
    assert tconv["rungs"] == jconv["rungs"] and tconv["nan_events"] == jconv["nan_events"]
    assert tconv["rungs"][2] == rung and tconv["nan_guard"] is True
    spans, _ = _sinks(tobs.read_events(tmp_path / "torch" / "events.jsonl"))
    assert spans == _sinks(jobs.read_events(tmp_path / "jax" / "events.jsonl"))[0]


# -- telemetry off: nothing recorded, bitwise ---------------------------------------


def _walk_and_engine(fused: bool):
    feats, s, b, term = _gbm_inputs(128)
    res = tbackward.backward_induction(
        HedgeMLP(n_features=1, dtype=torch.float64), *(torch.tensor(a) for a in (feats, s, b,
                                                                                  term)),
        tbackward.BackwardConfig(**MINI_GN, dual_mode="separate", fused=fused),
        initial_params=_jax_init(jnp.float64))
    engine = HedgeEngine(load_bundle(NORTH_STAR_POLICY), device="cpu")
    rng = np.random.default_rng(3)
    states = rng.uniform(0.8, 1.2, (37, 1)).astype(np.float32)
    prices = np.column_stack([states[:, 0], np.full(37, 0.97, np.float32)])
    served = (engine.evaluate(5, states, prices),
              engine.evaluate_mixed_async(rng.integers(0, 52, 37), states, prices).result())
    return res, served


@pytest.mark.parametrize("fused", [False, True], ids=["host_loop", "fused"])
def test_telemetry_off_records_nothing_and_is_bitwise(fused, tmp_path):
    planted = tobs.ListSink()
    tobs.enable(sink=planted)
    tobs.disable()
    before = len(tobs.REGISTRY.instruments())
    off, served_off = _walk_and_engine(fused)
    assert planted.events == [] and len(tobs.REGISTRY.instruments()) == before
    assert tflight.RECORDER.recorded == 0
    with tobs.telemetry(tmp_path, flush_every_s=None):
        on, served_on = _walk_and_engine(fused)
    for k in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    for which in ("params1_by_date", "params2_by_date"):
        for k, v in getattr(off, which).items():
            assert torch.equal(getattr(on, which)[k], v), (which, k)
    for k in ("train_loss", "epochs_ran", "quantile_loss"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k))
    for a, b_ in zip(served_on, served_off):
        for x, y in zip(a, b_):
            np.testing.assert_array_equal(x, y)
    spans = collections.Counter(e["name"] for e in tobs.read_events(tmp_path / "events.jsonl")
                                if e["type"] == "span")
    # the fused walk is one span, nothing inside its date loop
    assert spans["train/walk"] == 1
    assert spans["train/fit"] == (0 if fused else 4)
    assert spans["train/outputs"] == (0 if fused else 4)


def test_fused_walk_keeps_its_loop_scope_under_telemetry(monkeypatch):
    """With telemetry on, the fused walk's date loop still runs inside
    ``fused_loop_scope`` (the smoke's ``no_host_sync`` on the card), and no
    span opens inside it."""
    import contextlib

    events = []

    @contextlib.contextmanager
    def scope(device):
        events.append("enter")
        yield
        events.append("exit")

    spans = []
    real = tobs.spans.Span.__enter__
    monkeypatch.setattr(tbackward, "fused_loop_scope", scope)
    monkeypatch.setattr(tobs.spans.Span, "__enter__",
                        lambda self: (spans.append((self.name, list(events))), real(self))[1])
    with tobs.telemetry(None):
        _walk_and_engine(True)
    assert events == ["enter", "exit"]
    assert [n for n, seen in spans if seen == ["enter"]] == []
    assert ("train/walk", []) in spans


# -- the engine -----------------------------------------------------------------------


def test_engine_spans_counters_and_devprof_partition(tmp_path):
    engine = HedgeEngine(load_bundle(NORTH_STAR_POLICY), device="cpu")
    states = np.linspace(0.8, 1.2, 37, dtype=np.float32)[:, None]
    prices = np.column_stack([states[:, 0], np.full(37, 0.97, np.float32)])
    dates = np.arange(37) % engine.n_dates
    with tobs.telemetry(tmp_path, flush_every_s=None) as st, tdevprof.profiling() as prof:
        calls = []
        complete = prof.complete

        def spy(t_dispatch, t_block, *, bucket=None):
            q, d = complete(t_dispatch, t_block, bucket=bucket)
            calls.append((t_dispatch, q, d, prof._last_complete))
            return q, d

        prof.complete = spy
        for _ in range(2):
            engine.evaluate(3, states, prices)
            engine.evaluate_mixed_async(dates, states, prices).result()
        engine.evaluate_async(0, states[:8]).result()
    assert len(calls) == 5
    for t_dispatch, q, d, t_done in calls:
        assert q >= 0.0 and d >= 0.0
        assert q + d == pytest.approx(t_done - t_dispatch, abs=1e-9)
    events = tobs.read_events(tmp_path / "events.jsonl")
    spans = collections.Counter((e["name"], e["parent"]) for e in events if e["type"] == "span")
    assert spans == {("serve/pad", None): 5, ("serve/dispatch", None): 5,
                     ("serve/unpad", None): 5}
    dispatch = [e["attrs"] for e in events if e.get("name") == "serve/dispatch"]
    assert dispatch[:2] == [{"bucket": 64, "aot": False}, {"bucket": 64, "mixed": True}]
    counters = [(e["name"], e["labels"]) for e in events if e["type"] == "counter"]
    assert counters == [("serve/bucket_misses", {"bucket": "64"}),
                        ("serve/bucket_misses", {"bucket": "64", "mixed": "1"}),
                        ("serve/bucket_misses", {"bucket": "8"})]
    reg = st.registry.collect()
    assert reg["serve/rows"]["value"] == 4 * 37 + 8
    assert reg["serve/bucket_hits"]["value"] == 2
    assert reg["serve/megakernel_dispatches"]["value"] == 2
    assert reg["serve/pad_waste_rows"]["value"] == 4 * (64 - 37)
    assert reg["serve/device_seconds{bucket=64}"]["count"] == 4
    assert "serve/device_utilization" in reg
    assert (engine.hits, engine.misses) == (2, 3)


# -- a 2-rank gloo mesh, telemetry on rank 0 only -------------------------------------


def test_two_rank_mesh_with_telemetry_on_rank0_only(tmp_path):
    spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
                                                  ROOT / "tools" / "torch_mesh_ranks.py")
    ranks_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks_tool)
    job = {"euro": {"constrain_self_financing": False},
           "sim": {"n_paths": 256, "T": 1.0, "dt": 1 / 8, "rebalance_every": 2,
                   "dtype": "float64"},
           "train": dict(MINI_GN, dual_mode="mse_only")}
    job_spec = dict(job, telemetry_ranks=[0])
    r0, r1 = ranks_tool.launch(2, {"telemetry": job_spec}, tmp_path, timeout=180)
    t0, t1 = r0["telemetry"], r1["telemetry"]
    assert t1["bundle"] is None and t0["v0_cv"] == t1["v0_cv"]
    man = t0["manifest"]
    assert man["pipeline"] == "european_hedge"
    assert man["mesh"] == t0["describe"] == {"axis": "paths", "n_devices": 2,
                                             "mesh_shape": [2], "platform": "cpu",
                                             "device_kind": "cpu"}
    (walk,) = t0["walk"]
    assert walk["attrs"]["n_paths"] == 256 and walk["attrs"]["mesh_devices"] == 2
    assert man["run_fingerprint"] == jobs.config_fingerprint(
        japi.EuropeanConfig(constrain_self_financing=False), japi.SimConfig(**job["sim"]),
        japi.TrainConfig(**job["train"]), "quantile_method=sort")
