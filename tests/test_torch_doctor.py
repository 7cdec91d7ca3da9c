"""``orp_tpu_torch.serve.health.doctor_report`` against the JAX package's
``orp_tpu.serve.health.doctor_report`` — the counterparts of the doctor tests
in ``test_perf``, ``test_pilot``, ``test_quality``, ``test_store``,
``test_fleet``, ``test_ingest`` and ``test_telemetry_plane``.

Each probe is ok on a sound input and fails in flag-speak (a ``fix`` row) on
a broken one. On the journals, ledgers and stores the JAX package writes, and
on bundles each package exports from the same training configuration, the
port's report has the same check names, in the same order, with the same ok
values as the JAX package's — except ``devices`` and ``perf_*``, which
describe this process. The reference's dead-but-accepting gateway test fails
in this repo's tier-1 runs (ROADMAP C), so the gateway probe here is judged
on a live and on a closed endpoint only. Every socket probe is bounded by ``gateway_timeout_s``.
"""

import json
import shutil

import pytest
import torch

from orp_tpu import api as japi
from orp_tpu.obs import perf as jperf
from orp_tpu.pilot import journal as jjournal
from orp_tpu.serve import export_bundle as jexport_bundle
from orp_tpu.serve.health import doctor_report as jdoctor_report
from orp_tpu.store.catalog import open_store as jopen_store
from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu_torch.guard import GuardPolicy
from orp_tpu_torch.obs import perf
from orp_tpu_torch.pilot import journal_append
from orp_tpu_torch.serve import (GatewayClient, ServeGateway, ServeHost, export_bundle)
from orp_tpu_torch.serve.fleet import ROUTE_SAMPLE, FleetHost, ReplicaHealth, ReplicaSpec
from orp_tpu_torch.serve.health import doctor_report
from orp_tpu_torch.serve.scrape import parse_prometheus
from orp_tpu_torch.store.catalog import open_store

from test_torch_serve import _pair

CPU = {"device": "cpu"}
SIM = dict(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2)
TRAIN = dict(dual_mode="mse_only", epochs_first=8, epochs_warm=4)
THIS_PROCESS = ("devices", "perf_profiler", "perf_peaks")
FAST_RETRY = GuardPolicy(max_retries=2, backoff_ms=2.0, backoff_cap_ms=10.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The same training configuration exported by each package."""
    root = tmp_path_factory.mktemp("bundles")
    export_bundle(european_hedge(EuropeanConfig(), SimConfig(**SIM), TrainConfig(**TRAIN),
                                 device="cpu"), root / "port")
    jexport_bundle(japi.european_hedge(japi.EuropeanConfig(), japi.SimConfig(**SIM),
                                       japi.TrainConfig(**TRAIN)), root / "jax")
    return root / "port", root / "jax"


@pytest.fixture(scope="module")
def policy():
    return _pair(n_features=1, n_dates=4, seed=3)[1]


def _by(rep):
    return {c["check"]: c for c in rep["checks"]}


def _same_as_jax(got, want):
    """Check names in order, and ok values but for this process's rows."""
    assert [c["check"] for c in got["checks"]] == [c["check"] for c in want["checks"]]
    for g, w in zip(got["checks"], want["checks"]):
        if g["check"] not in THIS_PROCESS:
            assert g["ok"] == w["ok"], (g, w)
            assert ("fix" in g) == ("fix" in w), (g, w)


def test_doctor_always_on_rows(tmp_path):
    """With no probe asked for, the report is the device, the build cache and
    the concurrency pass over the port — each ok on the CPU, in the JAX
    package's order."""
    rep = doctor_report(cache_dir=tmp_path / "cache", device="cpu")
    assert [c["check"] for c in rep["checks"]] == ["devices", "compile_cache",
                                                   "lint_concurrency"]
    by = _by(rep)
    assert rep["ok"] and "topology cpu-cpu-n1" in by["devices"]["detail"]
    assert "writable" in by["compile_cache"]["detail"]
    assert "no unsuppressed findings" in by["lint_concurrency"]["detail"]
    _same_as_jax(rep, jdoctor_report(cache_dir=tmp_path / "jcache"))


def test_doctor_oversized_mesh_fails_in_flag_speak():
    rep = doctor_report(mesh=64, device="cpu")
    row = _by(rep)["devices"]
    assert not row["ok"] and "shrink the mesh" in row["fix"] and not rep["ok"]


def test_doctor_unwritable_cache_fails_in_flag_speak(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    rep = doctor_report(cache_dir=blocker / "cache", device="cpu")
    row = _by(rep)["compile_cache"]
    assert not row["ok"] and "ORP_TORCH_CACHE_DIR" in row["fix"]
    monkeypatch.setenv("ORP_TESTS_NO_COMPILE_CACHE", "1")
    row = _by(doctor_report(device="cpu"))["compile_cache"]
    assert row["ok"] and "kill-switch" in row["detail"]


def test_doctor_perf_checks(tmp_path):
    led = tmp_path / "led.jsonl"
    perf.ledger_append(led, perf.make_record("u", "p", [1.0, 1.0, 1.0]))
    rep = doctor_report(perf=str(led), device="cpu")
    by = _by(rep)
    assert by["perf_profiler"]["ok"] and "torch.profiler" in by["perf_profiler"]["detail"]
    assert by["perf_ledger"]["ok"] and "1 record(s)" in by["perf_ledger"]["detail"]
    # the CPU is not in the peak table: the check fails IN FLAG-SPEAK naming
    # the measured-matmul fallback and where the H100 row lives
    assert not by["perf_peaks"]["ok"]
    assert "PEAK_TABLE" in by["perf_peaks"]["fix"]
    assert "measured-matmul" in by["perf_peaks"]["detail"]
    by = _by(doctor_report(perf=str(tmp_path / "absent.jsonl"), device="cpu"))
    assert by["perf_ledger"]["ok"] and "absent" in by["perf_ledger"]["detail"]
    led.write_text("{broken\n" + led.read_text())
    by = _by(doctor_report(perf=str(led), device="cpu"))
    assert not by["perf_ledger"]["ok"] and "move the corrupt ledger aside" in (
        by["perf_ledger"]["fix"])


def test_doctor_perf_peaks_covers_the_h100_row(monkeypatch):
    """On the card the kind is the H100 row's: covered."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: perf.H100)
    row = _by(doctor_report(perf="/nonexistent/dir/led.jsonl", device="cpu"))["perf_peaks"]
    assert row["ok"] and "PEAK_TABLE covers" in row["detail"]


def test_doctor_perf_on_a_jax_written_ledger(tmp_path):
    led = tmp_path / "jax.jsonl"
    jperf.ledger_append(led, jperf.make_record("u", "p", [1.0, 2.0, 3.0]))
    _same_as_jax(doctor_report(perf=str(led), device="cpu"), jdoctor_report(perf=str(led)))
    assert _by(doctor_report(perf=str(led), device="cpu"))["perf_ledger"]["ok"]


def test_doctor_pilot_probe(tmp_path):
    """A parked cycle reads as resumable, a terminal cycle with NO
    promotions chain is a FAIL in flag-speak, a torn-middle journal fails the
    parse probe, an unreadable feed fails the trigger probe."""
    jp = tmp_path / "pilot.jsonl"
    journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating"})
    rows = _by(doctor_report(pilot=jp, device="cpu"))
    assert rows["pilot_journal"]["ok"] and rows["pilot_cycle"]["ok"]
    assert "resumable" in rows["pilot_cycle"]["detail"]
    assert rows["pilot_triggers"]["ok"]         # no config: manual-only
    journal_append(jp, {"kind": "config", "tenant": "desk", "calib_window": 160,
                        "prices_path": str(tmp_path / "missing.csv"),
                        "events_dir": str(tmp_path)})
    journal_append(jp, {"kind": "transition", "cycle": 0, "state": "promoted", "chain": None})
    rows = _by(doctor_report(pilot=jp, device="cpu"))
    assert not rows["pilot_cycle"]["ok"] and "promotion_chain" in rows["pilot_cycle"]["fix"]
    assert not rows["pilot_triggers"]["ok"] and "prices_path" in rows["pilot_triggers"]["fix"]
    jp.write_text("{broken\n" + jp.read_text())
    rows = _by(doctor_report(pilot=jp, device="cpu"))
    assert not rows["pilot_journal"]["ok"] and "move the corrupt file aside" in (
        rows["pilot_journal"]["fix"])


@pytest.mark.parametrize("last", ["calibrating", "promoted", "rejected", "failed"])
def test_doctor_pilot_on_a_jax_written_journal(tmp_path, last):
    """A journal the JAX package's controller would leave (its own chain
    included): the same rows and verdicts from both packages' doctors."""
    from orp_tpu.obs.manifest import chain_append

    jp, chain = tmp_path / "pilot.jsonl", tmp_path / "promotions.jsonl"
    prices = tmp_path / "prices.csv"
    prices.write_text("\n".join(str(100.0 + i) for i in range(200)) + "\n")
    jjournal.journal_append(jp, {"kind": "config", "tenant": "desk", "calib_window": 160,
                                 "prices_path": str(prices), "events_dir": str(tmp_path)})
    jjournal.journal_append(jp, {"kind": "transition", "cycle": 0, "state": "calibrating"})
    if last != "calibrating":
        if last in ("promoted", "rejected"):
            chain_append(chain, {"action": {"promoted": "promote",
                                            "rejected": "reject"}[last], "tenant": "desk"})
        jjournal.journal_append(jp, {"kind": "transition", "cycle": 0, "state": last,
                                     "chain": str(chain)})
    got = doctor_report(pilot=jp, device="cpu")
    _same_as_jax(got, jdoctor_report(pilot=jp))
    assert got["ok"]


def test_doctor_quality_probe_and_jax_parity(bundles, tmp_path):
    port_dir, jax_dir = bundles
    rep = doctor_report(bundle_dir=port_dir, quality=port_dir, device="cpu")
    by = _by(rep)
    assert by["bundle"]["ok"] and by["bundle_aot"]["ok"]
    assert by["quality"]["ok"] and "hedge_error" in by["quality"]["detail"]
    assert "RQMC" in by["quality"]["detail"]
    _same_as_jax(rep, jdoctor_report(bundle_dir=jax_dir, quality=jax_dir))
    # a pre-quality bundle: same policy, baseline key stripped
    old = tmp_path / "old_bundle"
    shutil.copytree(port_dir, old)
    meta = json.loads((old / "bundle.json").read_text())
    meta.pop("baseline")
    (old / "bundle.json").write_text(json.dumps(meta, indent=1, sort_keys=True))
    rep = doctor_report(quality=str(old), device="cpu")
    row = _by(rep)["quality"]
    assert row["ok"] is False and "re-export" in row["fix"] and rep["ok"] is False
    # a missing bundle fails the bundle row in flag-speak
    row = _by(doctor_report(bundle_dir=tmp_path / "nope", device="cpu"))["bundle"]
    assert not row["ok"] and "re-export" in row["fix"]


def test_doctor_store_probe(tmp_path, bundles):
    port_dir, _ = bundles
    root = tmp_path / "store"
    store = open_store(root)
    store.publish("alpha", port_dir)
    rep = doctor_report(store=str(root), device="cpu")
    by = _by(rep)
    assert rep["ok"] and "dedup ratio" in by["store_catalog"]["detail"]
    assert by["store_cas"]["ok"] and by["store_refs"]["ok"]
    store.cas.put(b"orphan bytes")
    by = _by(doctor_report(store=str(root), device="cpu"))
    assert by["store_refs"]["ok"] and "orp store gc" in by["store_refs"]["detail"]
    ref = sorted(store.referenced())[0]
    blob = store.cas._blob_path(ref)
    blob.chmod(0o644)
    blob.unlink()
    rep = doctor_report(store=str(root), device="cpu")
    by = _by(rep)
    assert not rep["ok"] and not by["store_refs"]["ok"]
    assert "orp store put" in by["store_refs"]["fix"]


def test_doctor_store_on_a_jax_written_store(tmp_path, bundles):
    _, jax_dir = bundles
    root = tmp_path / "jstore"
    jopen_store(root).publish("alpha", jax_dir)
    _same_as_jax(doctor_report(store=str(root), device="cpu"), jdoctor_report(store=str(root)))
    assert _by(doctor_report(store=str(root), device="cpu"))["store_refs"]["ok"]


def test_doctor_probes_gateway_liveness(policy):
    with ServeHost(engine_kwargs=CPU) as host:
        host.add_tenant("d", policy)
        with ServeGateway(host, port=0) as gw:
            addr, port = gw.address
            rep = doctor_report(gateway=f"{addr}:{port}", gateway_timeout_s=5.0, device="cpu")
            [check] = [c for c in rep["checks"] if c["check"] == "gateway"]
            assert check["ok"] and "PING/PONG ok" in check["detail"]
    rep = doctor_report(gateway=f"{addr}:{port}", gateway_timeout_s=5.0, device="cpu")
    [check] = [c for c in rep["checks"] if c["check"] == "gateway"]
    assert not check["ok"] and "serve-gateway" in check["fix"]


def test_metrics_wire_kind_and_doctor_probe(policy):
    with ServeHost(engine_kwargs=CPU) as host:
        host.add_tenant("desk", policy)
        with ServeGateway(host, port=0, default_tenant="desk") as gw:
            addr, port = gw.address
            with GatewayClient(addr, port, timeout_s=10.0) as client:
                series = parse_prometheus(client.metrics())
            for core in ("serve_gateway_rows", "serve_queue_age_seconds", "guard_shed"):
                assert core in series, core
            rep = doctor_report(metrics=f"{addr}:{port}", gateway_timeout_s=5.0,
                                device="cpu")
            row = _by(rep)["metrics"]
            assert row["ok"] and "core present" in row["detail"], row
    row = _by(doctor_report(metrics=f"{addr}:{port}", gateway_timeout_s=1.0,
                            device="cpu"))["metrics"]
    assert not row["ok"] and "fix" in row


def test_doctor_fleet_probe_agreement_and_failures(tmp_path, policy):
    tenants = list(ROUTE_SAMPLE[:2])
    host = ServeHost(max_live_engines=4, engine_kwargs=CPU)
    for t in tenants:
        host.add_tenant(t, policy)
    rep_gw = ServeGateway(host, port=0)
    specs = [ReplicaSpec("r0", *rep_gw.address)]
    fleet = FleetHost(specs, retry=FAST_RETRY, timeout_s=10.0,
                      health=ReplicaHealth(specs, start=False))
    fleet_gw = ServeGateway(fleet, port=0)
    try:
        topo = tmp_path / "topology.json"
        topo.write_text(json.dumps({"gateways": ["%s:%d" % fleet_gw.address],
                                    "replicas": {"r0": "%s:%d" % rep_gw.address}}))
        rep = doctor_report(fleet=str(topo), gateway_timeout_s=5.0, device="cpu")
        by = _by(rep)
        assert by["fleet_topology"]["ok"] and by["replica:r0"]["ok"], by
        assert by["fleet_routing"]["ok"] and "agree" in by["fleet_routing"]["detail"]
        assert rep["ok"]
        topo.write_text(json.dumps({"gateways": ["%s:%d" % fleet_gw.address],
                                    "replicas": {"r0": "%s:%d" % rep_gw.address,
                                                 "r9": "127.0.0.1:1"}}))
        rep2 = doctor_report(fleet=str(topo), gateway_timeout_s=2.0, device="cpu")
        by2 = _by(rep2)
        assert not rep2["ok"] and not by2["replica:r9"]["ok"]
        assert "restart the replica" in by2["replica:r9"]["fix"]
        # a plain serving gateway named as a fleet gateway: no routing view
        topo.write_text(json.dumps({"gateways": ["%s:%d" % rep_gw.address],
                                    "replicas": {"r0": "%s:%d" % rep_gw.address}}))
        by3 = _by(doctor_report(fleet=str(topo), gateway_timeout_s=5.0, device="cpu"))
        gw_row = by3["gateway:%s:%d" % rep_gw.address]
        assert not gw_row["ok"] and "--fleet" in gw_row["fix"]
    finally:
        fleet_gw.close(timeout=5.0)
        fleet.close()
        rep_gw.close(timeout=5.0)
        host.close()
    by = _by(doctor_report(fleet=str(tmp_path / "missing.json"), device="cpu"))
    assert not by["fleet_topology"]["ok"] and "topology.json" in by["fleet_topology"]["fix"]
