"""The port's AOT plane on the CPU (``orp_tpu_torch/aot``): the build-cache
entry point, the index and manifest logic of a bundle's AOT set (the other
package's set refused with one warning and one counter event, the policy,
tier and rank-count checks, tier keys, stale sets pruned on re-export, the
shipped libraries' digests and their install into the cache), the sets of
multi-rank meshes one process writes (index rows spelled as the JAX
package's, padded buckets), the refusals of what needs a card, and the
engine's AOT dispatch — the copy-in, replay and
breaker — driven through a stand-in for the captured graph that runs the same
forward eagerly on the graph's static buffers, bitwise the eager engine at
every bucket, date and tier. The graphs themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` [aot]."""

import json
import warnings

import numpy as np
import pytest
import torch

from orp_tpu.aot import bundle_exec as jbundle_exec
from orp_tpu_torch import guard, obs
from orp_tpu_torch.aot import (AOT_FORMAT, AotExecutable, AotUnsupported, CompileTimeMonitor,
                               DEFAULT_CACHE_DIR, aot_compile, cost_summary, device_fingerprint,
                               enable_persistent_cache, export_aot, load_aot, resolve_cache_dir,
                               warm_fused_walk)
from orp_tpu_torch.aot import bundle_exec
from orp_tpu_torch.obs.sink import ListSink
from orp_tpu_torch.serve import HedgeEngine, export_bundle, load_bundle
from orp_tpu_torch.serve.engine import _eval_tiled
from orp_tpu_torch.train.backward import BackwardConfig
from orp_tpu_torch.utils import cuda_build

from test_torch_serve import _pair, _rows

TOPO = "cpu-cpu-n1"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path):
    """The build cache redirected into the test's directory, restored after."""
    prev = cuda_build._override
    d = enable_persistent_cache(tmp_path / "cache")
    yield d
    cuda_build.set_build_dir(prev)


def test_cache_entry_point_resolution(tmp_path, monkeypatch):
    prev = cuda_build._override
    monkeypatch.delenv("ORP_TORCH_CACHE_DIR", raising=False)
    monkeypatch.delenv("ORP_TESTS_NO_COMPILE_CACHE", raising=False)
    try:
        assert resolve_cache_dir() == DEFAULT_CACHE_DIR == cuda_build.BUILD_DIR
        # the explicit argument wins, and the builds follow it at once
        assert enable_persistent_cache(tmp_path / "a", min_compile_secs=0.25) == tmp_path / "a"
        assert cuda_build.build_dir() == tmp_path / "a"
        assert cuda_build.lib_path("mixed_head").parent == tmp_path / "a"
        # the environment when no argument is given
        monkeypatch.setenv("ORP_TORCH_CACHE_DIR", str(tmp_path / "env"))
        assert resolve_cache_dir() == tmp_path / "env"
        cuda_build.set_build_dir(None)
        assert cuda_build.build_dir() == tmp_path / "env"  # read at build time
        # the kill-switch turns every call into a no-op
        monkeypatch.setenv("ORP_TESTS_NO_COMPILE_CACHE", "1")
        assert resolve_cache_dir() is None
        assert enable_persistent_cache(tmp_path / "b") is None
        assert cuda_build.build_dir() == tmp_path / "env"
    finally:
        cuda_build.set_build_dir(prev)


def test_compile_time_monitor_reads_builds_and_captures():
    with CompileTimeMonitor() as mon:
        cuda_build.count_capture(0.25)
        assert mon.captures == 1  # readable inside the region
    cuda_build.count_capture(1.0)  # outside: not this region's
    assert mon.supported and mon.captures == 1 and mon.nvcc == 0 and mon.events == 1
    assert mon.seconds == pytest.approx(0.25)
    assert mon.split(1.0) == {"compile_wall_s": 0.25, "execute_wall_s": 0.75}


def test_cost_summary_counts_the_bucket_forward():
    pol = _pair(dual_mode="separate")[1]
    c1 = cost_summary(pol.model, 64)
    c2 = cost_summary(pol.model, 64, n_heads=2)
    assert c1["flops"] == 64 * 2 * (8 + 64 + 16) and c2["flops"] == 2 * c1["flops"]
    assert c2["bytes_accessed"] > c1["bytes_accessed"] > 64 * 3 * 4
    assert cost_summary(pol.model, 64, precision="bf16")["bytes_accessed"] \
        < c1["bytes_accessed"]


def test_what_needs_a_card_refuses_in_flag_speak(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pol = _pair()[1]
    for call in (lambda: export_aot(tmp_path, pol),
                 lambda: aot_compile(lambda x: x, torch.zeros(2), label="x"),
                 lambda: warm_fused_walk(pol.model, BackwardConfig(fused=True), n_paths=64,
                                         n_dates=4)):
        with pytest.raises(AotUnsupported, match="needs a CUDA device"):
            call()
    with pytest.raises(ValueError, match="fused=True"):
        warm_fused_walk(pol.model, BackwardConfig(), n_paths=64, n_dates=4)
    fp = device_fingerprint()
    assert set(fp) == {"platform", "device_kind", "compute_capability", "n_devices", "torch",
                       "cuda", "driver"}
    assert fp["platform"] == "cpu"


def _bundle(tmp_path, policy, name="b"):
    """The exported bundle dir and its policy fingerprint."""
    d = tmp_path / name
    return d, export_bundle(policy, d).fingerprint


def _write_set(bundle, *, policy_fingerprint, tier="f32", buckets=(8, 16), libs=None,
               fingerprint=None, fmt=AOT_FORMAT, index_extra=None):
    """An AOT set as ``export_aot`` writes it, for this CPU process's topology."""
    key = bundle_exec._tier_key(TOPO, tier)
    tdir = bundle / "aot" / key
    tdir.mkdir(parents=True, exist_ok=True)
    manifest = {"format": fmt, "fingerprint": fingerprint or device_fingerprint(),
                "topology": {"dir": TOPO, "n_devices": 1}, "precision": tier,
                "policy_fingerprint": policy_fingerprint, "libraries": libs or {},
                "buckets": {str(b): {"compile_wall_s": 0.0} for b in buckets}}
    (tdir / "aot.json").write_text(json.dumps(manifest))
    index_f = bundle / "aot" / "aot.json"
    index = json.loads(index_f.read_text()) if index_f.exists() else {"format": fmt,
                                                                       "topologies": {}}
    index["topologies"][key] = {"dir": key, **(index_extra or {})}
    index_f.write_text(json.dumps(index))
    return tdir


def _events(sink, name):
    return [e for e in sink.events if e.get("name") == name]


def test_the_other_packages_set_is_refused_both_ways(tmp_path):
    pol = _pair(seed=1)[1]
    d, fp = _bundle(tmp_path, pol)
    # a JAX-written index: one warning, one counter event, {}
    (d / "aot").mkdir()
    (d / "aot" / "aot.json").write_text(json.dumps({"format": "orp-aot-v2",
                                                    "topologies": {TOPO: {"dir": TOPO}}}))
    sink = ListSink()
    with obs.active(sink=sink):
        with pytest.warns(UserWarning, match="orp-aot-v2") as rec:
            assert load_aot(d) == {}
    assert len(rec) == 1 and len(_events(sink, "aot/fingerprint_mismatch")) == 1
    assert not bundle_exec.aot_status(d)["ok"]
    # the port's set, read by the JAX package's loader: its foreign-format path
    (d / "aot" / "aot.json").unlink()
    _write_set(d, policy_fingerprint=fp)
    with pytest.warns(UserWarning, match=AOT_FORMAT):
        assert jbundle_exec.load_aot(d) == {}


def test_policy_tier_fingerprint_and_topology_checks(tmp_path):
    pol = _pair(seed=2)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint="another policy")
    with pytest.warns(UserWarning, match="policy fingerprint mismatch"):
        assert load_aot(d, policy_fingerprint=fp) == {}
    _write_set(d, policy_fingerprint=fp)
    assert load_aot(d, policy_fingerprint=fp) == {8: None, 16: None}
    assert bundle_exec.aot_status(d)["ok"]
    with pytest.warns(UserWarning, match="no set for topology\\+tier 'cpu-cpu-n1\\+bf16'"):
        assert load_aot(d, precision="bf16") == {}
    # a manifest that says another tier than its directory
    tdir = d / "aot" / TOPO
    m = json.loads((tdir / "aot.json").read_text())
    (tdir / "aot.json").write_text(json.dumps({**m, "precision": "int8"}))
    with pytest.warns(UserWarning, match="precision tier mismatch"):
        assert load_aot(d) == {}
    # a tampered device fingerprint
    (tdir / "aot.json").write_text(json.dumps({**m, "fingerprint": {**m["fingerprint"],
                                                                     "device_kind": "x"}}))
    with pytest.warns(UserWarning, match="device/runtime fingerprint mismatch"):
        assert load_aot(d) == {}
    assert "fingerprint mismatch" in bundle_exec.aot_status(d)["detail"]
    # a multi-rank mesh resolves its own topology, which this bundle does not ship
    (tdir / "aot.json").write_text(json.dumps(m))
    with pytest.warns(UserWarning, match="no set for topology\\+tier 'cpu-cpu-n2'"):
        assert load_aot(d, mesh=2) == {}
    # a manifest whose rank count is not its directory's
    (tdir / "aot.json").write_text(json.dumps({**m, "topology": {"n_devices": 2}}))
    with pytest.warns(UserWarning, match="topology mesh size mismatch"):
        assert load_aot(d) == {}
    assert load_aot(tmp_path / "nothing") is None


def test_tier_keys_sit_beside_the_f32_set(tmp_path):
    pol = _pair(seed=4)[1]
    d, fp = _bundle(tmp_path, pol)
    assert bundle_exec._tier_key(TOPO, "f32") == TOPO
    assert bundle_exec._tier_key(TOPO, "bf16") == f"{TOPO}+bf16"
    _write_set(d, policy_fingerprint=fp, buckets=(8,))
    _write_set(d, policy_fingerprint=fp, tier="bf16", buckets=(32,))
    assert load_aot(d) == {8: None}
    assert load_aot(d, precision="bf16") == {32: None}
    assert bundle_exec.aot_status(d, precision="bf16")["ok"]
    assert sorted(json.loads((d / "aot" / "aot.json").read_text())["topologies"]) == \
        [TOPO, f"{TOPO}+bf16"]


def test_stale_sets_are_pruned_on_re_export(tmp_path):
    pol = _pair(seed=5)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp)
    stale = _write_set(d, policy_fingerprint="retrained", tier="bf16")
    torn = d / "aot" / "gpu-x-n1"
    torn.mkdir()
    index = json.loads((d / "aot" / "aot.json").read_text())
    index["topologies"]["gpu-x-n1"] = {"dir": "gpu-x-n1"}
    (d / "aot" / "aot.json").write_text(json.dumps(index))
    kept = bundle_exec._kept_topologies(d / "aot", fp)
    assert sorted(kept) == [TOPO]
    assert not stale.exists() and not torn.exists() and (d / "aot" / TOPO).exists()
    # a JAX-format index keeps nothing
    (d / "aot" / "aot.json").write_text(json.dumps({"format": "orp-aot-v2",
                                                    "topologies": index["topologies"]}))
    assert bundle_exec._kept_topologies(d / "aot", fp) == {}


def test_shipped_libraries_are_checked_and_installed(tmp_path, cache):
    pol = _pair(seed=6)[1]
    d, fp = _bundle(tmp_path, pol)
    want = cuda_build.lib_path("mixed_head")
    assert want.parent == cache and not want.exists()
    tdir = _write_set(d, policy_fingerprint=fp, libs={"mixed_head": want.name})
    (tdir / want.name).write_bytes(b"\x7fELF stand-in")
    builds = dict(cuda_build.BUILD_STATS)
    assert load_aot(d) == {8: None, 16: None}
    assert want.read_bytes() == b"\x7fELF stand-in"  # installed, no nvcc
    assert cuda_build.BUILD_STATS["nvcc"] == builds["nvcc"]
    # a library built from another csrc/ refuses
    _write_set(d, policy_fingerprint=fp, libs={"mixed_head": "libmixed_head-0.so"})
    with pytest.warns(UserWarning, match="another csrc/"):
        assert load_aot(d) == {}


def test_store_manifest_lists_the_aot_sets(tmp_path):
    from orp_tpu.store.catalog import open_store as jopen_store
    from orp_tpu_torch.store.catalog import open_store

    pol = _pair(seed=7)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp)
    _write_set(d, policy_fingerprint=fp, tier="bf16")
    ours = open_store(tmp_path / "s1").publish("alpha", d)
    theirs = jopen_store(tmp_path / "s2").publish("alpha", d)
    m = json.loads(open_store(tmp_path / "s1").cas.get(ours["manifest"]))
    assert {TOPO, f"{TOPO}+bf16"} <= set(m["aot_topologies"])
    assert ours["manifest"] == theirs["manifest"]  # the same document, byte for byte
    assert load_bundle(d).aot_dir == d


class _EagerGraph:
    """A stand-in for a captured graph on the CPU: its static buffers, and a
    replay that runs the engine's forward on them eagerly into fixed output
    buffers (a graph's replay overwrites its outputs the same way)."""

    def __init__(self, engine, bucket):
        dt = engine.model.dtype
        self.args = (torch.zeros((), dtype=torch.int64),
                     torch.zeros((bucket, engine.model.n_features), dtype=dt),
                     torch.zeros((bucket, engine.n_instruments), dtype=dt))
        self.engine = engine
        self.outputs = None

    def replay(self):
        e = self.engine
        outs = _eval_tiled(e.model, e._p1, e._p2, *self.args, e.cost_of_capital,
                           dual_mode=e.dual_mode, holdings_combine=e.holdings_combine,
                           precision=e.precision.tier)
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(o) for o in outs)
        for buf, o in zip(self.outputs, outs):
            buf.copy_(o)
        return self.outputs


def _stand_in(engine, buckets):
    engine._aot = {b: AotExecutable(b, _EagerGraph(engine, b), {}) for b in buckets}
    return engine


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dual_mode", ["mse_only", "separate"])
def test_aot_dispatch_is_bitwise_the_eager_engine(tier, dual_mode):
    """Every bucket and date through the AOT path (the date a 0-d tensor
    gathered on the device, the rows copied into static buffers, the outputs
    copied out) against ``use_aot=False``; an output held across the next
    replay keeps its bits."""
    pol = _pair(dual_mode=dual_mode, n_dates=5, seed=8)[1]
    eager = HedgeEngine(pol, device="cpu", precision=tier, use_aot=False)
    buckets = (8, 16, 64)
    aot = _stand_in(HedgeEngine(pol, device="cpu", precision=tier), buckets)
    n_req = 0
    for b in buckets:
        states, prices = _rows(b - 3, 1, eager.n_instruments, seed=b)
        for date in (0, 2, 4, -1):
            pend = aot.evaluate_async(date, states, prices)
            aot.evaluate(date, states + 1.0, prices)  # a later replay of the same graph
            got, want = pend.result(), eager.evaluate(date, states, prices)
            n_req += 2
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
    info = aot.cache_info()
    assert info["aot_hits"] == n_req and info["aot_buckets"] == list(buckets)
    assert info["misses"] == 0 and info["hits"] == n_req


def test_aot_dispatch_span_faults_and_demotion():
    """The dispatch span says ``aot: True``; three ``serve/aot_dispatch`` faults
    in a row demote the bucket (one warning, ``guard/circuit_open``) and every
    request is still served, bitwise; hangs demote through the watchdog too."""
    pol = _pair(n_dates=3, seed=9)[1]
    eager = HedgeEngine(pol, device="cpu", use_aot=False)
    aot = _stand_in(HedgeEngine(pol, device="cpu"), (8, 16))
    states, _ = _rows(5, 1, 2)
    want = eager.evaluate(1, states)
    sink = ListSink()
    with obs.active(sink=sink):
        aot.evaluate(1, states)
        plan = guard.FaultPlan(fail={"serve/aot_dispatch": 3})
        with guard.faults(plan), pytest.warns(UserWarning, match="circuit opened") as rec:
            for _ in range(3):
                got = aot.evaluate(1, states)
                assert all(np.array_equal(g, w) for g, w in zip(got, want)
                           if g is not None)
        assert len(rec) == 1
        got = aot.evaluate(1, states)
        assert all(np.array_equal(g, w) for g, w in zip(got, want) if g is not None)
    spans = [e for e in sink.events if e.get("name") == "serve/dispatch"]
    assert spans[0]["attrs"]["aot"] is True and spans[-1]["attrs"]["aot"] is False
    assert len(_events(sink, "guard/aot_exec_failure")) == 3
    info = aot.cache_info()
    assert info["aot_buckets"] == [16] and info["aot_circuit_open"] == [8]
    assert info["aot_hits"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            aot.watchdog_trip(16)
    assert aot.cache_info()["aot_buckets"] == [] and "hang:16" in \
        aot.cache_info()["aot_circuit_open"]


def test_engine_on_a_foreign_set_warns_once_and_serves_the_same_bits(tmp_path):
    pol = _pair(seed=10)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp, fmt="orp-aot-v2")
    loaded = load_bundle(d)
    assert loaded.aot_dir == d
    with pytest.warns(UserWarning, match="unusable") as rec:
        engine = HedgeEngine(loaded, device="cpu")
    assert len(rec) == 1
    info = engine.cache_info()
    assert info["aot_buckets"] == [] and info["nvcc_runs"] == 0 and info["graph_captures"] == 0
    states, _ = _rows(7, 1, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = HedgeEngine(loaded, device="cpu", use_aot=False)  # no load, no warning
    for g, w in zip(engine.evaluate(2, states), plain.evaluate(2, states)):
        assert (g is None and w is None) or np.array_equal(g, w)


@pytest.fixture
def stand_in_capture(monkeypatch):
    """``AotExecutable.capture`` as the CPU stand-in, counted in
    ``cuda_build.BUILD_STATS`` as a capture on the card is."""

    def capture(cls, engine, bucket):
        cuda_build.count_capture(0.0)
        return cls(bucket, _EagerGraph(engine, bucket), {})

    monkeypatch.setattr(bundle_exec.AotExecutable, "capture", classmethod(capture))


def test_engines_sharing_resident_params_share_their_graphs(tmp_path, stand_in_capture):
    """The first engine of a ``ResidentParams`` captures the set's buckets; an
    engine built on the same resident params captures none and replays the
    same graphs, bitwise; a demotion stays the demoting engine's own."""
    pol = _pair(n_dates=3, seed=11)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp, buckets=(8, 16))
    loaded = load_bundle(d)

    def captures(build):
        c0 = cuda_build.BUILD_STATS["captures"]
        engine = build()
        return engine, cuda_build.BUILD_STATS["captures"] - c0

    first, n = captures(lambda: HedgeEngine(loaded, device="cpu"))
    assert n == 2
    second, n = captures(lambda: HedgeEngine(loaded, device="cpu", resident=first.resident))
    assert n == 0 and second.cache_info()["aot_buckets"] == [8, 16]
    assert second._aot[8] is first._aot[8]
    eager = HedgeEngine(loaded, device="cpu", use_aot=False)
    states, _ = _rows(6, 1, 2)
    for g, w in zip(second.evaluate(2, states), eager.evaluate(2, states)):
        assert (g is None and w is None) or np.array_equal(g, w)
    assert second.cache_info()["aot_hits"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            second.watchdog_trip(8)
    assert second.cache_info()["aot_buckets"] == [16]
    assert first.cache_info()["aot_buckets"] == [8, 16]
    # another tier is another resident: its own set, its own captures
    _write_set(d, policy_fingerprint=fp, tier="bf16", buckets=(32,))
    bf16, n = captures(lambda: HedgeEngine(load_bundle(d), device="cpu", precision="bf16",
                                           resident=first.resident))
    assert bf16.resident is not first.resident
    assert bf16.cache_info()["aot_buckets"] == [32] and n == 1


def test_a_warm_re_activation_captures_no_graph(tmp_path, stand_in_capture):
    """A ``ServeHost`` AOT tenant evicted to warm by another is re-activated
    with 0 ``nvcc`` runs and 0 graph captures, served from its graphs with the
    eager engine's bits."""
    from orp_tpu_torch.serve.host import ServeHost

    pol = _pair(n_dates=3, seed=12)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp, buckets=(8,))
    eager = HedgeEngine(load_bundle(d), device="cpu", use_aot=False)
    states, _ = _rows(5, 1, 2)
    want = eager.evaluate(1, states)
    with ServeHost(max_live_engines=1, engine_kwargs={"device": "cpu"}) as host:
        for name in ("a", "b"):
            host.add_tenant(name, str(d))
        host.evaluate("a", 1, states)
        host.evaluate("b", 1, states)
        assert host.stats()["a"]["live"] is False
        b0 = dict(cuda_build.BUILD_STATS)
        got = host.evaluate("a", 1, states)
        assert {k: cuda_build.BUILD_STATS[k] - b0[k] for k in ("nvcc", "captures")} == \
            {"nvcc": 0, "captures": 0}
        info = host._tenants["a"].engine.cache_info()
        assert info["aot_hits"] == 1 and info["aot_buckets"] == [8]
        assert host.stats()["a"]["activations"] == 2
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)


def test_a_failed_capture_is_not_kept_for_the_next_engine(tmp_path, monkeypatch):
    """A capture that fails falls back (one warning) and is not kept in the
    resident params: the next engine on them captures again."""
    pol = _pair(n_dates=3, seed=13)[1]
    d, fp = _bundle(tmp_path, pol)
    _write_set(d, policy_fingerprint=fp, buckets=(8,))
    loaded = load_bundle(d)
    calls = []

    def capture(cls, engine, bucket):
        calls.append(bucket)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: operation not permitted when stream is capturing")
        return cls(bucket, _EagerGraph(engine, bucket), {})

    monkeypatch.setattr(bundle_exec.AotExecutable, "capture", classmethod(capture))
    with pytest.warns(UserWarning, match="capture failed") as rec:
        first = HedgeEngine(loaded, device="cpu")
    assert len(rec) == 1 and first.cache_info()["aot_buckets"] == [] and first.resident.aot == {}
    second = HedgeEngine(loaded, device="cpu", resident=first.resident)
    assert second.cache_info()["aot_buckets"] == [8] and calls == [8, 8]


def test_mesh_sets_are_written_by_one_process_with_the_references_rows(tmp_path):
    """``export_aot(meshes=(4, 2))`` from this one CPU process (no group): the
    index rows and ``dir`` spellings are the JAX package's ``_topo_entry`` and
    ``topology_fingerprint`` of the same ``MeshSpec`` (the single-device row
    too, which the card writes); each set lists its buckets padded as the JAX
    package pads them and no library, and resolves for that topology's ranks. The single-device set
    still needs a card, refused before anything is written."""
    from orp_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from orp_tpu.parallel.mesh import pad_to_mesh as jpad_to_mesh
    from orp_tpu.parallel.mesh import topology_fingerprint as jtopology_fingerprint
    from orp_tpu.serve.engine import next_bucket as jnext_bucket
    from orp_tpu_torch.parallel import MeshSpec

    pol = _pair(n_dates=3, seed=14)[1]
    d, fp = _bundle(tmp_path, pol)
    if not torch.cuda.is_available():
        with pytest.raises(AotUnsupported, match="single-device set needs a CUDA device"):
            export_aot(d, load_bundle(d), meshes=(None, 4, 2), device="cpu")
        assert not (d / "aot").exists()
    out = export_aot(d, load_bundle(d), buckets=(1, 8, 9, 100), meshes=(4, MeshSpec(2), 4),
                     device="cpu")
    index = json.loads((d / "aot" / "aot.json").read_text())
    assert sorted(index["topologies"]) == sorted(out["topologies"]) == ["cpu-cpu-n2",
                                                                        "cpu-cpu-n4"]
    for n in (4, 2):
        want = jbundle_exec._topo_entry(JMeshSpec(n))
        assert want["dir"] == jtopology_fingerprint(JMeshSpec(n)) == f"cpu-cpu-n{n}"
        assert index["topologies"][want["dir"]] == want
        manifest = out["topologies"][want["dir"]]
        assert manifest["topology"] == want and manifest["libraries"] == {}
        assert "launches no kernel" in manifest["libraries_note"]
        assert manifest["policy_fingerprint"] == fp and manifest["precision"] == "f32"
        assert sorted(int(b) for b in manifest["buckets"]) == sorted(
            {jpad_to_mesh(jnext_bucket(k), JMeshSpec(n)) for k in (1, 8, 9, 100)})
        assert all(e["shard_rows"] * n == int(b) for b, e in manifest["buckets"].items())
        assert bundle_exec.aot_status(d, mesh=n)["ok"]
        assert load_aot(d, mesh=MeshSpec(n), policy_fingerprint=fp) == {
            int(b): None for b in manifest["buckets"]}
    assert bundle_exec._topo_entry(None, "cpu") == jbundle_exec._topo_entry(None)
    with pytest.warns(UserWarning, match="no set for topology\\+tier 'cpu-cpu-n8'"):
        assert load_aot(d, mesh=8) == {}
    # a 3-rank set pads every bucket to a multiple of 3, as the reference's engine
    out = export_aot(d, load_bundle(d), buckets=(1, 16), meshes=(3,), device="cpu")
    assert sorted(int(b) for b in out["topologies"]["cpu-cpu-n3"]["buckets"]) == [9, 18]
    assert sorted(json.loads((d / "aot" / "aot.json").read_text())["topologies"]) == [
        "cpu-cpu-n2", "cpu-cpu-n3", "cpu-cpu-n4"]
