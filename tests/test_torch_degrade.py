"""The port's topology degradation (``orp_tpu_torch/guard/degrade.py``) on the
CPU: a device loss injected under a request or a block traps it, rebuilds the
engine and replays it with 0 failed requests, bitwise the healthy engine, with
the reference's ``stats()`` and recovery-record keys; a persistent loss is
bounded; the clean path emits nothing; a mesh larger than the process group is
refused; the served values match the JAX package's ``HedgeEngine`` at
``tests/test_torch_serve.py``'s tolerance; and ``serve/bench._degrade_drill``'s
record.

On a mesh: four ``gloo`` ranks, one process each, launched once for the module
(``tools/torch_mesh_ranks.launch``, a hard timeout), every rank constructing
``DegradeManager(mesh=4)`` on a bundle that ships the CPU's 4- and 2-rank sets
(the graphs stand-ins: the CPU captures none). A loss reporting 3 survivors
rebuilds on the first 2 ranks from the 2-rank set (0 ``nvcc`` runs, one
capture per bucket on each), ranks 2 and 3 stand down, and every answer
(healthy, replayed, recovered; requests and blocks) is bitwise rank 0's
single-device engine and within ``TOL`` of JAX's, as the reference pins on its
virtual 8-device mesh (``tests/test_guard.py``)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from orp_tpu.serve.engine import HedgeEngine as JHedgeEngine
from orp_tpu_torch import guard, obs
from orp_tpu_torch.aot import export_aot
from orp_tpu_torch.guard import DegradeManager, DeviceLostError, FaultPlan, GuardPolicy
from orp_tpu_torch.obs.sink import ListSink
from orp_tpu_torch.parallel import MeshSpec
from orp_tpu_torch.serve import HedgeEngine, export_bundle, load_bundle
from orp_tpu_torch.serve.bench import _degrade_drill

from test_torch_serve import TOL, _pair, _rows

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
                                               ROOT / "tools" / "torch_mesh_ranks.py")
ranks_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks_tool)

CPU = {"device": "cpu"}
#: the reference's ``stats()`` and recovery-record keys (``orp_tpu/guard/degrade.py``)
STATS_KEYS = {"mesh_devices", "recovering", "pending_replay", "recoveries", "mttr_ms"}
RECOVERY_KEYS = {"from_devices", "to_devices", "survivors_reported", "replayed",
                 "replay_unresolved", "mttr_ms", "rebuild_xla_compiles", "aot_buckets"}


def _settled(mgr):
    """``stats()`` once the recovery thread has recorded its recovery (the
    replayed futures resolve before it does)."""
    if mgr._recovery_thread is not None:
        mgr._recovery_thread.join(timeout=30)
    return mgr.stats()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _pair(dual_mode="separate", n_dates=5, seed=11)


@pytest.mark.parametrize("k", [0, 3, 7])
def test_loss_at_request_k_replays_bitwise_with_no_failure(pair, k):
    jpol, pol = pair
    ref = HedgeEngine(pol, **CPU)
    states, prices = _rows(10, 1, 2, seed=k)
    want = [ref.evaluate(i % ref.n_dates, states[i:i + 1], prices[i:i + 1]) for i in range(10)]
    sink = ListSink()
    with obs.active(sink=sink):
        with DegradeManager(pol, engine_kwargs=CPU) as mgr:
            futures = []
            for i in range(10):
                args = (i % ref.n_dates, states[i:i + 1], prices[i:i + 1])
                if i == k:
                    with guard.faults(FaultPlan(device_loss={"serve/dispatch": 1},
                                                survivors=0)) as inj:
                        futures.append(mgr.submit(*args))
                        futures[-1].exception(timeout=30)
                else:
                    futures.append(mgr.submit(*args))
            got = [f.result(timeout=30) for f in futures]
            st = _settled(mgr)
    assert [site for site, _ in inj.log] == ["serve/dispatch"]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    assert set(st) == STATS_KEYS and st["mesh_devices"] == 1 and not st["recovering"]
    [rec] = st["recoveries"]
    assert RECOVERY_KEYS <= set(rec)
    # the lost dispatch may have coalesced the next requests: each is trapped and replayed
    assert rec["replayed"] >= 1 and rec["replay_unresolved"] == 0 and rec["mttr_ms"] > 0
    assert rec["rebuild_xla_compiles"] == 0 and rec["to_devices"] == 1
    names = [e.get("name") for e in sink.events]
    assert names.count("guard/device_loss") == 1 and names.count("guard/topology_rebuild") == 1


def test_block_loss_replays_the_whole_block_and_matches_jax(pair):
    jpol, pol = pair
    states, prices = _rows(16, 1, 2, seed=21)
    with DegradeManager(pol, engine_kwargs=CPU) as mgr:
        healthy = mgr.submit_block(2, states, prices).result(timeout=30)
        with guard.faults(FaultPlan(device_loss={"serve/dispatch": 1})):
            replayed = mgr.submit_block(2, states, prices).result(timeout=30)
        st = _settled(mgr)
    for res in (healthy, replayed):
        assert res.n_served == 16
        assert np.array_equal(res.phi, healthy.phi) and np.array_equal(res.psi, healthy.psi)
    assert st["recoveries"][0]["replayed"] == 1
    jphi, jpsi, jv = JHedgeEngine(jpol).evaluate(2, states, prices)
    np.testing.assert_allclose(replayed.phi, np.asarray(jphi), **TOL)
    np.testing.assert_allclose(replayed.psi, np.asarray(jpsi), **TOL)
    np.testing.assert_allclose(replayed.value, np.asarray(jv), **TOL)


def test_persistent_loss_is_bounded_and_the_manager_recovers(pair):
    _, pol = pair
    ref = HedgeEngine(pol, **CPU)
    states, _ = _rows(2, 1, 2)
    want = ref.evaluate(0, states)[0]
    with DegradeManager(pol, engine_kwargs=CPU, replay_timeout_s=0.2) as mgr:
        with guard.faults(FaultPlan(device_loss={"serve/dispatch": 1000})):
            fut = mgr.submit(0, states)
            with pytest.raises(DeviceLostError, match="replay window"):
                fut.result(timeout=30)
        assert np.array_equal(mgr.evaluate(0, states)[0], want)
        st = _settled(mgr)
        assert not st["recovering"] and st["pending_replay"] == 0


def test_clean_path_emits_no_guard_event(pair):
    _, pol = pair
    states, _ = _rows(3, 1, 2)
    want = HedgeEngine(pol, **CPU).evaluate(0, states)
    sink = ListSink()
    with obs.active(sink=sink):
        with DegradeManager(pol, engine_kwargs=CPU,
                            guard_policy=GuardPolicy(hard_wall_ms=5000.0)) as mgr:
            got = mgr.evaluate(0, states)
            st = mgr.stats()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert st["recoveries"] == [] and st["mttr_ms"] is None
    assert [e for e in sink.events if e.get("name", "").startswith("guard/")] == []


def test_a_multi_rank_mesh_is_refused_and_one_rank_is_the_single_device(pair):
    """What is still refused: a mesh larger than the process group (here no
    group, one process), in flag-speak naming the launch; a 1-rank mesh, or
    every rank of a 1-process world, is the single device."""
    _, pol = pair
    for mesh in (2, MeshSpec(4)):
        with pytest.raises(ValueError, match="ranks, but this process group has 1: start "):
            DegradeManager(pol, mesh=mesh, engine_kwargs=CPU)
    for mesh in (MeshSpec(1), MeshSpec(None)):
        with DegradeManager(pol, mesh=mesh, engine_kwargs=CPU) as mgr:
            assert mgr.engine.mesh is None and mgr.stats()["mesh_devices"] == 1
            assert mgr.role == "front"
    mgr.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        mgr.submit(0, np.ones((1, 1), np.float32))


def test_degrade_drill_record(pair):
    _, pol = pair
    drill = _degrade_drill(pol, degrade_at=3, n_requests=8, survivors=None, mesh=None,
                           seed=0, device="cpu")
    assert drill["devices_before"] == drill["devices_after"] == 1
    assert drill["mttr_ms"] > 0 and drill["replayed"] >= 1
    assert drill["failed_during_window"] == 0
    assert drill["rebuild_xla_compiles"] == 0 and drill["post_recovery_bitwise_equal"]
    with pytest.raises(ValueError, match="outside the request stream"):
        _degrade_drill(pol, degrade_at=8, n_requests=8, survivors=None, mesh=None, seed=0,
                       device="cpu")


# -- four gloo ranks -----------------------------------------------------------

#: the buckets of the sets the mesh bundle ships (each rank captures each one)
MESH_BUCKETS = (1, 8, 16, 64)
#: request sizes through the 4-rank set (each lands in one of its buckets)
AOT_SIZES = (1, 7, 9, 33, 64)
SCENARIOS = {
    # the reference's healthy -> loss -> recovered requests, one at a time
    "request": {"requests": 3, "loss_at": 1, "survivors": 3, "sync": True},
    "block": {"requests": 0, "block_rows": 16, "block_loss": True, "survivors": 3},
    "persistent": {"requests": 2, "loss_at": 0, "survivors": 3, "sync": True,
                   "loss_budget": 1000, "replay_timeout_s": 0.2},
    "clean": {"requests": 3, "block_rows": 16, "hard_wall_ms": 5000.0},
    # a burst the batcher coalesces by timing, the loss under request 5
    "burst": {"requests": 32, "loss_at": 5, "survivors": 3, "block_rows": 64, "seed": 3},
}


@pytest.fixture(scope="module")
def mesh_bundle(pair, tmp_path_factory):
    """The pair's policy as a bundle shipping the CPU's 4- and 2-rank sets."""
    _, pol = pair
    d = tmp_path_factory.mktemp("mesh_bundle") / "b"
    export_bundle(pol, d)
    export_aot(d, load_bundle(d), buckets=MESH_BUCKETS, meshes=(4, 2), device="cpu")
    return d


@pytest.fixture(scope="module")
def mesh_run(mesh_bundle, tmp_path_factory):
    """Every scenario on four ranks, one launch: rank 0's records by name, and
    each rank's whole result."""
    res = ranks_tool.launch(4, {"stand_in": True, "aot": {
        "bundle": str(mesh_bundle), "sizes": list(AOT_SIZES)}, "degrade": {
        "bundle": str(mesh_bundle), "scenarios": list(SCENARIOS.values())}},
        tmp_path_factory.mktemp("ranks"), timeout=240)
    return dict(zip(SCENARIOS, res[0]["degrade"])), res


def _n2_buckets(bundle, topo="cpu-cpu-n2") -> list[int]:
    import json

    index = json.loads((bundle / "aot" / "aot.json").read_text())
    tdir = bundle / "aot" / index["topologies"][topo]["dir"]
    return sorted(int(b) for b in json.loads((tdir / "aot.json").read_text())["buckets"])


def test_each_rank_serves_its_shard_from_the_four_rank_set(mesh_run, mesh_bundle):
    """Each of 4 ranks loads the bundle's 4-rank set (0 ``nvcc`` runs, 0
    fallbacks, one capture a bucket of its shard's forward) and serves every
    size through it, the gather outside the graph, bitwise the unsharded and
    the eager mesh engines."""
    _, res = mesh_run
    n4 = _n2_buckets(mesh_bundle, "cpu-cpu-n4")
    for x in res:
        a = x["aot"]
        assert a["topology"] == "cpu-cpu-n4" and "covered" in a["status"]
        assert a["nvcc"] == 0 and a["captures"] == len(n4)
        assert a["fallbacks"] == {"capture": 0, "set": 0}
        assert a["cache_info"]["aot_buckets"] == n4
        assert a["cache_info"]["aot_hits"] == len(AOT_SIZES)
        assert all(a["equal"].values()) and all(a["equal_eager_mesh"].values())


def _jax_close(jpol, date, states, prices, got) -> None:
    want = JHedgeEngine(jpol).evaluate(date, states, prices)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_mesh_loss_rebuilds_on_two_ranks_bitwise_and_matches_jax(pair, mesh_run, mesh_bundle):
    """``survivors=3`` on 4 ranks: the lost request is replayed (never failed)
    on the first 2 ranks, rebuilt from the bundle's 2-rank set with 0 ``nvcc``
    runs and one capture per bucket; healthy, replayed and recovered answers
    are bitwise rank 0's single-device engine and within ``TOL`` of JAX's; the
    counters are the reference's, emitted by rank 0."""
    jpol, _ = pair
    rec, res = mesh_run
    r = rec["request"]
    st = r["stats"]
    assert r["injected"] == ["serve/dispatch"] and r["failed"] == 0 and all(r["bitwise"])
    assert set(st) == STATS_KEYS and st["mesh_devices"] == 2 and not st["recovering"]
    [rc] = st["recoveries"]
    assert RECOVERY_KEYS <= set(rc) and "rebuild_graph_captures" in rc
    assert (rc["from_devices"], rc["to_devices"], rc["survivors_reported"]) == (4, 2, 3)
    assert rc["replayed"] == 1 and rc["replay_unresolved"] == 0 and rc["mttr_ms"] > 0
    n2 = _n2_buckets(mesh_bundle)
    assert rc["rebuild_xla_compiles"] == 0 and rc["rebuild_graph_captures"] == len(n2)
    assert rc["aot_buckets"] == n2
    assert r["counters"] == {"guard/device_loss{survivors=3}": 1,
                             "guard/topology_rebuild{from_devices=4,to_devices=2}": 1}
    for i, got in enumerate(r["got"]):
        _jax_close(jpol, i % 5, r["states"][i:i + 1], r["prices"][i:i + 1], got)
    # rank 1 rebuilt beside rank 0 from the same set; ranks 2 and 3 stood down
    parts = [x["degrade"][0] for x in res[1:]]
    assert [p["role"] for p in parts] == ["follower", "stood_down", "stood_down"]
    assert parts[0]["rebuilds"] == [{"to_devices": 2, "nvcc": 0, "captures": len(n2),
                                     "aot_buckets": n2}]
    assert all(p["mesh_devices"] == 2 and p["role_at_start"] == "follower" for p in parts)


def test_mesh_block_loss_replays_the_whole_block(pair, mesh_run):
    """The block lane: the WHOLE block is trapped and replayed as one block on
    2 ranks; healthy, replayed and recovered blocks serve every row, bitwise
    the single-device engine and within ``TOL`` of JAX's."""
    rec, _ = mesh_run
    b = rec["block"]
    assert b["injected"] == ["serve/dispatch"] and b["stats"]["mesh_devices"] == 2
    [rc] = b["stats"]["recoveries"]
    assert rc["replayed"] == 1 and rc["replay_unresolved"] == 0 and rc["to_devices"] == 2
    assert b["counters"]["guard/device_loss{survivors=3}"] == 1
    for k in ("healthy", "replayed", "recovered"):
        assert b["blocks"][k]["n_served"] == 16 and b["blocks"][k]["bitwise"], k
    jpol, _ = pair
    want = JHedgeEngine(jpol).evaluate(1, *b["block_inputs"])[:2]
    for got, w in zip((b["blocks"]["replayed"]["phi"], b["blocks"]["replayed"]["psi"]), want):
        np.testing.assert_allclose(got, np.asarray(w), **TOL)


def test_mesh_persistent_loss_is_bounded(mesh_run):
    """Every replay re-traps: ``replay_timeout_s`` bounds the loop, the request
    fails with the reference's words, and the manager answers again on the
    degraded mesh, bitwise, once the plan is gone."""
    rec, _ = mesh_run
    p = rec["persistent"]
    assert "replay window" in p["loss_error"] and p["failed"] == 1
    assert p["bitwise"] == [False, True] and p["stats"]["mesh_devices"] == 2
    assert not p["stats"]["recovering"] and p["stats"]["pending_replay"] == 0


def test_mesh_clean_path_emits_no_guard_event(mesh_run):
    rec, res = mesh_run
    c = rec["clean"]
    assert c["guard_events"] == [] and c["counters"] == {} and c["stats"]["recoveries"] == []
    assert c["stats"]["mesh_devices"] == 4 and all(c["bitwise"]) and c["failed"] == 0
    assert all(b["bitwise"] for b in c["blocks"].values())
    assert [x["degrade"][3]["role"] for x in res[1:]] == ["follower"] * 3


def test_submit_on_a_follower_raises_naming_rank_0(mesh_run):
    _, res = mesh_run
    for x in res[1:]:
        for part in x["degrade"]:
            assert part["refusal"].startswith(f"DegradeManager.submit on rank {x['rank']} ")
            assert "call submit on rank 0" in part["refusal"]


def test_mesh_burst_with_a_loss_replays_with_no_failure(mesh_run):
    """32 requests the batcher coalesces by timing, the loss under request 5
    and 64-row blocks before and after: 0 failed, every answer bitwise, and
    no rank launched a kernel (the mesh path runs none)."""
    rec, res = mesh_run
    b = rec["burst"]
    assert b["failed"] == 0 and all(b["bitwise"]) and b["stats"]["mesh_devices"] == 2
    [rc] = b["stats"]["recoveries"]
    assert rc["replayed"] >= 1 and rc["replay_unresolved"] == 0
    assert all(v["bitwise"] and v["n_served"] == 64 for v in b["blocks"].values())
    assert all(v == 0 for x in res for v in x["kernel_launches"].values())
