"""The port's topology degradation (``orp_tpu_torch/guard/degrade.py``) on the
CPU: a device loss injected under a request or a block traps it, rebuilds the
engine and replays it with 0 failed requests, bitwise the healthy engine, with
the reference's ``stats()`` and recovery-record keys; a persistent loss is
bounded; the clean path emits nothing; a mesh of more than one rank is
refused; the served values match the JAX package's ``HedgeEngine`` at
``tests/test_torch_serve.py``'s tolerance; and ``serve/bench._degrade_drill``'s
record."""

import numpy as np
import pytest
import torch

from orp_tpu.serve.engine import HedgeEngine as JHedgeEngine
from orp_tpu_torch import guard, obs
from orp_tpu_torch.guard import DegradeManager, DeviceLostError, FaultPlan, GuardPolicy
from orp_tpu_torch.obs.sink import ListSink
from orp_tpu_torch.parallel import MeshSpec
from orp_tpu_torch.serve import HedgeEngine
from orp_tpu_torch.serve.bench import _degrade_drill

from test_torch_serve import TOL, _pair, _rows

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
    _, pol = pair
    for mesh in (2, MeshSpec(4), MeshSpec(None)):
        with pytest.raises(ValueError, match="one process sees"):
            DegradeManager(pol, mesh=mesh, engine_kwargs=CPU)
    with DegradeManager(pol, mesh=MeshSpec(1), engine_kwargs=CPU) as mgr:
        assert mgr.engine.mesh is None and mgr.stats()["mesh_devices"] == 1
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
