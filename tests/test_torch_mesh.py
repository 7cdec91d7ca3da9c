"""The paths mesh of the port (``orp_tpu_torch/parallel/``) on the CPU.

- the topology helpers (``MeshSpec``, ``spec_of``, ``pad_to_mesh``,
  ``largest_submesh``, ``topology_fingerprint``, the divisibility error) held
  to ``orp_tpu.parallel.mesh``;
- 2-, 3- and 4-rank ``gloo`` groups, one process a rank
  (``tools/torch_mesh_ranks.launch``: a ``FileStore`` under ``tmp_path``, a
  hard timeout, every rank killed when one fails), at the JAX package's mesh
  test size (``tests/test_mesh_native.py``: 512 paths, ``dt=1/8``,
  ``rebalance_every=2``, 4 dates; 513 on 3 ranks, which must divide it), in
  float64: GN and Adam walks in ``mse_only`` and ``separate`` hold ``v0_cv``
  within ``rtol=1e-5`` of the single-process port and the network ``v0``
  within 10% (the reference test's bands), each rank holding ``n / ranks``
  ledger rows; the sharded engine bitwise the whole one per bucket; exact
  thinning's shards bitwise one run; a checkpoint written on 2 ranks resumed
  by one process; one rank's NaN-poisoned shard taking the same rung on every
  rank; the reference's refusals.

The ranks import ``torch`` and the port only; JAX runs in this process. Each
launch runs every job of its rank count once (a module-scoped cache), so the
file costs three launches and a kill-and-resume.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orp_tpu.parallel import mesh as jmesh
from orp_tpu_torch.api import european_hedge
from orp_tpu_torch.parallel import (MeshSpec, initialize_multihost, largest_submesh, make_mesh,
                                    pad_to_mesh, path_indices, shard_paths, spec_of,
                                    topology_fingerprint)
from orp_tpu_torch.parallel.mesh import _check_divisible, path_gather, path_mean, path_sum
from orp_tpu_torch.sde import TimeGrid, simulate_pension
from orp_tpu_torch.serve.engine import next_bucket

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
                                               ROOT / "tools" / "torch_mesh_ranks.py")
ranks_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks_tool)

WORLDS = (2, 3, 4)
PENSION = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=1e4)
SIZES = (1, 7, 8, 33, 64, 9)
WALKS = [(opt, mode) for opt in ("gauss_newton", "adam") for mode in ("mse_only", "separate")]


def _n_paths(world: int) -> int:
    return 513 if world == 3 else 512


def _walk_spec(world: int, optimizer: str, dual_mode: str, **train) -> dict:
    """The reference's mesh test configuration (``test_mesh_native.py:92-123``) in float64."""
    return {"euro": {"constrain_self_financing": False},
            "sim": {"n_paths": _n_paths(world), "T": 1.0, "dt": 1 / 8, "rebalance_every": 2,
                    "dtype": "float64"},
            "train": dict(dual_mode=dual_mode, optimizer=optimizer, epochs_first=12,
                          epochs_warm=6, batch_size=512, gn_iters_first=6, gn_iters_warm=3,
                          lr=1e-3, shuffle="blocks", **train)}


def _engine_spec() -> dict:
    return {"sim": {"n_paths": 256, "T": 1.0, "dt": 1 / 8, "rebalance_every": 2},
            "train": {"dual_mode": "mse_only", "optimizer": "gauss_newton", "gn_iters_first": 3,
                      "gn_iters_warm": 2}, "sizes": list(SIZES)}


def _pension_spec(world: int) -> dict:
    return {"n_paths": 96 * world, "T": 2.0, "n_steps": 24,
            "kw": dict(PENSION, store_every=4, binomial_mode="exact", seed=5)}


def _jobs(world: int) -> dict:
    jobs = {"walks": [_walk_spec(world, o, m) for o, m in WALKS], "engine": _engine_spec(),
            "pension": _pension_spec(world), "refusals": _walk_spec(world, *WALKS[0])}
    if world == 2:
        # the fused walk (uncaptured on the CPU) and the guard's ladder
        jobs["walks"].append(_walk_spec(world, "gauss_newton", "separate", fused=True))
        jobs["guard"] = dict(_walk_spec(world, "gauss_newton", "mse_only", nan_guard=True),
                             nan_dates=[1], poison_rank=1, seed=3)
    return jobs


_RESULTS: dict = {}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    def get(world: int) -> list[dict]:
        if world not in _RESULTS:
            _RESULTS[world] = ranks_tool.launch(world, _jobs(world),
                                                tmp_path_factory.mktemp(f"ranks{world}"),
                                                timeout=240)
        return _RESULTS[world]
    return get


_SINGLE: dict = {}


def _single(spec: dict):
    key = repr(spec)
    if key not in _SINGLE:
        _SINGLE[key] = european_hedge(*ranks_tool._configs(spec), device="cpu")
    return _SINGLE[key]


# -- topology helpers vs the JAX package ---------------------------------------


def test_meshspec_flags_and_normalisation():
    assert MeshSpec.from_flag(None) is None and MeshSpec.from_flag(0) is None
    assert MeshSpec.from_flag("4") == MeshSpec(n_devices=4)
    assert spec_of(3) == MeshSpec(3) and spec_of(MeshSpec(2)) == MeshSpec(2)
    assert spec_of(None) is None
    assert hash(MeshSpec(2)) == hash(MeshSpec(2, "paths"))
    with pytest.raises(ValueError, match="need >= 1"):
        MeshSpec(n_devices=0)
    with pytest.raises(TypeError):
        spec_of("x")
    for n in (1, 8, 9, 16, 17):
        for d in (None, 3, MeshSpec(4)):
            jd = d if d is None or isinstance(d, int) else jmesh.MeshSpec(d.n_devices)
            assert pad_to_mesh(n, d) == jmesh.pad_to_mesh(n, jd)


@pytest.mark.parametrize("n_alive", range(1, 18))
def test_largest_submesh_matches_the_reference(n_alive):
    got, want = largest_submesh(n_alive), jmesh.largest_submesh(n_alive)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.n_devices, got.axis) == (want.n_devices, want.axis)


def test_divisibility_error_and_fingerprint_in_the_references_words():
    with pytest.raises(ValueError) as got:
        _check_divisible(10, 3, "n_paths")
    with pytest.raises(ValueError) as want:
        jmesh._check_divisible(10, jmesh.make_mesh(3), "n_paths")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must be divisible by the mesh size 3"):
        _check_divisible(10, MeshSpec(3), "n_paths")
    assert topology_fingerprint() == jmesh.topology_fingerprint() == "cpu-cpu-n1"
    assert largest_submesh(1) is None
    with pytest.raises(ValueError, match="no devices"):
        largest_submesh(0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_a_specs_topology_is_spelled_without_a_group(n):
    """One process names every topology it exports: a ``MeshSpec`` or rank
    count is spelled as the JAX package spells the same spec, building no
    mesh (no group here)."""
    assert not dist.is_initialized()
    want = jmesh.topology_fingerprint(jmesh.MeshSpec(n))
    assert topology_fingerprint(MeshSpec(n), "cpu") == topology_fingerprint(n, "cpu") == want
    assert want == f"cpu-cpu-n{n}"


def test_one_rank_group_in_process(tmp_path):
    """A 1-rank ``gloo`` group: the mesh, its description, the collectives as
    identities, the mesh-free ``path_indices`` on the CPU, the multihost no-op."""
    info = initialize_multihost()
    assert info == {"process_index": 0, "process_count": 1, "local_device_count": 1,
                    "global_device_count": 1}
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("paths",) and mesh.size() == 1
        assert MeshSpec().describe(device="cpu") == {
            "axis": "paths", "n_devices": 1, "mesh_shape": [1], "platform": "cpu",
            "device_kind": "cpu"}
        assert topology_fingerprint(mesh) == "cpu-cpu-n1"
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            make_mesh(2, device="cpu")
        x = torch.arange(6.0)
        for fn in (path_sum, path_gather):
            assert torch.equal(fn(x, mesh), x)
        assert torch.equal(path_mean(x.mean(), mesh), x.mean())
        assert torch.equal(path_indices(8, mesh), torch.arange(8))
        tree = {"a": torch.arange(4), "b": [torch.ones(4, 2)]}
        assert torch.equal(shard_paths(tree, mesh)["b"][0], tree["b"][0])
        assert shard_paths(tree, None) is tree
    finally:
        dist.destroy_process_group()
    assert torch.equal(path_indices(5, device="cpu"), torch.arange(5))


# -- the sharded walk ------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("optimizer,dual_mode", WALKS)
def test_sharded_walk_holds_the_cv_price(launched, world, optimizer, dual_mode):
    """Every rank reports the same prices: ``v0_cv`` within ``rtol=1e-5`` of
    the single-process port and the network ``v0`` within 10%, and each rank
    holds its ``n / ranks`` rows of the ledgers."""
    res = launched(world)
    i = WALKS.index((optimizer, dual_mode))
    ref = _single(_walk_spec(world, optimizer, dual_mode))
    n = _n_paths(world)
    for r in res:
        w = r["walks"][i]
        assert r["mesh_size"] == world
        assert w["values"].shape == (n // world, ref.backward.values.shape[1])
        assert w["phi"].shape[0] == n // world
        assert np.isfinite(w["values"].numpy()).all()
        for k in ("v0_cv", "v0_acv", "v0", "v0_plain"):
            assert w[k] == res[0]["walks"][i][k], k  # replicated
        np.testing.assert_array_equal(w["var_overall"], res[0]["walks"][i]["var_overall"])
    w = res[0]["walks"][i]
    np.testing.assert_allclose(w["v0_cv"], ref.report.v0_cv, rtol=1e-5)
    np.testing.assert_allclose(w["v0"], ref.v0, rtol=0.10)
    # the gathered ledger is the single-process walk's, to the walk's band
    values = np.concatenate([r["walks"][i]["values"].numpy() for r in res])
    np.testing.assert_allclose(values[:, -1], ref.backward.values[:, -1].numpy(), rtol=1e-12)


def test_fused_walk_on_a_cpu_mesh_equals_its_host_loop(launched):
    """``fused=True`` on a 2-rank CPU mesh (no capture on the CPU) trains what
    the mesh's host loop trains, as on one device."""
    res = launched(2)
    host, fused = res[0]["walks"][WALKS.index(("gauss_newton", "separate"))], res[0]["walks"][-1]
    assert fused["v0_cv"] == host["v0_cv"] and fused["v0"] == host["v0"]
    assert torch.equal(fused["values"], host["values"])


# -- the sharded engine -----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_engine_bitwise_per_bucket(launched, world):
    for r in launched(world):
        eng = r["engine"]
        assert eng["cache_info"]["mesh_devices"] == world
        for n in SIZES:
            assert eng["equal"][n], (world, n)
            assert eng["rows"][n] == n
            assert eng["buckets"][n] == pad_to_mesh(next_bucket(n), world)
        assert eng["mixed_refusal"] == ("mixed-date megakernel serves single-device engines; "
                                        "mesh engines keep the per-date bucketed path")


def test_bucket_rounding_on_three_ranks(launched):
    """16 rounds up to a multiple of 3 (``tests/test_mesh_native.py:145-166``)."""
    eng = launched(3)[0]["engine"]
    assert eng["buckets"][9] == 18 and eng["buckets"][1] == 9 and eng["rows"][9] == 9


# -- exact thinning, refusals, the guard, checkpoints ------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_exact_thinning_is_one_run(launched, world):
    """Each rank draws its paths' deaths by their global indices: the blocks,
    concatenated in rank order, are one process's run bitwise."""
    spec = _pension_spec(world)
    res = launched(world)
    full = simulate_pension(torch.arange(spec["n_paths"]), TimeGrid(spec["T"], spec["n_steps"]),
                            **spec["kw"])["N"]
    assert [r["pension"]["first_index"] for r in res] == [96 * r for r in range(world)]
    assert torch.equal(torch.cat([r["pension"]["N"] for r in res]), full)


@pytest.mark.parametrize("world", WORLDS)
def test_pallas_refused_with_a_mesh(launched, world):
    want = "european_hedge: engine='pallas' is single-chip; use engine='scan' with a mesh"
    assert all(r["refusals"]["pallas"] == want for r in launched(world))


def test_poisoned_shard_takes_the_same_rung_on_every_rank(launched):
    """Rank 1's fit target NaN-poisoned at one date: the ranks' summed finite
    flag sends every rank down the same rung at the same date, and the walk
    ends finite, its ``v0_cv`` within 1% of the clean walk's."""
    res = launched(2)
    rungs = [r["guard"]["rungs"] for r in res]
    assert rungs[0] and rungs[0] == rungs[1]
    assert res[0]["guard"]["v0_cv"] == res[1]["guard"]["v0_cv"]
    clean = _single(_walk_spec(2, "gauss_newton", "mse_only"))
    np.testing.assert_allclose(res[0]["guard"]["v0_cv"], clean.report.v0_cv, rtol=1e-2)


def test_checkpoint_on_two_ranks_resumes_on_one(tmp_path):
    """The fingerprint leaves the mesh out: a walk killed on 2 ranks after
    step 1 resumes in one process without a mesh, within the band of the
    uninterrupted single-process walk."""
    ckpt = tmp_path / "ckpt"
    spec = _walk_spec(2, "gauss_newton", "mse_only", checkpoint_dir=str(ckpt))
    res = ranks_tool.launch(2, {"kill": dict(spec, kill_after_step=1)}, tmp_path / "ranks",
                            timeout=120)
    assert all(r["kill"]["killed"] for r in res)
    assert sorted(p.name for p in ckpt.glob("orp_step_*.npz")) == ["orp_step_0.npz",
                                                                    "orp_step_1.npz"]
    resumed = european_hedge(*ranks_tool._configs(spec), device="cpu")
    ref = _single(_walk_spec(2, "gauss_newton", "mse_only"))
    np.testing.assert_allclose(resumed.report.v0_cv, ref.report.v0_cv, rtol=1e-5)
    np.testing.assert_allclose(resumed.v0, ref.v0, rtol=0.10)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in the walk's first collective: the
    launch raises at once and kills rank 0 rather than hang."""
    spec = _walk_spec(2, "gauss_newton", "mse_only")
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        ranks_tool.launch(2, {"fail_rank": 1, "walks": [spec]}, tmp_path, timeout=60)
