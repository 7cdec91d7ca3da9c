"""The port's bundle plane on the CPU (``orp_tpu_torch/store/{cas,catalog}.py``,
``export_bundle(store=, tenant=)`` and ``store://`` loads), held against the
JAX package's.

The store only hashes and copies files, and its documents are canonical JSON
with no clock or random field, so one bundle directory published by either
package must give byte-identical blobs, manifests and ``catalog.json``: held
here for a port export and for the committed north-star policy (given its
run fingerprint, without which both packages refuse to publish). A
``store://`` load is bitwise a directory load, and a tenant served from a
``store://`` source is bitwise one served from the directory."""

import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from orp_tpu.store import CasIntegrityError as JCasIntegrityError
from orp_tpu.store import CasStore as JCasStore
from orp_tpu.store import open_store as jopen_store
from orp_tpu.store import parse_store_uri as jparse_store_uri
from orp_tpu_torch import NORTH_STAR_POLICY
from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
from orp_tpu_torch.serve import HedgeEngine, ServeHost, export_bundle, load_bundle
from orp_tpu_torch.serve.fleet import ReplicaSpec, RoutingTable
from orp_tpu_torch.store import (COLD, HOT, WARM, CasIntegrityError, CasStore, TierManager,
                                 blob_digest, open_store, parse_store_uri, prefetch_assigned)
from orp_tpu_torch.utils.fingerprint import policy_fingerprint, write_fingerprint

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    sim = SimConfig(n_paths=256, T=1.0, dt=1 / 8, rebalance_every=2)  # 4 dates
    train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=3,
                        gn_iters_warm=2)
    return european_hedge(EuropeanConfig(), sim, train, device="cpu")


@pytest.fixture(scope="module")
def bundles(trained, tmp_path_factory):
    """A port export, and the committed north star with its run fingerprint."""
    root = tmp_path_factory.mktemp("bundles")
    export_bundle(trained, root / "export")
    ns = root / "north_star"
    shutil.copytree(NORTH_STAR_POLICY, ns)
    pol = load_bundle(ns)
    write_fingerprint(ns, policy_fingerprint(
        pol.model, pol.n_dates, dual_mode=pol.dual_mode,
        holdings_combine=pol.holdings_combine, cost_of_capital=pol.cost_of_capital))
    return {"export": root / "export", "north_star": ns}


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _params_equal(a, b):
    pa, pb = a.backward.params1_by_date, b.backward.params1_by_date
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _feats(n, nf, seed=7):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.1 * rng.standard_normal((n, nf))).astype(np.float32)


# -- CAS ------------------------------------------------------------------------


def test_cas_put_get_roundtrip_idempotent(tmp_path):
    cas = CasStore(tmp_path / "store")
    data = b"the policy bytes"
    digest = cas.put(data)
    assert digest == blob_digest(data)
    assert cas.put(data) == digest
    assert cas.has(digest) and cas.get(digest) == data
    assert cas.size_of(digest) == len(data)
    assert cas.stats() == {"blobs": 1, "bytes": len(data)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cas_refuses_tampered_blob_in_both_packages(tmp_path, pkg):
    """A blob written by one package and tampered with is refused by both."""
    writer = CasStore(tmp_path / "s") if pkg == "port" else JCasStore(tmp_path / "s")
    digest = writer.put(b"original bytes")
    blob = writer._blob_path(digest)
    blob.chmod(0o644)
    blob.write_bytes(b"tampered bytes!")
    with pytest.raises(CasIntegrityError, match="does not hash"):
        CasStore(tmp_path / "s").get(digest)
    with pytest.raises(JCasIntegrityError, match="does not hash"):
        JCasStore(tmp_path / "s").get(digest)
    with pytest.raises(KeyError, match="re-publish"):
        CasStore(tmp_path / "s").get("0" * 64)


def test_cas_concurrent_put_idempotent(tmp_path):
    cas = CasStore(tmp_path / "store")
    data = b"x" * 4096
    with ThreadPoolExecutor(max_workers=16) as pool:
        digests = list(pool.map(lambda _: cas.put(data), range(16)))
    assert set(digests) == {blob_digest(data)}
    assert cas.stats() == {"blobs": 1, "bytes": len(data)}


def test_cas_gc_never_collects_referenced(tmp_path):
    cas = CasStore(tmp_path / "store")
    kept, doomed = cas.put(b"referenced"), cas.put(b"orphan")
    dry = cas.gc({kept}, dry_run=True)
    assert dry["dry_run"] and dry["removed"] == 1 and cas.has(doomed)
    out = cas.gc({kept})
    assert out["removed"] == 1 and out["kept"] == 1
    assert cas.has(kept) and not cas.has(doomed)


# -- both packages, one directory ---------------------------------------------------


@pytest.mark.parametrize("which", ["export", "north_star"])
def test_both_packages_publish_byte_identical_stores(tmp_path, bundles, which):
    d = bundles[which]
    mine, ref = open_store(tmp_path / "port"), jopen_store(tmp_path / "jax")
    out = mine.publish_many(["alpha", "beta"], d)
    jout = ref.publish_many(["alpha", "beta"], d)
    assert out == jout
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert mine.referenced() == ref.referenced()
    assert mine.gc(dry_run=True) == ref.gc(dry_run=True)
    assert mine.stats() == ref.stats()
    assert mine.stats()["dedup_ratio"] > 1.0
    manifest = mine.resolve("alpha")
    assert manifest["aot_topologies"] == [] and manifest == ref.resolve("alpha")
    for uri in (f"store://{tmp_path}/port#alpha", f"store://{tmp_path}/a@b#t@3",
                "store:///x#y@z"):
        assert parse_store_uri(uri) == jparse_store_uri(uri)
    # a second version of one tenant and a removed tenant, in both
    for st in (mine, ref):
        st.remove("beta")
        assert st.gc(dry_run=True)["removed"] == 1  # beta's manifest only
    assert mine.gc() == ref.gc()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_both_packages_refuse_a_bundle_without_its_fingerprint(tmp_path):
    with pytest.raises(ValueError, match="not an exported bundle"):
        open_store(tmp_path / "a").publish("ns", NORTH_STAR_POLICY)
    with pytest.raises(ValueError, match="not an exported bundle"):
        jopen_store(tmp_path / "b").publish("ns", NORTH_STAR_POLICY)
    with pytest.raises(ValueError, match="malformed store URI"):
        parse_store_uri("store://no-fragment")


# -- store:// loads and serving ------------------------------------------------------


def test_store_uri_load_is_bitwise_a_directory_load(tmp_path, bundles):
    root = tmp_path / "store"
    open_store(root).publish_many(["alpha"], bundles["export"])
    via = load_bundle(f"store://{root}#alpha")
    direct = load_bundle(bundles["export"])
    _params_equal(via, direct)
    assert via.fingerprint == direct.fingerprint and via.fingerprint is not None
    assert via.feature_sketch == direct.feature_sketch
    assert load_bundle(f"store://{root}#alpha@1").n_dates == 4
    with pytest.raises(KeyError, match="versions 1..1"):
        load_bundle(f"store://{root}#alpha@2")


def test_export_bundle_publishes_into_store(tmp_path, trained):
    store = open_store(tmp_path / "store")
    pol = export_bundle(trained, tmp_path / "b2", store=store, tenant="pub")
    assert "pub" in store.tenants()
    export_bundle(trained, tmp_path / "b3", store=tmp_path / "store")  # the dir's name
    assert set(open_store(tmp_path / "store").tenants()) == {"pub", "b3"}
    _params_equal(load_bundle(f"store://{tmp_path / 'store'}#pub"), pol)


def test_store_tenants_serve_bitwise_through_the_tiers(tmp_path, bundles):
    """``ServeHost`` tenants from ``store://`` sources: cold, warm and hot
    activations serve bitwise what a directory-loaded engine serves; a removed
    tenant's gc frees its manifest and nothing the other tenant needs."""
    root = tmp_path / "store"
    store = open_store(root)
    store.publish_many(["a", "b"], bundles["export"])
    direct = HedgeEngine(load_bundle(bundles["export"]), device="cpu")
    feats = _feats(8, 1)
    want = direct.evaluate(1, feats)

    def bits(got):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    with ServeHost(max_live_engines=1, engine_kwargs=CPU, tiers=TierManager(max_warm=4)) as host:
        host.add_tenant("a", f"store://{root}#a")
        host.add_tenant("b", f"store://{root}#b")
        bits(host.evaluate("a", 1, feats))  # cold
        host.evaluate("b", 1, feats)  # evicts a to warm
        st = host.stats()
        assert st["a"]["tier"] == WARM and st["b"]["tier"] == HOT
        bits(host.evaluate("a", 1, feats))  # warm
        blk = host.submit_block("a", 1, feats).result(timeout=10.0)
        bits((blk.phi, blk.psi))
        assert host.stats()["a"]["activations"] == 2
    before = store.stats()
    store.remove("b")
    out = store.gc()
    assert out["removed"] == 1
    assert store.stats()["blobs"] == before["blobs"] - 1
    bits(HedgeEngine(load_bundle(f"store://{root}#a"), device="cpu").evaluate(1, feats))


def test_prefetch_assigned_warms_only_this_replicas_tenants(tmp_path, bundles):
    root = tmp_path / "store"
    names = [f"t{i}" for i in range(6)]
    open_store(root).publish_many(names, bundles["export"])
    table = RoutingTable([ReplicaSpec("r1", "127.0.0.1", 1), ReplicaSpec("r2", "127.0.0.1", 2)])
    mine = table.assigned(names, "r1")
    assert sorted(mine + table.assigned(names, "r2")) == sorted(names) and mine
    with ServeHost(max_live_engines=2, engine_kwargs=CPU) as host:
        for n in names:
            host.add_tenant(n, f"store://{root}#{n}")
        assert sorted(prefetch_assigned(host, table, names, "r1")) == sorted(mine)
        st = host.stats()
        for n in names:
            assert st[n]["tier"] == (WARM if n in mine else COLD) and not st[n]["live"]
