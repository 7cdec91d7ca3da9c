"""The port's command line (``orp_tpu_torch/cli.py``) on the CPU (``--device cpu``).

- Parser parity: both ``build_parser()``s have the same 25 commands, option
  strings, ``choices``, ``nargs``, ``required`` flags, consts and defaults,
  but for the written table of intended differences below (:data:`DIFFERENCES`
  and the root ``--device``).
- The reference's CLI tests, ported: config conflicts in flag-speak,
  ``--resume``, the ``--mesh`` flag-speak, a one-rank ``gloo`` ``euro --mesh 1``
  bitwise no mesh and a two-rank ``torchrun``-style run (one process a rank,
  rank 0 alone prints), two-rank ``serve-bench --mesh 2`` (its batcher
  phases mirrored from rank 0) and its degradation drill, ``export --aot
  --aot-mesh`` and ``doctor --mesh``, ``--telemetry``, ``report``, ``trace``, ``top``,
  ``store``, ``pilot``, ``lint``, ``doctor`` against a live and a closed
  endpoint, ``serve-gateway``'s ready file and drain, ``serve-bench --quick``,
  ``profile --quick``, and the refusals: no default names a file of the
  checkout (``BENCH_serve.json``, the root ``PERF_LEDGER.jsonl``,
  ``.jax_cache``), the root ledger is refused in flag-speak, the card-only
  pieces refuse ``--device cpu``, and a command without a card or ``--device
  cpu`` raises.
- Where both packages read the same input (a store, a journal, an
  ``events.jsonl``), ``store``, ``trace``, ``report`` and ``pilot status``
  print the same text and JSON as the reference's.

The JSON lines of the compute commands are held to the reference's and to the
port's API in ``tests/test_torch_cli_parity.py``.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from orp_tpu import cli as jcli
from orp_tpu_torch import NORTH_STAR_POLICY, obs
from orp_tpu_torch import cli as tcli

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
EURO = ["euro", "--paths", "256", "--steps", "8", "--rebalance-every", "2", "--optimizer",
        "gauss_newton", "--gn-iters-first", "6", "--gn-iters-warm", "3", "--json"]

# (command, option): (the reference's values, the port's) of the fields that differ;
# none of the port's defaults names a file of the checkout
DIFFERENCES = {
    ("serve-bench", "--out"): ({"default": "BENCH_serve.json", "required": False},
                               {"default": None, "required": True}),
    ("perf-gate", "--ledger"): ({"default": "PERF_LEDGER.jsonl", "required": False},
                                {"default": None, "required": True}),
    ("doctor", "--perf"): ({"nargs": "?", "const": "PERF_LEDGER.jsonl"},
                           {"nargs": None, "const": None}),
}
# the same parser fields, another meaning: `serve-bench --ledger` and `profile --ledger`
# default to no ledger (the reference: PERF_LEDGER.jsonl for a non-quick run), and
# `warm --cache-dir` to aot.cache.resolve_cache_dir() (the reference: .jax_cache)
SAME_FIELDS_OTHER_MEANING = {("serve-bench", "--ledger"), ("profile", "--ledger"),
                             ("warm", "--cache-dir")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tests (the suite's workers share
    the machine; the subprocess runs get ``OMP_NUM_THREADS=1`` to match)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A bundle the port's ``export`` wrote (256 paths, 2 dates, GN)."""
    out = tmp_path_factory.mktemp("exported") / "bundle"
    line = _json(tcli.main, [*CPU, "export", "--pipeline", "euro", "--out", str(out),
                             "--paths", "256", "--steps", "4", "--rebalance-every", "2",
                             "--optimizer", "gauss_newton", "--gn-iters-first", "4",
                             "--gn-iters-warm", "2", "--json"])[0]
    assert line["n_dates"] == 2 and line["out"] == str(out)
    return out


def _sha(path: pathlib.Path) -> str | None:
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


@pytest.fixture
def checkout_files_untouched():
    """The checkout's record files keep their bytes through the test."""
    files = [ROOT / "PERF_LEDGER.jsonl", ROOT / "BENCH_serve.json"]
    before = [_sha(f) for f in files]
    yield
    assert [_sha(f) for f in files] == before
    assert not (ROOT / "orp_tpu_torch" / ".jax_cache").exists()


def _run(main, argv, capsys=None) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _json(main, argv):
    return [json.loads(x) for x in _run(main, argv).strip().splitlines()]


# -- parser parity ---------------------------------------------------------------


def _fields(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        out[a.option_strings[0] if a.option_strings else a.dest] = {
            "option_strings": tuple(a.option_strings), "dest": a.dest,
            "choices": None if a.choices is None else list(a.choices), "nargs": a.nargs,
            "required": a.required, "default": a.default, "const": a.const,
            "type": getattr(a.type, "__name__", a.type), "action": type(a).__name__}
    return out


def _commands(parser) -> dict:
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def test_parsers_match_but_for_the_written_differences():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert tp.prog == "orp_tpu_torch"
    jroot, troot = _fields(jp), _fields(tp)
    assert troot.pop("--device") == {
        "option_strings": ("--device",), "dest": "device", "choices": ["cuda", "cpu"],
        "nargs": None, "required": False, "default": "cuda", "const": None, "type": None,
        "action": "_StoreAction"}
    assert troot == jroot
    jcmds, tcmds = _commands(jp), _commands(tp)
    assert list(tcmds) == list(jcmds) and len(tcmds) == 25
    seen = set()
    for name, jsub in jcmds.items():
        want, got = _fields(jsub), _fields(tcmds[name])
        assert list(got) == list(want), name
        for opt, w in want.items():
            if (name, opt) in DIFFERENCES:
                ref, port = DIFFERENCES[name, opt]
                assert {k: w[k] for k in ref} == ref, (name, opt)
                assert {k: got[opt][k] for k in port} == port, (name, opt)
                w = {**w, **port}
                seen.add((name, opt))
            assert got[opt] == w, (name, opt)
    assert seen == set(DIFFERENCES)
    assert all(opt in _fields(tcmds[name]) for name, opt in SAME_FIELDS_OTHER_MEANING)


def test_unknown_command_and_missing_card():
    with pytest.raises(SystemExit):
        tcli.main(["nope"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(EURO)


# -- the reference's CLI tests, ported ---------------------------------------------


def test_train_config_conflicts_map_to_flagspeak():
    parser = tcli.build_parser()
    args = parser.parse_args(["euro", "--fused", "--checkpoint-dir", "ck"])
    with pytest.raises(SystemExit) as exc:
        tcli._train_cfg(args, "mse_only")
    msg = str(exc.value)
    assert msg.startswith("error: ")
    assert "--fused" in msg and "--checkpoint-dir/--resume" in msg
    assert "fused=True" not in msg and "checkpoint_dir" not in msg
    args = parser.parse_args(["euro", "--fused", "--nan-guard"])
    with pytest.raises(SystemExit, match="NaN sentinel") as exc:
        tcli._train_cfg(args, "mse_only")
    assert "--fused" in str(exc.value)


def test_resume_flag(tmp_path):
    from orp_tpu_torch.utils.checkpoint import save_checkpoint

    parser = tcli.build_parser()
    args = parser.parse_args(["euro", "--resume", str(tmp_path / "nope")])
    with pytest.raises(SystemExit, match="no per-date checkpoints"):
        tcli._train_cfg(args, "mse_only")
    d = tmp_path / "ck"
    d.mkdir()
    save_checkpoint(d, 0, {"x": torch.ones(2)})
    cfg = tcli._train_cfg(parser.parse_args(["euro", "--resume", str(d)]), "mse_only")
    assert cfg.checkpoint_dir == str(d)
    args = parser.parse_args(["euro", "--resume", str(d), "--checkpoint-dir",
                              str(tmp_path / "other")])
    with pytest.raises(SystemExit, match="different"):
        tcli._train_cfg(args, "mse_only")
    cfg = tcli._train_cfg(parser.parse_args(["euro", "--nan-guard", "--nan-retries", "1"]),
                          "mse_only")
    assert cfg.nan_guard and cfg.nan_retries == 1


def test_mesh_flags_speak_torchrun():
    """An N-rank mesh is N processes: without torchrun's variables ``--mesh N>1``
    names the launch; the topology errors name the flag (the reference's
    ``tests/test_mesh_native.py:286-300``)."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2 -m orp_tpu_torch.cli"):
        tcli.main([*CPU, *EURO, "--mesh", "2"])
    with pytest.raises(SystemExit) as exc:
        tcli.main([*CPU, "serve-bench", "--bundle", "/nonexistent", "--out", "", "--mesh",
                   "16"])
    assert "--mesh 16" in str(exc.value)
    with pytest.raises(SystemExit) as exc:
        tcli.main([*CPU, "serve-bench", "--bundle", "/nonexistent", "--out", "",
                   "--mesh-sweep", "1,16"])
    assert "--mesh-sweep 16" in str(exc.value)
    import torch.distributed as dist

    assert not dist.is_initialized()  # no group was formed for a refused mesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_procs(argv, world: int = 1, timeout: float = 240.0):
    """``python -m orp_tpu_torch.cli`` in ``world`` processes (torchrun's
    variables when ``world > 1``); each one's ``(rc, stdout, stderr)``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    port = _free_port()
    procs = []
    for r in range(world):
        e = dict(env)
        if world > 1:
            e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", "orp_tpu_torch.cli", *argv],
                                      env=e, cwd=str(ROOT), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            p.kill()
    return out


def test_euro_mesh_one_rank_and_two_ranks():
    """``euro --mesh 1`` forms a one-rank ``gloo`` group in its process and prints
    the no-mesh line bitwise; two ranks under torchrun's variables: the
    divisibility error keeps the reference's words, and rank 0 alone prints."""
    (rc, plain, err), = _cli_procs([*CPU, *EURO])
    assert rc == 0, err
    (rc, meshed, err), = _cli_procs([*CPU, *EURO, "--mesh", "1"])
    assert rc == 0, err
    assert json.loads(meshed) == json.loads(plain)
    bad = _cli_procs([*CPU, *[a if a != "256" else "257" for a in EURO], "--mesh", "2"], 2)
    for rc, _, err in bad:
        assert rc == 1 and "--paths 257 is not divisible by --mesh 2" in err and "258" in err
    runs = _cli_procs([*CPU, *EURO, "--mesh", "2"], 2)
    assert [rc for rc, _, _ in runs] == [0, 0], runs[0][2][-2000:] + runs[1][2][-2000:]
    line = json.loads(runs[0][1])
    assert runs[1][1] == "" and np.isfinite(line["v0"]) and np.isfinite(line["v0_cv"])


#: serve-bench at the CLI test's quick size, with the batcher phases (a burst and a
#: concurrent sweep) that coalesce requests by timing
QUICK_BENCH = ["serve-bench", "--bundle", str(NORTH_STAR_POLICY), "--quick", "--requests", "8",
               "--batcher-requests", "64", "--sweep-concurrency", "4", "--sweep-requests",
               "256", "--repeats", "2"]


def test_serve_bench_two_ranks_mirror_rank_0s_batcher(tmp_path):
    """``serve-bench --quick --mesh 2`` on two ranks: each rank's batcher used to
    coalesce the same stream by its own timing, so the two ranks' gathers met
    at different sizes (``gloo`` aborted in 2 of 6 runs) or different
    requests. Rank 0 now drives every phase and the other rank mirrors its
    engine's dispatches; both exit 0, rank 0 alone prints and writes."""
    out = tmp_path / "r.json"
    runs = _cli_procs([*CPU, *QUICK_BENCH, "--mesh", "2", "--out", str(out)], 2)
    assert [rc for rc, _, _ in runs] == [0, 0], runs[0][2][-2000:] + runs[1][2][-2000:]
    rec = json.loads(runs[0][1])
    assert runs[1][1] == "" and json.loads(out.read_text()) == rec
    assert rec["mesh_devices"] == 2 and rec["batcher_requests"] == 64
    assert rec["sweep"][0]["concurrency"] == 4 and rec["sweep"][0]["requests"] == 256


def test_serve_bench_two_ranks_degrade_drill(tmp_path):
    """``serve-bench --quick --mesh 2 --degrade-at 3`` on two ranks: the loss
    leaves 1 survivor, rank 0 rebuilds alone (rank 1 stands down), the drill
    fails no request and serves the single-device engine's bits after it."""
    runs = _cli_procs([*CPU, *QUICK_BENCH[:-6], "--sweep-concurrency", "", "--mesh", "2",
                       "--degrade-at", "3", "--degrade-requests", "8", "--out", ""], 2)
    assert [rc for rc, _, _ in runs] == [0, 0], runs[0][2][-2000:] + runs[1][2][-2000:]
    drill = json.loads(runs[0][1])["degrade"]
    assert runs[1][1] == ""
    assert drill["devices_before"] == 2 and drill["devices_after"] == 1
    assert drill["failed_during_window"] == 0 and drill["post_recovery_bitwise_equal"]
    assert drill["replayed"] >= 1 and drill["rebuild_xla_compiles"] == 0


def test_export_aot_mesh_sets(tmp_path):
    """``export --aot --aot-mesh 4,2,1``: the single-device set is card-only, so
    ``--device cpu`` refuses it before training; the meshes' sets need no card
    and no group, and ``--aot-mesh 4,2`` writes their index here, spelled as
    the reference's; ``doctor --mesh 4`` reads that topology's set."""
    train = ["--paths", "64", "--steps", "4", "--rebalance-every", "2", "--epochs-first", "2",
             "--epochs-warm", "1", "--batch-size", "64", "--json"]
    with pytest.raises(SystemExit, match="no --device cpu form"):
        tcli.main([*CPU, "export", "--out", str(tmp_path / "a"), "--aot", "--aot-mesh", "4,2,1",
                   *train])
    assert not (tmp_path / "a").exists()
    out = _json(tcli.main, [*CPU, "export", "--out", str(tmp_path / "b"), "--aot", "--aot-mesh",
                            "4,2", "--aot-buckets", "1,8,100", *train])[0]
    assert out["aot_topologies"] == ["cpu-cpu-n2", "cpu-cpu-n4"]
    assert out["aot_buckets"] == [8, 128] and out["aot_compile_wall_s"] == 0.0
    index = json.loads((tmp_path / "b" / "aot" / "aot.json").read_text())
    assert {k: v["n_devices"] for k, v in index["topologies"].items()} == {
        "cpu-cpu-n2": 2, "cpu-cpu-n4": 4}
    buf = io.StringIO()
    # exit 1 all the same: the reference's devices check wants 4 visible devices
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        tcli.main([*CPU, "doctor", "--bundle", str(tmp_path / "b"), "--mesh", "4", "--json"])
    rep = json.loads(buf.getvalue())
    [row] = [c for c in rep["checks"] if c["check"] == "bundle_aot"]
    assert row["ok"] and "'cpu-cpu-n4' covered (buckets [8, 128])" in row["detail"]


def test_telemetry_flag_drops_bundle_and_report_reads_it(tmp_path):
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig

    tdir = tmp_path / "t"
    out = _run(tcli.main, [*CPU, "euro", "--paths", "128", "--steps", "4",
                           "--rebalance-every", "1", "--T", "0.5", "--epochs-first", "4",
                           "--epochs-warm", "2", "--batch-size", "128", "--json",
                           "--telemetry", str(tdir)])
    json.loads(out.strip().splitlines()[-1])
    for name in ("events.jsonl", "metrics.prom", "manifest.json", "flight.jsonl"):
        assert (tdir / name).exists(), name
    events = obs.read_events(tdir / "events.jsonl")
    assert events and all(obs.validate_event(e) == [] for e in events)
    man = obs.read_manifest(tdir)
    assert man["cli_command"] == "euro"
    assert man["run_fingerprint"] == obs.config_fingerprint(
        EuropeanConfig(), SimConfig(n_paths=128, T=0.5, dt=0.125, rebalance_every=1),
        TrainConfig(dual_mode="mse_only", epochs_first=4, epochs_warm=2, batch_size=128),
        "quantile_method=sort")
    assert not obs.enabled()
    # `report` prints the same text and JSON in both packages
    for extra in ([], ["--json"]):
        argv = ["report", "--events", str(tdir), *extra]
        assert _run(tcli.main, argv) == _run(jcli.main, argv)
    rec = _json(tcli.main, ["report", "--events", str(tdir), "--json"])[0]
    assert rec["n_dates"] == 4 and len(rec["rungs"]) == 4
    with pytest.raises(SystemExit, match="error: "):
        tcli.main(["report", "--events", str(tmp_path / "missing")])


def _gateway_session(tmp_path, kick):
    """``serve-gateway`` of the committed north star on the main thread (its
    signal handlers live); ``kick(addr, port)`` runs on a thread once the ready
    file exists, then SIGTERMs this process."""
    ready, tel = tmp_path / "gw.addr", tmp_path / "gw-t"
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    errors, result = [], {}

    def kicker():
        try:
            deadline = time.perf_counter() + 60
            while not ready.exists() and time.perf_counter() < deadline:
                time.sleep(0.02)
            assert ready.exists(), "serve-gateway never wrote its ready file"
            addr, port = ready.read_text().split()
            result.update(kick(addr, int(port)) or {})
        except BaseException as e:  # noqa: BLE001 -- re-raised on the test's thread
            errors.append(e)
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=kicker, daemon=True)
    t.start()
    try:
        out = _run(tcli.main, [*CPU, "serve-gateway", "--bundle", str(NORTH_STAR_POLICY),
                               "--port", "0", "--ready-file", str(ready), "--max-seconds",
                               "120", "--telemetry", str(tel), "--json"])
    finally:
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])
    t.join(30)
    if errors:
        raise errors[0]
    assert not ready.exists()  # the drain removed the ready file
    start = json.loads(out.strip().splitlines()[0])
    assert start["tenant"] == "default" and start["bundle"] == str(NORTH_STAR_POLICY)
    return tel, result


def test_serve_gateway_ready_file_drain_top_doctor_trace(tmp_path):
    """The gateway serves bitwise the tenant's engine; ``top`` returns one
    snapshot; ``doctor --gateway`` is ok live and fails in flag-speak once the
    endpoint is closed; SIGTERM drains (every row sent served, the ready file
    gone); ``trace`` of a stamped frame prints the same chain in both packages."""
    from orp_tpu_torch.serve import HedgeEngine, ResilientGatewayClient, load_bundle

    engine = HedgeEngine(load_bundle(NORTH_STAR_POLICY), device="cpu")
    tid = obs.new_trace()
    rng = np.random.default_rng(3)

    def kick(addr, port):
        sent = served = 0
        with ResilientGatewayClient(addr, port, window=4, timeout_s=60.0) as c:
            for i, n in enumerate((1, 64, 1000)):
                states = (1.0 + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
                d = 7 * i + 3
                r = c.submit_block("default", d, states, trace=tid if n == 64 else None)
                want = engine.evaluate(d, states)
                assert np.array_equal(r.phi, want[0]) and np.array_equal(r.psi, want[1])
                sent, served = sent + n, served + int((r.status == 0).sum())
        snap = _json(tcli.main, ["top", "--gateway", f"{addr}:{port}", "--interval", "0.1",
                                 "--json"])
        doc = _json(tcli.main, [*CPU, "doctor", "--gateway", f"{addr}:{port}", "--json"])[0]
        return {"sent": sent, "served": served, "snap": snap, "doc": doc,
                "target": f"{addr}:{port}"}

    tel, res = _gateway_session(tmp_path, kick)
    assert res["served"] == res["sent"] == 1065
    assert len(res["snap"]) == 1 and isinstance(res["snap"][0], dict)
    assert res["doc"]["ok"], res["doc"]
    with pytest.raises(SystemExit) as exc:
        tcli.main([*CPU, "doctor", "--gateway", res["target"], "--gateway-timeout-s", "2",
                   "--json"])
    assert exc.value.code == 1
    argv = ["trace", obs.trace_hex(tid[0]), "--events", str(tel)]
    tr = _json(tcli.main, [*argv, "--json"])[0]
    assert [k.split("/")[-1] for k in tr["segments"]][:5] == [
        "decode", "queue", "dispatch", "resolve", "encode"]
    for extra in ([], ["--json"]):
        assert _run(tcli.main, [*argv, *extra]) == _run(jcli.main, [*argv, *extra])
    with pytest.raises(SystemExit, match="not a trace id"):
        tcli.main(["trace", "xyz", "--events", str(tel)])


def test_store_put_stat_gc_read_alike(tmp_path, exported):
    root = tmp_path / "store"
    put = _json(tcli.main, ["store", "put", "--root", str(root), "--bundle", str(exported),
                            "--tenants", "a,b", "--json"])[0]
    assert set(put["published"]) == {"a", "b"} and put["stats"]["dedup_ratio"] > 1
    for argv in (["store", "stat", "--root", str(root)],
                 ["store", "gc", "--root", str(root), "--dry-run"]):
        for extra in ([], ["--json"]):
            assert _run(tcli.main, [*argv, *extra]) == _run(jcli.main, [*argv, *extra])
    with pytest.raises(SystemExit, match="--tenants"):
        tcli.main(["store", "put", "--root", str(root), "--bundle", str(exported)])


def test_pilot_retrain_and_status_read_alike(tmp_path):
    j = tmp_path / "pilot.jsonl"
    with pytest.raises(SystemExit, match="does not exist"):
        tcli.main(["pilot", "status", "--journal", str(j)])
    filed = _json(tcli.main, ["pilot", "retrain", "--journal", str(j), "--tenant", "desk",
                              "--reason", "vol regime", "--json"])[0]
    assert filed["filed"] and filed["tenant"] == "desk" and filed["seq"] >= 0
    for extra in ([], ["--json"]):
        argv = ["pilot", "status", "--journal", str(j), *extra]
        assert _run(tcli.main, argv) == _run(jcli.main, argv)
    st = _json(tcli.main, ["pilot", "status", "--journal", str(j), "--json"])[0]
    assert st["last_cycle"] is None and st["pending_requests"][0]["tenant"] == "desk"


def test_lint_clean_port_and_exit_codes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert "clean" in _run(tcli.main, ["lint"])  # the port's package, from any cwd
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nX = torch.zeros(3, dtype=torch.float64)\n")
    with pytest.raises(SystemExit) as e:
        _run(tcli.main, ["lint", "--json", str(bad)])
    assert e.value.code == 1
    for argv in (["lint", "--select", "ORP999", str(bad)], ["lint", str(tmp_path / "no.py")]):
        with pytest.raises(SystemExit) as e:
            _run(tcli.main, argv)
        assert e.value.code == 2


def test_doctor_json_and_failure_exit(tmp_path):
    rep = _json(tcli.main, [*CPU, "doctor", "--telemetry-dir", str(tmp_path / "obs"),
                            "--json"])[0]
    assert rep["ok"] and {c["check"] for c in rep["checks"]} >= {
        "devices", "compile_cache", "telemetry_sink"}
    with pytest.raises(SystemExit) as e:
        _run(tcli.main, [*CPU, "doctor", "--bundle", str(tmp_path / "nope"), "--json"])
    assert e.value.code == 1


def test_serve_bench_quick_writes_only_where_told(tmp_path, monkeypatch,
                                                  checkout_files_untouched):
    from orp_tpu_torch.obs import perf

    monkeypatch.chdir(ROOT)
    out = tmp_path / "bench" / "r.json"
    out.parent.mkdir()
    rec = _json(tcli.main, [*CPU, "serve-bench", "--bundle", str(NORTH_STAR_POLICY),
                            "--quick", "--requests", "8", "--batcher-requests", "8",
                            "--sweep-concurrency", "1", "--sweep-requests", "64", "--repeats",
                            "2", "--out", str(out), "--ledger", "l.jsonl"])[0]
    assert json.loads(out.read_text()) == rec
    rows, problems = perf.read_ledger(out.parent / "l.jsonl")  # beside --out
    assert rows and not problems
    with pytest.raises(SystemExit, match="--ledger PERF_LEDGER.jsonl: refusing"):
        tcli.main([*CPU, "serve-bench", "--bundle", str(NORTH_STAR_POLICY), "--quick",
                   "--out", "", "--ledger", "PERF_LEDGER.jsonl"])
    with pytest.raises(SystemExit) as e:  # --out has no default
        tcli.main([*CPU, "serve-bench", "--bundle", str(NORTH_STAR_POLICY)])
    assert e.value.code == 2


def test_profile_quick_and_perf_gate_refusals(tmp_path, monkeypatch, checkout_files_untouched):
    monkeypatch.chdir(ROOT)
    out = _json(tcli.main, [*CPU, "profile", "--workload", "serve", "--bundle",
                            str(NORTH_STAR_POLICY), "--quick", "--json"])[0]
    assert out["workload"] == "serve" and out["buckets"]
    ledger = tmp_path / "l.jsonl"
    _run(tcli.main, [*CPU, "profile", "--workload", "serve", "--bundle",
                     str(NORTH_STAR_POLICY), "--quick", "--ledger", str(ledger)])
    assert ledger.exists()
    for argv in (["profile", "--quick", "--ledger", "PERF_LEDGER.jsonl"],
                 ["perf-gate", "--ledger", "PERF_LEDGER.jsonl"],
                 ["perf-gate", "--ledger", str(ROOT / "PERF_LEDGER.jsonl")]):
        with pytest.raises(SystemExit, match="refusing"):
            tcli.main([*CPU, *argv])
    with pytest.raises(SystemExit) as e:  # --ledger has no default
        tcli.main([*CPU, "perf-gate"])
    assert e.value.code == 2
    gate = [*CPU, "perf-gate", "--ledger", str(tmp_path / "g.jsonl"), "--bundle",
            str(NORTH_STAR_POLICY), "--repeats", "4", "--evals", "4", "--rows", "16", "--json"]
    first = _json(tcli.main, gate)[0]
    assert first["verdict"] == "no_history" and first["ok"]  # the baseline seeded


def test_card_only_pieces_refuse_the_cpu(tmp_path):
    from orp_tpu_torch.aot import cache

    with pytest.raises(SystemExit, match="no --device cpu form"):
        tcli.main([*CPU, "warm", "--paths", "256"])
    with pytest.raises(SystemExit, match="no --device cpu form"):
        tcli.main([*CPU, "export", "--out", str(tmp_path / "b"), "--aot", "--paths", "64"])
    assert not (tmp_path / "b").exists()  # refused before training
    with pytest.raises(SystemExit, match="no --device cpu form"):
        tcli.main([*CPU, "profile", "--quick", "--trace-dir", str(tmp_path / "tr")])
    with pytest.raises(SystemExit) as e:  # --perf takes a path
        tcli.main([*CPU, "doctor", "--perf"])
    assert e.value.code == 2
    # warm's default cache: the build directory, never the JAX package's .jax_cache
    d = cache.resolve_cache_dir()
    assert d is None or ".jax_cache" not in str(d)


def test_calibrate_needs_a_source():
    with pytest.raises(SystemExit, match="--prices"):
        tcli.main(["calibrate"])
