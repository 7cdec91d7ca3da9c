"""The port stands alone: ``orp_tpu_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package, and the port's entry points refuse to run quietly on
the CPU when no card is present.

Note the prefix: ``orp_tpu_torch`` starts with ``orp_tpu``, so "imports the JAX
package" means ``name == "orp_tpu" or name.startswith("orp_tpu.")``."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "orp_tpu_torch"


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name.startswith("jaxlib")
            or name == "orp_tpu" or name.startswith("orp_tpu.")
            or name == "orbax" or name.startswith("orbax."))  # orbax imports JAX


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "torch_profile_paths.py",
                                         ROOT / "tools" / "torch_walk_spread.py",
                                         ROOT / "tools" / "torch_kernel_digest.py",
                                         ROOT / "tools" / "torch_warp_census.py",
                                         ROOT / "tools" / "torch_adam_walk.py",
                                         ROOT / "tools" / "torch_fused_walk.py",
                                         ROOT / "tools" / "torch_mesh_ranks.py",
                                         ROOT / "tools" / "torch_mesh_probe.py",
                                         ROOT / "tools" / "torch_host_phase.py",
                                         ROOT / "tools" / "torch_gateway_phase.py",
                                         ROOT / "tools" / "torch_aot_child.py",
                                         ROOT / "tools" / "torch_aot_phase.py",
                                         ROOT / "tools" / "torch_pilot_phase.py"]


def test_prefix_rule():
    assert _is_forbidden("orp_tpu") and _is_forbidden("orp_tpu.qmc.sobol")
    assert not _is_forbidden("orp_tpu_torch") and not _is_forbidden("orp_tpu_torch.qmc")
    assert _is_forbidden("jax.numpy") and not _is_forbidden("jaxtyping")
    assert _is_forbidden("orbax.checkpoint") and not _is_forbidden("orbaxish")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _is_forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    """... nor pandas or matplotlib, which the card's machine lacks (``to_frames``
    and ``risk/plots.py`` import them inside the call)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import orp_tpu_torch\n"
        "for m in pkgutil.walk_packages(orp_tpu_torch.__path__, 'orp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'orp_tpu' or n.startswith('orp_tpu.')\n"
        "       or n.split('.')[0] in ('pandas', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('orp_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 28  # every module was imported


def test_sources_include_the_parallel_package():
    """The import rule walks every module of ``parallel/`` (the paths mesh)."""
    names = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {"parallel/mesh.py", "parallel/multihost.py", "parallel/quantiles.py",
            "utils/threefry.py"} <= names


def test_sources_include_the_obs_package():
    """The import rule walks every module of ``obs/`` (the telemetry spine),
    host-only ones included: the port keeps its own copy of each."""
    names = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {f"obs/{m}.py" for m in ("__init__", "registry", "sink", "spans", "manifest",
                                    "flight", "report", "tracetree", "devprof")} <= names


def test_sources_include_the_compile_and_perf_plane():
    """The import rule walks the AOT plane, the perf ledger, degradation and the
    host QMC engine."""
    names = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {"aot/__init__.py", "aot/cache.py", "aot/compile.py", "aot/bundle_exec.py",
            "obs/perf.py", "guard/degrade.py", "native/__init__.py"} <= names
    assert ROOT / "tools" / "torch_aot_child.py" in _sources()


def test_sources_include_the_serve_path():
    """The import rule walks every module of the single-host serve path: the
    host-only ones are the port's own copies."""
    names = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {"guard/serve.py", "guard/cooldown.py", "serve/metrics.py", "serve/ingest.py",
            "serve/wire.py", "serve/ragged.py", "serve/health.py", "serve/batcher.py",
            "serve/host.py", "store/__init__.py", "store/tier.py", "obs/quality.py"} <= names


def test_sources_include_the_pilot_and_lint_planes():
    """The import rule walks every module of ``pilot/`` and ``lint/``, the
    doctor's ``serve/health.py`` and the [pilot] phase's tool: the port keeps
    its own copy of each, host-only ones included."""
    names = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {f"pilot/{m}.py" for m in ("__init__", "calibrate", "controller", "journal",
                                      "triggers")} <= names
    assert {f"lint/{m}.py" for m in ("__init__", "__main__", "engine", "rules", "concurrency",
                                     "lock_audit", "trace_audit")} <= names
    assert "serve/health.py" in names
    assert ROOT / "tools" / "torch_pilot_phase.py" in _sources()


def test_doctor_report_and_the_lint_load_no_jax():
    """``doctor_report`` (every probe it runs without a socket) and the lint
    CLI run in a process that never imports JAX or the JAX package."""
    code = (
        "import sys, tempfile\n"
        "from orp_tpu_torch.serve.health import doctor_report\n"
        "from orp_tpu_torch.lint.__main__ import main\n"
        "d = tempfile.mkdtemp()\n"
        "rep = doctor_report(perf=d + '/led.jsonl', pilot=d + '/pilot.jsonl', device='cpu')\n"
        "assert [c['check'] for c in rep['checks']][-1] == 'lint_concurrency', rep\n"
        "assert main(['--select', 'ORP009', 'orp_tpu_torch/pilot']) == 0\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'orp_tpu' or n.startswith('orp_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_entry_points_default_to_the_card():
    """Without ``device=`` an entry point means the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from orp_tpu_torch import HESTON_WALK, NORTH_STAR_POLICY, PENSION_WALK
    from orp_tpu_torch.api import (HedgeRunConfig, SimConfig, TrainConfig, basket_hedge,
                                   basket_oos, european_hedge, european_oos, heston_hedge,
                                   heston_oos, pension_hedge, pension_oos)
    from orp_tpu_torch.qmc import (brownian, gbm_log_fused, heston_log_fused, heston_qe_fused,
                                   pension_fused, sobol_normal_matrix)
    from orp_tpu_torch.risk import (asian_call_qmc, basket_greeks, digital_greeks,
                                    down_and_out_call_qmc, european_greeks, heston_greeks,
                                    heston_price_surface, lookback_call_qmc,
                                    lookback_floating_qmc, price_surface)
    from orp_tpu_torch.train import bermudan_lsm, bermudan_lsm_heston
    from orp_tpu_torch.sde import TimeGrid, simulate_gbm_arithmetic, simulate_gbm_basket
    from orp_tpu_torch.obs.quality import ValidationSpec, evaluate_quality
    from orp_tpu_torch.serve import HedgeEngine, MicroBatcher, ServeHost, load_bundle

    policy = load_bundle(NORTH_STAR_POLICY)
    host = ServeHost()
    host.add_tenant("t", policy)
    sim = SimConfig(n_paths=64, T=1.0, dt=0.25, rebalance_every=1)
    train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    heston = dict(s0=1.0, mu=0.0, v0=0.04, kappa=1.0, theta=0.04, xi=0.3, rho=-0.5, dt=0.1)
    basket = dict(s0=[1.0, 1.0], drift=[0.0, 0.0], sigma=[0.1, 0.2],
                  corr=[[1.0, 0.3], [0.3, 1.0]])
    from orp_tpu_torch.guard import DegradeManager
    from orp_tpu_torch.obs.devprof import profile_north_star
    from orp_tpu_torch.serve.bench import _pilot_phase, serve_bench

    calls = [lambda: HedgeEngine(policy), lambda: european_oos(policy),
             lambda: serve_bench(policy, n_requests=2, sweep_concurrency=()),
             lambda: _pilot_phase(quick=True, seed=0),
             lambda: profile_north_star(6, quick=True),
             lambda: DegradeManager(policy),
             lambda: MicroBatcher(HedgeEngine(policy)),
             lambda: host.evaluate("t", 0, np.ones((1, 1), np.float32)),
             lambda: host.prefetch(["t"]),
             lambda: evaluate_quality(policy, ValidationSpec(n_steps=364, rebalance_every=7)),
             lambda: gbm_log_fused(128, 8, s0=1.0, drift=0.0, sigma=0.1, dt=0.1),
             lambda: european_hedge(sim=sim, train=train),
             lambda: heston_hedge(sim=sim, train=train),
             lambda: heston_oos(load_bundle(HESTON_WALK)),
             lambda: heston_qe_fused(128, 8, **heston),
             lambda: heston_log_fused(128, 8, **heston),
             lambda: pension_hedge(HedgeRunConfig(sim=sim, train=train)),
             lambda: pension_oos(load_bundle(PENSION_WALK)),
             lambda: pension_fused(128, 8, y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075,
                                   eta=0.000597, n0=1e4, dt=0.25),
             lambda: basket_hedge(sim=sim, train=train),
             lambda: basket_oos(policy, sim=sim, train=train),
             lambda: sobol_normal_matrix(3, 2),
             lambda: simulate_gbm_basket(np.arange(8), TimeGrid(1.0, 4), **basket),
             lambda: simulate_gbm_arithmetic(np.arange(8), TimeGrid(1.0, 4), 1.0, 0.08, 0.15),
             lambda: brownian.get_dW(torch.Generator(), 8),
             lambda: brownian.get_W(torch.Generator(), 8),
             lambda: brownian.get_dW_sobol(np.arange(8), 4),
             lambda: brownian.get_W_sobol(np.arange(8), 4),
             lambda: european_greeks(64, 100.0, 100.0, 0.08, 0.15, 1.0, n_steps=4),
             lambda: digital_greeks(64, 100.0, 100.0, 0.08, 0.15, 1.0, n_steps=4),
             lambda: heston_greeks(64, 100.0, 100.0, 0.08, 1.0, v0=0.04, kappa=1.0, theta=0.04,
                                   xi=0.3, rho=-0.5, n_steps=4),
             lambda: basket_greeks(64, s0=[100.0, 100.0], weights=[0.5, 0.5], strike=100.0,
                                   r=0.08, sigma=[0.1, 0.2], corr=[[1.0, 0.3], [0.3, 1.0]],
                                   T=1.0, n_steps=4),
             lambda: asian_call_qmc(64, 100.0, 100.0, 0.08, 0.15, 1.0, n_avg=2, steps_per_avg=2),
             lambda: down_and_out_call_qmc(64, 100.0, 100.0, 90.0, 0.08, 0.25, 1.0, n_monitor=4),
             lambda: lookback_call_qmc(64, 100.0, 110.0, 0.08, 0.25, 1.0, n_monitor=4),
             lambda: lookback_floating_qmc(64, 100.0, 0.08, 0.25, 1.0, n_monitor=4),
             lambda: price_surface(64, 100.0, 0.08, 0.15, [100.0], 1.0, n_maturities=2,
                                   steps_per_maturity=2),
             lambda: heston_price_surface(64, 100.0, 0.08, [100.0], 1.0, v0=0.04, kappa=1.0,
                                          theta=0.04, xi=0.3, rho=-0.5, n_maturities=2,
                                          steps_per_maturity=2),
             lambda: bermudan_lsm(64, 36.0, 40.0, 0.06, 0.2, 1.0, n_exercise=4),
             lambda: bermudan_lsm_heston(64, 36.0, 40.0, 0.06, 1.0, v0=0.04, kappa=1.0,
                                         theta=0.04, xi=0.3, rho=-0.5, n_exercise=4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the command line: the card by default (raises here, in flag-speak naming the
    # root option), the CPU with --device cpu
    from orp_tpu_torch import cli
    euro_argv = ["euro", "--paths", "64", "--steps", "4", "--rebalance-every", "2",
                 "--optimizer", "gauss_newton", "--gn-iters-first", "2", "--gn-iters-warm", "1",
                 "--json"]
    with pytest.raises(SystemExit, match="device='cpu'.*--device cpu"):
        cli.main(euro_argv)
    cli.main(["--device", "cpu", *euro_argv])
    # an AOT set is CUDA graphs and sm_90a libraries: without a card it refuses
    from orp_tpu_torch.aot import AotUnsupported, export_aot
    with pytest.raises(AotUnsupported, match="needs a CUDA device"):
        export_aot(ROOT / "nowhere", policy)
    assert not (ROOT / "nowhere").exists()
    # the paths mesh: path indices, a rank's device, and the mesh entry points
    # (under a 1-rank group, so that building the mesh reaches its device)
    import tempfile

    import torch.distributed as dist

    from orp_tpu_torch.parallel import MeshSpec, make_mesh, path_indices
    from orp_tpu_torch.parallel.mesh import rank_device
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0)
        try:
            for call in (lambda: path_indices(8), rank_device, make_mesh,
                         lambda: path_indices(8, mesh=1), lambda: MeshSpec(1).describe(),
                         lambda: european_hedge(sim=sim, train=train, mesh=1),
                         lambda: pension_hedge(HedgeRunConfig(sim=sim, train=train), mesh=1),
                         lambda: HedgeEngine(policy, mesh=1)):
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    call()
            assert path_indices(8, mesh=make_mesh(device="cpu")).device.type == "cpu"
        finally:
            dist.destroy_process_group()
    host.close()
    assert HedgeEngine(policy, device="cpu").device.type == "cpu"
    assert simulate_gbm_basket(np.arange(8), TimeGrid(1.0, 4), **basket,
                               device="cpu").shape == (8, 5, 2)
    assert brownian.get_W_sobol(np.arange(8), 4, device="cpu").device.type == "cpu"
    assert brownian.get_dW(torch.Generator(), 8, device="cpu").shape == (8,)
    assert price_surface(64, 100.0, 0.08, 0.15, [100.0], 1.0, n_maturities=2,
                         steps_per_maturity=2, device="cpu")["prices"].device.type == "cpu"
    assert bermudan_lsm(64, 36.0, 40.0, 0.06, 0.2, 1.0, n_exercise=4, device="cpu")["n_paths"] == 64


def test_chip_smoke_refuses_without_card_and_alone(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line with no card,
    and in a directory holding nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
