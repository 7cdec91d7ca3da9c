"""Command-line driver of the port: ``python -m orp_tpu_torch.cli [--device D] <command> [flags]``.

The counterpart of ``orp_tpu/cli.py``: the same 25 commands, flags, defaults,
exit codes, flag-speak errors and JSON lines (same keys, so a script that
reads the JAX package's lines reads these), run through this package's
modules. It imports ``torch``, ``numpy`` and ``orp_tpu_torch``, never JAX.

- ``euro``, ``heston``, ``pension``, ``sweep``, ``basket``: train a hedge
  (``api.*_hedge``; ``--oos-seed`` re-evaluates it on a fresh scramble with
  ``api.*_oos``; ``--export-dir`` writes a serve bundle). ``--engine pallas``
  simulates with the hand-written CUDA kernels: K1 (``euro``), K3b / K3a
  (``heston``, QE-M / ``--scheme euler``), K3c (``pension``, normal thinning)
- ``greeks``, ``asian``, ``barrier``, ``lookback``, ``surface``,
  ``bermudan``: the option analytics against their closed-form oracles
- ``calibrate``: CIR params from a price CSV (``--prices`` the pilot's
  rolling fit with RQMC-bootstrap bands)
- ``export`` (``--aot`` adds the bundle's AOT set: ``sm_90a`` libraries and
  per-bucket CUDA graphs, ``aot.export_aot``), ``warm`` (builds the fused
  walk's library into the kernel-build cache and times its graph captures)
- ``serve-bench``, ``serve-gateway`` (the ``orp-ingest`` TCP front;
  SIGTERM/SIGINT drain with zero rows lost), ``top``, ``doctor``, ``store``,
  ``trace``, ``report``, ``profile`` (``--trace-dir``: ``torch.profiler``),
  ``perf-gate``, ``lint`` (the port's analyzer over ``orp_tpu_torch/``),
  ``pilot``

The one option added to the parser is ``--device {cuda,cpu}`` (default
``cuda``), placed before the command: the counterpart of ``JAX_PLATFORMS=cpu``.
Without a card and without ``--device cpu`` a command that computes raises
(``utils.device.resolve_device``); no kernel gives way to its plain version
on a card. ``export --aot``, ``warm`` and ``profile --trace-dir`` need the
card and exit in flag-speak under ``--device cpu``.

``--mesh N`` is one process a rank (``parallel/mesh.py``): under ``torchrun
--nproc-per-node N -m orp_tpu_torch.cli ... --mesh N`` the ranks join one
``torch.distributed`` group (NCCL on the card, ``gloo`` under ``--device
cpu``) and rank 0 alone prints; without torchrun ``--mesh 1`` forms a
one-rank group in this process, and ``--mesh N>1`` exits naming torchrun.

Defaults that differ from ``orp_tpu.cli`` (none names a file of the
checkout):

- ``serve-bench --out`` is required (``''`` writes no record);
- ``perf-gate --ledger`` is required;
- ``serve-bench`` and ``profile`` append to a perf ledger only when
  ``--ledger`` names one (``obs.perf`` refuses the checkout's root ledger);
- ``doctor --perf`` takes a path (no default ledger);
- ``warm --cache-dir`` defaults to ``aot.cache.resolve_cache_dir()``
  (``ORP_TORCH_CACHE_DIR``, else the gitignored ``build/orp_tpu_torch/``).

``--telemetry DIR`` runs the command under an ``orp_tpu_torch.obs`` session
(``events.jsonl``, ``metrics.prom``, ``manifest.json`` with ``cli_command``,
``flight.jsonl``); off, the instrumentation costs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np


def _train_cfg(args, default_dual: str):
    from orp_tpu_torch.api import TrainConfig

    ckdir = args.checkpoint_dir
    resume = getattr(args, "resume", None)
    if resume is not None:
        # --resume DIR = continue an interrupted checkpointed walk: DIR must
        # actually hold per-date state (a typo'd path silently STARTING a
        # fresh run is exactly the failure --resume exists to rule out);
        # the run keeps checkpointing into the same DIR as it continues.
        # Resolve before comparing: './ck' and 'ck' are the same directory
        if (ckdir is not None
                and pathlib.Path(ckdir).resolve()
                != pathlib.Path(resume).resolve()):
            raise SystemExit(
                "error: --resume and --checkpoint-dir name different "
                "directories; --resume DIR both resumes from and keeps "
                "checkpointing into DIR (drop one of the flags)"
            )
        from orp_tpu_torch.utils.checkpoint import latest_step

        if latest_step(resume) is None:
            raise SystemExit(
                f"error: --resume {resume}: no per-date checkpoints found "
                "there — to start a fresh checkpointed run use "
                "--checkpoint-dir"
            )
        ckdir = resume
    try:
        return TrainConfig(
            epochs_first=args.epochs_first,
            epochs_warm=args.epochs_warm,
            batch_size=args.batch_size,
            dual_mode=args.dual_mode or default_dual,
            checkpoint_dir=ckdir,
            fused=args.fused,
            shuffle="blocks" if args.fused else True,
            final_solve=args.final_solve,
            optimizer=args.optimizer,
            gn_iters_first=args.gn_iters_first,
            gn_iters_warm=args.gn_iters_warm,
            gn_quantile=not args.adam_quantile,
            gn_block_rows=args.gn_block_rows,
            nan_guard=getattr(args, "nan_guard", False),
            nan_retries=getattr(args, "nan_retries", 2),
        )
    except ValueError as e:
        # config-conflict validation has ONE source of truth —
        # TrainConfig.__post_init__ (mirroring train.BackwardConfig); the
        # CLI only translates the config-field message into flag-speak
        # instead of duplicating the rules here and letting them drift
        raise SystemExit(f"error: {_flagspeak(str(e))}") from None


_FLAG_NAMES = (
    ("fused=True", "--fused"),
    ("fused=False", "no --fused"),
    ("per-date checkpointing", "--checkpoint-dir/--resume checkpointing"),
    ("checkpoint_dir", "--checkpoint-dir/--resume"),
    ("nan_guard", "--nan-guard"),
    ("nan_retries", "--nan-retries"),
)


def _flagspeak(msg: str) -> str:
    """Rephrase a TrainConfig ValueError's field names as CLI flags."""
    for field, flag in _FLAG_NAMES:
        msg = msg.replace(field, flag)
    return msg


def _add_train_flags(p):
    p.add_argument("--epochs-first", type=int, default=500)
    p.add_argument("--epochs-warm", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--dual-mode", choices=["separate", "shared", "mse_only"], default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist per-date state; rerun resumes automatically")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume an interrupted checkpointed walk from DIR "
                        "(must hold per-date state; refuses an empty dir — "
                        "use --checkpoint-dir to start one). The resumed "
                        "ledger is bitwise-equal to an uninterrupted run")
    p.add_argument("--nan-guard", action="store_true",
                   help="per-date NaN/Inf sentinel (orp_tpu_torch/guard): on a "
                        "non-finite loss/params, emit guard/nan_event and "
                        "retry that date one trainer rung down the ladder "
                        "adam->gauss_newton->final_solve instead of "
                        "corrupting every earlier date")
    p.add_argument("--nan-retries", type=int, default=2,
                   help="with --nan-guard: bounded ladder budget per date "
                        "(exhausted -> the walk raises)")
    p.add_argument("--fused", action="store_true",
                   help="the whole backward walk on the card with no host "
                        "read between dates (each LM iteration or Adam epoch "
                        "a CUDA graph; blocks shuffle; incompatible with "
                        "--checkpoint-dir)")
    p.add_argument("--final-solve", action="store_true",
                   help="closed-form shrunk readout after each MSE fit")
    p.add_argument("--optimizer", choices=["adam", "gauss_newton"], default="adam",
                   help="trainer: reference-semantics minibatch Adam, or "
                        "LM-damped full-batch Gauss-Newton (~10 big "
                        "path-shardable iterations/date — MSE leg plain GN, "
                        "quantile leg IRLS pinball unless --adam-quantile). "
                        "--gn-iters-first/--gn-iters-warm set the budget")
    p.add_argument("--gn-iters-first", type=int, default=30)
    p.add_argument("--gn-iters-warm", type=int, default=10)
    p.add_argument("--adam-quantile", action="store_true",
                   help="with --optimizer gauss_newton: keep the quantile "
                        "leg on Adam (reference semantics) instead of the "
                        "IRLS-GN pinball solver")
    p.add_argument("--gn-block-rows", type=int, default=None,
                   help="with --optimizer gauss_newton: accumulate the Gram "
                        "products over row blocks of this size (O(block*P) "
                        "fit memory)")
    p.add_argument("--json", action="store_true", help="emit a JSON result line")
    _add_telemetry_flag(p)


def _add_telemetry_flag(p):
    p.add_argument("--telemetry", default=None, metavar="DIR",
                   help="run under an orp_tpu_torch.obs telemetry session and "
                        "drop events.jsonl + metrics.prom + manifest.json in DIR "
                        "(spans, counters, run provenance; off = zero-cost)")


def _add_mesh_flag(p):
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="run over an N-rank ('paths',) mesh, one process a "
                        "rank (torchrun --nproc-per-node N; --mesh 1 forms a "
                        "one-rank group here): path-sharded simulation + "
                        "training over torch.distributed "
                        "(orp_tpu_torch/parallel); N must divide --paths")


def _device(args) -> str:
    """The command's device: ``--device`` checked by ``resolve_device`` (raises
    on ``cuda`` without a card; nothing falls back to the CPU)."""
    from orp_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (on the command line: --device cpu before "
                         "the command)") from None
    return args.device


def _need_card(args, what: str) -> None:
    """Fail a card-only piece in flag-speak under ``--device cpu``."""
    if args.device != "cuda":
        raise SystemExit(
            f"error: {what} captures CUDA graphs and builds sm_90a libraries on "
            f"the card; it has no --device {args.device} form (drop --device "
            f"{args.device})")
    _device(args)


def _torchrun_env() -> bool:
    import os

    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


#: set while a process group this command formed is alive (:func:`main` ends it)
_GROUP_FORMED: list = []


def _join_group(args, flag: str, n: int) -> None:
    """The process group an N-rank mesh needs: torchrun's (``env://``) when its
    variables are set, a one-rank group of this process for N == 1, else the
    flag-speak refusal that names torchrun."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if args.device == "cuda" else "gloo"
    if _torchrun_env():
        from orp_tpu_torch.parallel.multihost import initialize_multihost

        initialize_multihost(auto=True, backend=backend)
        _GROUP_FORMED.append(True)
    elif n == 1:
        import tempfile

        store = pathlib.Path(tempfile.mkdtemp(prefix="orp-cli-group-")) / "store"
        dist.init_process_group(backend, init_method=store.as_uri(), world_size=1, rank=0)
        _GROUP_FORMED.append(True)
    else:
        raise SystemExit(
            f"error: {flag} {n}: a mesh of {n} ranks is {n} processes in "
            f"orp_tpu_torch — launch it with `torchrun --nproc-per-node {n} -m "
            f"orp_tpu_torch.cli {args.command} ... {flag} {n}`")


def _build_mesh(args, n_paths: int):
    """The CLI's mesh gate: resolve ``--mesh N`` to a MeshSpec, failing in
    FLAG-speak before any simulation spend — the runtime layers would raise
    the same facts later (parallel/mesh.py hard-errors on non-divisible
    paths), but deep in a stack trace that never names the flag to fix."""
    if getattr(args, "mesh", None) is None:
        return None
    from orp_tpu_torch.parallel.mesh import MeshSpec, pad_to_mesh

    spec = MeshSpec.from_flag(args.mesh)
    if spec is None:
        return None
    _device(args)
    _join_group(args, "--mesh", args.mesh)
    try:
        mesh = spec.build(args.device)
    except ValueError as e:
        raise SystemExit(f"error: --mesh {args.mesh}: {e}") from None
    if n_paths % mesh.size():
        raise SystemExit(
            f"error: --paths {n_paths} is not divisible by --mesh "
            f"{args.mesh}; every shard must hold the same path count — "
            f"use --paths {pad_to_mesh(n_paths, mesh)} (the next multiple) "
            "or a mesh size that divides it"
        )
    return spec


def _rank0() -> bool:
    """Only rank 0 of a mesh prints (every rank runs the same program)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _print(text: str, **kw) -> None:
    if _rank0():
        print(text, **kw)


def _add_export_flag(p):
    p.add_argument("--export-dir", default=None,
                   help="after training, export the policy as a serve "
                        "bundle to this directory (load with "
                        "orp_tpu_torch.serve.load_bundle / serve-bench)")


def _add_oos_flag(p):
    # only on the four hedge commands with an *_oos counterpart (NOT sweep
    # or calibrate — the flag would be silently ignored there)
    p.add_argument("--oos-seed", type=int, default=None,
                   help="after training, re-evaluate the hedge on a fresh "
                        "Owen scramble with this seed (out-of-sample VaR / "
                        "residual P&L / prices)")


def _check_oos_seed(args, training_seed: int, field: str) -> None:
    """Fail the seed collision BEFORE the expensive sim+training run."""
    if args.oos_seed is not None and args.oos_seed == training_seed:
        raise SystemExit(
            f"error: --oos-seed {args.oos_seed} equals the training "
            f"{field} ({training_seed}) — those are the in-sample paths; "
            "pick a different seed"
        )


def _add_quantile_flag(p):
    # only on commands whose output carries VaR/fan quantiles (NOT sweep,
    # which reports phi/psi rows only — a flag there would be silently ignored)
    p.add_argument("--quantile-method", choices=["sort", "histogram"], default="sort",
                   help="VaR/fan quantile estimator: exact sharded sort, or the "
                        "two-pass histogram (O(bins) comms; for 1M+ paths)")


def _jsonable(x):
    """Tensors, arrays and numpy scalars as Python floats and lists (a 0-d
    tensor becomes a float), recursively through dicts, lists and tuples."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, np.ndarray | np.generic):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, list | tuple):
        return [_jsonable(v) for v in x]
    return x


def _host(x):
    """A tensor as a numpy array on the host, in its own dtype."""
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _dumps(obj) -> str:
    return json.dumps(_jsonable(obj))


def result_line(report, extra=None, prefix="") -> dict:
    """The JSON result line of a hedge report (the reference's keys; ``prefix``
    namespaces them, ``oos_`` on the out-of-sample line)."""
    out = {
        "v0": report.v0,
        "phi0": report.phi0,
        "psi0": report.psi0,
        "discounted_payoff": report.discounted_payoff,
        "var_overall": report.var_overall,
        "var_qs": list(report.var_qs),
        "residual_std": report.residual_stats["std"],
    }
    if report.v0_cv is not None:
        out.update(v0_plain=report.v0_plain, v0_cv=report.v0_cv, cv_std=report.cv_std)
    if report.v0_acv is not None:
        out.update(v0_acv=report.v0_acv, acv_std=report.acv_std)
    if extra:
        out.update(extra)
    return _jsonable({prefix + k: v for k, v in out.items()})


def _emit(args, report, extra=None, prefix=""):
    """Emit one result line; ``prefix`` namespaces the JSON keys (the
    out-of-sample line uses ``oos_`` so both lines share ONE field set)."""
    if args.json:
        _print(json.dumps(result_line(report, extra, prefix)))
    else:
        if prefix:
            _print(f"--- {prefix.rstrip('_')} (fresh scramble) ---")
        _print(report.summary())


def _emit_oos(args, oos_report):
    _emit(args, oos_report, prefix="oos_")


def cmd_euro(args):
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, european_hedge, european_oos

    euro = EuropeanConfig(
        s0=args.s0, strike=args.strike, r=args.r, sigma=args.sigma,
        option_type=args.option_type,
        constrain_self_financing=not args.unconstrained,
    )
    sim = SimConfig(
        n_paths=args.paths, T=args.T, dt=args.T / args.steps,
        rebalance_every=args.rebalance_every, engine=args.engine,
    )
    train = _train_cfg(args, "mse_only")
    dev = _device(args)
    mesh = _build_mesh(args, args.paths)
    _check_oos_seed(args, sim.seed_fund, "seed_fund")
    res = european_hedge(euro, sim, train, mesh=mesh,
                         quantile_method=args.quantile_method,
                         export_dir=args.export_dir, device=dev)
    _emit(args, res.report)
    if args.oos_seed is not None:
        oos = european_oos(
            res, euro, dataclasses.replace(sim, seed_fund=args.oos_seed),
            train, mesh=mesh, quantile_method=args.quantile_method, device=dev,
        )
        _emit_oos(args, oos.report)


def cmd_heston(args):
    from orp_tpu_torch.api import HestonConfig, SimConfig, heston_hedge
    from orp_tpu_torch.utils.heston import heston_call, heston_put

    h = HestonConfig(
        s0=args.s0, strike=args.strike, r=args.r, v0=args.v0, kappa=args.kappa,
        theta=args.theta, xi=args.xi, rho=args.rho, option_type=args.option_type,
        scheme=args.scheme,  # None -> "qe" (resolve_heston_scheme)
    )
    sim = SimConfig(
        n_paths=args.paths, T=args.T, dt=args.T / args.steps,
        rebalance_every=args.rebalance_every, engine=args.engine,
    )
    train = _train_cfg(args, "mse_only")
    dev = _device(args)
    mesh = _build_mesh(args, args.paths)
    _check_oos_seed(args, sim.seed_fund, "seed_fund")
    res = heston_hedge(h, sim, train, mesh=mesh,
                       quantile_method=args.quantile_method,
                       export_dir=args.export_dir, device=dev)
    pricer = heston_call if h.option_type == "call" else heston_put
    oracle = pricer(h.s0, h.strike, h.r, args.T, v0=h.v0, kappa=h.kappa,
                    theta=h.theta, xi=h.xi, rho=h.rho)
    err_bp = (res.report.v0_cv - oracle) / oracle * 1e4
    _emit(args, res.report, extra={"oracle": oracle, "cv_err_bp": err_bp})
    if not args.json:
        _print(f"CF oracle = {oracle:,.4f}  (v0_cv off by {err_bp:+.1f} bp)")
    if args.oos_seed is not None:
        from orp_tpu_torch.api import heston_oos

        oos = heston_oos(
            res, h, dataclasses.replace(sim, seed_fund=args.oos_seed),
            train, mesh=mesh, quantile_method=args.quantile_method, device=dev,
        )
        _emit_oos(args, oos.report)


def cmd_pension(args):
    from orp_tpu_torch.api import (
        HedgeRunConfig, MarketConfig, SimConfig, StochVolConfig, pension_hedge,
    )

    n_steps = args.steps
    cfg = HedgeRunConfig(
        market=MarketConfig(mu=args.mu, r=args.r, sigma=args.sigma),
        sv=StochVolConfig() if args.sv else None,
        sim=SimConfig(
            n_paths=args.paths, T=args.T, dt=args.T / n_steps,
            rebalance_every=n_steps if args.single_step else args.rebalance_every,
            engine=args.engine,
            # the kernel (K3c) draws the population via the moment-matched
            # normal approximation (pipelines._check_pallas rejects 'exact')
            binomial_mode="normal" if args.engine == "pallas" else "exact",
        ),
        train=_train_cfg(args, "separate"),
    )
    dev = _device(args)
    mesh = _build_mesh(args, args.paths)
    _check_oos_seed(args, cfg.sim.seed, "seed")
    res = pension_hedge(cfg, mesh=mesh, quantile_method=args.quantile_method,
                        export_dir=args.export_dir, device=dev)
    _emit(args, res.report)
    if args.oos_seed is not None:
        from orp_tpu_torch.api import pension_oos

        oos_cfg = dataclasses.replace(
            cfg, sim=dataclasses.replace(cfg.sim, seed=args.oos_seed)
        )
        oos = pension_oos(res, oos_cfg, mesh=mesh,
                          quantile_method=args.quantile_method, device=dev)
        _emit_oos(args, oos.report)


def cmd_sweep(args):
    from orp_tpu_torch.api import HedgeRunConfig, SimConfig, sigma_sweep

    dev = _device(args)
    rows = sigma_sweep(
        [float(s) for s in args.sigmas.split(",")],
        HedgeRunConfig(
            sim=SimConfig(
                n_paths=args.paths, T=args.T, dt=args.T / args.steps,
                rebalance_every=args.rebalance_every, engine=args.engine,
                binomial_mode="normal" if args.engine == "pallas" else "exact",
            ),
            train=_train_cfg(args, "separate"),
        ),
        mesh=_build_mesh(args, args.paths), device=dev,
    )
    if args.json:
        _print(_dumps(rows))
    else:
        _print(f"{'sigma':>8} {'phi0':>14} {'psi0':>14} {'total':>14}")
        for r in rows:
            _print(f"{r['sigma']:8.2f} {r['phi']:14,.0f} {r['psi']:14,.0f} {r['total']:14,.0f}")


def cmd_basket(args):
    from orp_tpu_torch.api import BasketConfig, SimConfig, basket_hedge

    bcfg = BasketConfig(
        sigmas=tuple(float(x) for x in args.sigmas.split(",")),
        s0=tuple(float(x) for x in args.s0.split(",")),
        weights=tuple(float(x) for x in args.weights.split(",")),
        strike=args.strike, r=args.r, rho=args.rho,
    )
    sim = SimConfig(
        n_paths=args.paths, T=args.T, dt=args.T / args.steps,
        rebalance_every=args.rebalance_every,
    )
    train = _train_cfg(args, "mse_only")
    dev = _device(args)
    mesh = _build_mesh(args, args.paths)
    _check_oos_seed(args, sim.seed_fund, "seed_fund")
    res = basket_hedge(
        bcfg, sim, train, mesh=mesh,
        quantile_method=args.quantile_method,
        instruments=args.instruments,
        export_dir=args.export_dir, device=dev,
    )
    rep = res.report
    extra = {
        "oracle_mm": rep.oracle_mm,
        "mm_diff_bp": (rep.v0_cv - rep.oracle_mm) / rep.oracle_mm * 1e4,
    }
    _emit(args, rep, extra=extra)
    if not args.json:
        _print(f"mm-lognormal oracle = {rep.oracle_mm:,.4f}  "
              f"(v0_cv off by {extra['mm_diff_bp']:+.1f} bp, approx-method error included)")
    if args.oos_seed is not None:
        from orp_tpu_torch.api import basket_oos

        oos = basket_oos(
            res, bcfg, dataclasses.replace(sim, seed_fund=args.oos_seed),
            train, mesh=mesh, quantile_method=args.quantile_method,
            instruments=args.instruments, device=dev,
        )
        _emit_oos(args, oos.report)


def cmd_greeks(args):
    from orp_tpu_torch.risk.greeks import european_greeks
    from orp_tpu_torch.utils.black_scholes import bs_greeks

    res = european_greeks(
        args.paths, args.s0, args.strike, args.r, args.sigma, args.T,
        kind=args.option_type, n_steps=args.steps, seed=args.seed,
        gamma_bump=args.gamma_bump, device=_device(args),
    )
    out = _jsonable({**res.as_dict(), "se": res.se, "n_paths": res.n_paths,
                     "n_steps": res.n_steps})
    if args.json:
        print(json.dumps(out))
        return
    oracle = bs_greeks(args.s0, args.strike, args.r, args.sigma, args.T,
                       kind=args.option_type)
    print(f"{'greek':<7}{'pathwise-AD':>14}{'black-scholes':>15}{'diff':>12}")
    for name in ("price", "delta", "gamma", "vega", "rho", "theta"):
        got = out[name]
        print(f"{name:<7}{got:>14.6f}{oracle[name]:>15.6f}"
              f"{got - oracle[name]:>+12.2e}")


def cmd_asian(args):
    from orp_tpu_torch.risk.asian import asian_call_qmc

    res = asian_call_qmc(
        args.paths, args.s0, args.strike, args.r, args.sigma, args.T,
        n_avg=args.avg_dates, steps_per_avg=args.steps_per_avg,
        seed=args.seed, device=_device(args),
    )
    if args.json:
        print(_dumps(res))
        return
    # se == 0 is reachable (e.g. --sigma 0 collapses every path): guard the
    # ratio so the degenerate case still prints its (well-defined) price
    ratio = (f"  ({res['se_plain'] / res['se']:.0f}x noisier)"
             if res["se"] > 0 else "")
    print(f"arithmetic-Asian call  {res['price']:.4f} ± {res['se']:.5f} (SE)")
    print(f"plain estimator        {res['plain']:.4f} ± {res['se_plain']:.5f}"
          + ratio)
    print(f"geometric CV leg       sample {res['geo_sample']:.4f} vs "
          f"closed form {res['geo_closed']:.4f}")


def cmd_barrier(args):
    from orp_tpu_torch.risk.barrier import down_and_out_call, down_and_out_call_qmc

    if args.barrier > args.strike:
        # fail BEFORE the simulation: the reflection oracle needs h <= k
        raise SystemExit(
            f"error: --barrier {args.barrier} must not exceed --strike "
            f"{args.strike} (the reflection closed form covers h <= k)"
        )
    res = down_and_out_call_qmc(
        args.paths, args.s0, args.strike, args.barrier, args.r, args.sigma,
        args.T, n_monitor=args.monitor_dates, bridge=not args.naive,
        seed=args.seed, device=_device(args),
    )
    res["oracle"] = down_and_out_call(args.s0, args.strike, args.barrier,
                                      args.r, args.sigma, args.T)
    if args.json:
        print(_dumps(res))
        return
    mode = "naive knot-check" if args.naive else "brownian-bridge corrected"
    print(f"down-and-out call ({mode})  {res['price']:.4f} ± {res['se']:.4f}")
    print(f"continuous-barrier closed form  {res['oracle']:.4f}")
    print(f"knocked-out path mass  {res['knockout_frac']:.3f}")


def cmd_lookback(args):
    from orp_tpu_torch.risk.lookback import (lookback_call_fixed,
                                       lookback_call_floating,
                                       lookback_call_qmc,
                                       lookback_floating_qmc)

    dev = _device(args)
    if args.floating:
        res = lookback_floating_qmc(
            args.paths, args.s0, args.r, args.sigma, args.T,
            n_monitor=args.monitor_dates, bridge=not args.naive,
            seed=args.seed, device=dev,
        )
        res["oracle"] = lookback_call_floating(
            args.s0, args.r, args.sigma, args.T)
        label = "floating-strike lookback call (Goldman-Sosin-Gatto oracle)"
    else:
        res = lookback_call_qmc(
            args.paths, args.s0, args.strike, args.r, args.sigma, args.T,
            n_monitor=args.monitor_dates, bridge=not args.naive,
            seed=args.seed, device=dev,
        )
        res["oracle"] = lookback_call_fixed(
            args.s0, args.strike, args.r, args.sigma, args.T)
        label = "fixed-strike lookback call (Conze-Viswanathan oracle)"
    if args.json:
        print(_dumps(res))
        return
    mode = "naive knot-max" if args.naive else "exact bridge-extreme"
    print(f"{label}, {mode}  {res['price']:.4f} ± {res['se']:.4f}")
    print(f"continuous-monitoring closed form  {res['oracle']:.4f}")


def cmd_surface(args):
    from orp_tpu_torch.risk.surface import price_surface

    strikes = [float(x) for x in args.strikes.split(",")]
    surf = price_surface(
        args.paths, args.s0, args.r, args.sigma, strikes, args.T,
        kind=args.option_type, n_maturities=args.maturities,
        steps_per_maturity=args.steps_per_maturity, seed=args.seed,
        device=_device(args),
    )
    # the surface's tensors live on the run's device: read them on the host
    surf = {k: _host(v) for k, v in surf.items()}
    if args.json:
        iv_rows = np.asarray(surf["iv"]).round(6)
        print(json.dumps({
            "times": np.asarray(surf["times"]).tolist(),
            "strikes": strikes,
            "prices": np.asarray(surf["prices"]).round(6).tolist(),
            # NaN (price on the no-arbitrage floor) -> null: bare NaN
            # tokens are not RFC-8259 JSON and break jq/JSON.parse
            "iv": [[float(v) if np.isfinite(v) else None for v in row]
                   for row in iv_rows],
        }))
        return
    iv = np.asarray(surf["iv"])
    times = np.asarray(surf["times"])
    print("implied-vol surface (rows = maturity, cols = strike; "
          "nan = price on the no-arbitrage floor)")
    # no backslash inside the f-string expression: a SyntaxError on every
    # Python < 3.12, which made the whole CLI unimportable there
    corner = "T \\ K"
    print(f"{corner:>7}" + "".join(f"{k:>9.1f}" for k in strikes))
    for i, t in enumerate(times):
        print(f"{t:7.3f}" + "".join(f"{v:9.4f}" for v in iv[i]))


def cmd_bermudan(args):
    from orp_tpu_torch.train.lsm import bermudan_lsm
    from orp_tpu_torch.utils.crr import crr_price

    res = bermudan_lsm(
        args.paths, args.s0, args.strike, args.r, args.sigma, args.T,
        kind=args.option_type, n_exercise=args.exercise_dates,
        steps_per_exercise=args.steps_per_exercise, seed=args.seed,
        device=_device(args),
    )
    if args.json:
        print(_dumps(res))
        return
    oracle = crr_price(
        args.s0, args.strike, args.r, args.sigma, args.T,
        kind=args.option_type, exercise="bermudan",
        n_steps=100 * args.exercise_dates, exercise_every=100,
    )
    print(f"LSM price          {res['price']:.4f} ± {res['se']:.4f} (SE)")
    print(f"CRR bermudan       {oracle:.4f}")
    print(f"european (same paths) {res['european']:.4f}")
    print(f"early-exercise premium {res['early_exercise_premium']:.4f}")


def cmd_export(args):
    """Train the selected pipeline at the given size and export the policy
    bundle — the dedicated export path (the hedge commands' --export-dir
    covers the export-after-a-full-reporting-run shape)."""
    from orp_tpu_torch.api import (
        EuropeanConfig, HedgeRunConfig, HestonConfig, SimConfig, european_hedge,
        heston_hedge, pension_hedge,
    )
    from orp_tpu_torch.serve.bundle import load_bundle

    train = _train_cfg(args, "mse_only" if args.pipeline != "pension" else "separate")
    dev = _device(args)
    if args.aot:
        # fail BEFORE the training spend: the single-device set (libraries and
        # timed graphs) is card-only; a mesh's set is a manifest this one
        # process writes on any device (each rank captures its shard at load)
        if any(int(x) <= 1 for x in args.aot_mesh.split(",")):
            _need_card(args, "export --aot")
    if args.pipeline == "pension":
        cfg = HedgeRunConfig(
            sim=SimConfig(n_paths=args.paths, T=args.T, dt=args.T / args.steps,
                          rebalance_every=args.rebalance_every),
            train=train,
        )
        res = pension_hedge(cfg, export_dir=args.out, device=dev)
    else:
        sim = SimConfig(n_paths=args.paths, T=args.T, dt=args.T / args.steps,
                        rebalance_every=args.rebalance_every)
        fn = european_hedge if args.pipeline == "euro" else heston_hedge
        model_cfg = EuropeanConfig() if args.pipeline == "euro" else HestonConfig()
        res = fn(model_cfg, sim, train, export_dir=args.out, device=dev)
    # prove the artifact loads before reporting success (a broken export
    # should fail HERE, not at serve time)
    bundle = load_bundle(args.out)
    aot_manifest = None
    if args.aot:
        from orp_tpu_torch.aot import export_aot
        from orp_tpu_torch.parallel.mesh import MeshSpec

        # the LOADED bundle (not the in-memory result) is what the serve
        # process will construct from — its fingerprint keys the executables
        buckets = tuple(int(x) for x in args.aot_buckets.split(","))
        meshes = tuple(MeshSpec.from_flag(int(x))
                       for x in args.aot_mesh.split(","))
        aot_manifest = export_aot(args.out, bundle, buckets=buckets,
                                  meshes=meshes, device=dev)
    out = {
        "out": args.out,
        "pipeline": args.pipeline,
        "n_dates": bundle.n_dates,
        "v0": res.v0,
        "fingerprint": bundle.fingerprint,
    }
    if aot_manifest is not None:
        topos = aot_manifest["topologies"]
        out["aot_topologies"] = sorted(topos)
        out["aot_buckets"] = sorted(
            {int(b) for t in topos.values() for b in t["buckets"]})
        out["aot_compile_wall_s"] = round(sum(
            e.get("compile_wall_s", 0.0) for t in topos.values()
            for e in t["buckets"].values()), 3)
    if args.json:
        print(json.dumps(out))
    else:
        aot_note = (f" + {len(out['aot_buckets'])} AOT bucket executables "
                    f"x {len(out['aot_topologies'])} topologies"
                    if aot_manifest is not None else "")
        print(f"exported {args.pipeline} policy ({bundle.n_dates} dates, "
              f"v0={res.v0:,.4f}){aot_note} -> {args.out}")


def _ledger_path(args, anchor: pathlib.Path | None = None) -> pathlib.Path | None:
    """``--ledger`` as a path (None when no ledger is named: the port's
    commands append to none by default). A relative path resolves against
    ``anchor`` (else the working directory). The checkout's root ledger is
    refused here, in flag-speak, before any spend."""
    if not args.ledger:
        return None
    from orp_tpu_torch.obs import perf as _perf

    ledger = pathlib.Path(args.ledger)
    if not ledger.is_absolute():
        ledger = (anchor or pathlib.Path.cwd()) / ledger
    ledger = ledger.resolve()
    try:
        _perf._refuse_root_ledger(ledger)
    except ValueError as e:
        raise SystemExit(f"error: --ledger {args.ledger}: {e}") from None
    return ledger


def cmd_serve_bench(args):
    from orp_tpu_torch.parallel.mesh import MeshSpec, join_submesh
    from orp_tpu_torch.serve import load_bundle
    from orp_tpu_torch.serve.bench import serve_bench, write_bench_record

    dev = _device(args)
    sweep = (tuple(int(x) for x in args.sweep_concurrency.split(","))
             if args.sweep_concurrency else ())
    mesh_sweep = (tuple(int(x) for x in args.mesh_sweep.split(","))
                  if args.mesh_sweep else ())
    # validate every requested topology in flag-speak BEFORE the bundle
    # load or any bench spend — the same courtesy _build_mesh gives the
    # hedge commands (an oversized N otherwise surfaces as a raw make_mesh
    # traceback from inside engine construction)
    for flag, ns in (("--mesh", [args.mesh] if args.mesh else []),
                     ("--mesh-sweep", [n for n in mesh_sweep if n > 1])):
        for n in ns:
            spec = MeshSpec.from_flag(n)
            if spec is None:
                continue
            _join_group(args, flag, n)
            try:  # a rank outside the first n builds nothing and serves no shard
                join_submesh(spec.n_devices, device=dev)
            except ValueError as e:
                raise SystemExit(f"error: {flag} {n}: {e}") from None

    if (args.degrade_at is not None
            and not 0 <= args.degrade_at < args.degrade_requests):
        raise SystemExit(
            f"error: --degrade-at {args.degrade_at} is outside the drill "
            f"stream [0, {args.degrade_requests}) — the loss would never "
            "fire; raise --degrade-requests or lower --degrade-at")

    # a relative --ledger lives beside the bench record it seeds (with --out
    # '' it resolves against the working directory)
    ledger = _ledger_path(args, pathlib.Path(args.out).resolve().parent
                          if args.out else None)
    bundle = load_bundle(args.bundle)
    # the existing record (if any) is the before: its batcher numbers ride
    # into the new record as batcher_before, so the record file carries its
    # own sync-vs-async comparison
    previous = None
    if args.out and pathlib.Path(args.out).exists():
        try:
            previous = json.loads(pathlib.Path(args.out).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"warning: ignoring unreadable previous record "
                  f"{args.out}: {e}", file=sys.stderr)
    ingest_rows = args.ingest_rows
    ingest_blocks = tuple(int(x) for x in args.ingest_blocks.split(","))
    drill_blocks, drill_rows = args.drill_blocks, args.drill_rows
    fleet_replicas = tuple(int(x) for x in args.fleet_replicas.split(","))
    fleet_gateways, fleet_tenants = args.fleet_gateways, args.fleet_tenants
    fleet_blocks, fleet_rows = args.fleet_blocks, args.fleet_rows
    density_tenants = args.density_tenants
    density_max_live = args.density_max_live
    precision_rows = args.precision_rows
    megakernel_rows = 2048
    ragged_counts = (520, 130, 17)
    repeats = args.repeats
    if args.quick:
        # the CI smoke shape: tiny block counts, same lanes, same pins —
        # the speedup claim stays regression-gated without bench-scale spend
        ingest_rows = min(ingest_rows, 512)
        ingest_blocks = tuple(b for b in ingest_blocks
                              if b <= ingest_rows) or (1, 64)
        drill_blocks = min(drill_blocks, 16)
        drill_rows = min(drill_rows, 32)
        fleet_replicas = tuple(n for n in fleet_replicas if n <= 2) or (1, 2)
        fleet_gateways = min(fleet_gateways, 2)
        fleet_tenants = min(fleet_tenants, 3)
        fleet_blocks = min(fleet_blocks, 3)
        fleet_rows = min(fleet_rows, 16)
        # two same-policy tenants through a one-engine host still exercise
        # every tier transition and both density gates (dedup > 1, warm
        # compiles == 0) without thousand-tenant spend
        density_tenants = min(density_tenants, 2)
        density_max_live = 1
        # the precision smoke keeps every gate (banded pins, bitwise
        # megakernel, pad-waste collapse, the promotion drill) at tiny
        # row counts — the CPU interpreter path makes this tier-1 safe
        precision_rows = min(precision_rows, 256)
        megakernel_rows = 64
        # (272, 24) is the smallest mix where the planner's split actually
        # pays: merged 296 -> split [256, 40] wastes 0 pad rows where the
        # pow2 arm wastes 216 — so even the smoke proves a strict saving
        ragged_counts = (272, 24)
        if args.fleet or args.density:
            repeats = 1
    if any(n < 1 for n in fleet_replicas):
        raise SystemExit("error: --fleet-replicas counts must be >= 1")
    drill_kill_at = (args.drill_kill_at if args.drill_kill_at is not None
                     else max(1, drill_blocks // 3))
    if args.gateway_drill and not 0 < drill_kill_at <= drill_blocks:
        raise SystemExit(
            f"error: --drill-kill-at {drill_kill_at} is outside the frame "
            f"stream [1, {drill_blocks}] — the kill would never fire; "
            "raise --drill-blocks or lower --drill-kill-at")
    record = serve_bench(
        bundle,
        n_requests=args.requests,
        batch_sizes=tuple(int(x) for x in args.batch_sizes.split(",")),
        batcher_requests=args.batcher_requests,
        max_wait_us=args.max_wait_us,
        prewarm=args.prewarm,
        sweep_concurrency=sweep,
        sweep_requests=args.sweep_requests,
        mesh=MeshSpec.from_flag(args.mesh),
        mesh_sweep=mesh_sweep,
        mesh_sweep_rows=args.mesh_sweep_rows,
        degrade_at=args.degrade_at,
        degrade_requests=args.degrade_requests,
        degrade_survivors=args.degrade_survivors,
        ingest=args.ingest,
        ingest_rows=ingest_rows,
        ingest_block_sizes=ingest_blocks,
        gateway_drill=args.gateway_drill,
        drill_blocks=drill_blocks,
        drill_block_rows=drill_rows,
        drill_kill_at=drill_kill_at,
        fleet=args.fleet,
        fleet_replicas=fleet_replicas,
        fleet_gateways=fleet_gateways,
        fleet_tenants=fleet_tenants,
        fleet_blocks=fleet_blocks,
        fleet_block_rows=fleet_rows,
        density=args.density,
        density_tenants=density_tenants,
        density_rows=args.density_rows,
        density_max_live=density_max_live,
        density_budget_ms=args.density_budget_ms,
        pilot=args.pilot,
        pilot_quick=args.quick,
        precision=args.precision,
        precision_rows=precision_rows,
        precision_quality_band=args.precision_band,
        megakernel_rows=megakernel_rows,
        ragged_counts=ragged_counts,
        repeats=repeats,
        previous=previous,
        device=dev,
    )
    if record is None:
        return  # a follower rank of the mesh: rank 0 records and prints
    if args.ingest:
        ing = record["ingest"]
        if not ing["submit_ns_per_row"] < ing["per_request"]["submit_ns_per_row"]:
            # the regression gate the --ingest record exists for: columnar
            # admission must beat the per-request path it amortizes
            raise SystemExit(
                "error: columnar submit_ns_per_row "
                f"({ing['submit_ns_per_row']}) is not below the per-request "
                f"path ({ing['per_request']['submit_ns_per_row']}) — the "
                "ingest amortization regressed")
    if args.out:
        write_bench_record(record, args.out)
    if ledger is not None:
        # a record-writing run appends its headline phases to the named perf
        # ledger: the time series `perf-gate` judges regressions on
        from orp_tpu_torch.obs import perf as _perf
        from orp_tpu_torch.serve.bench import ledger_records

        try:
            for rec in ledger_records(record):
                _perf.ledger_append(ledger, rec)
        except (OSError, ValueError) as e:
            # the bench completed and its record is written — a read-only
            # ledger must not turn that into a nonzero exit with no record
            # on stdout
            print(f"perf-ledger append failed: {e}", file=sys.stderr)
    _print(json.dumps(record))


def _gateway_shutdown(gw, ready_file, stop) -> None:
    """The supervisor contract (SIGTERM/SIGINT → here): remove the ready
    file FIRST (stop routing new producers at us), run the graceful drain
    (in-flight frames finish, their replies flush — zero rows lost), then
    let the main loop exit. Idempotent: a second signal while draining is
    absorbed."""

    if ready_file:
        pathlib.Path(ready_file).unlink(missing_ok=True)
    gw.close()
    stop.set()


def cmd_serve_gateway(args):
    """Serve a bundle over the ``orp-ingest`` TCP front (v2 sequenced
    frames with reconnect-replay dedup; v1 frames still answered):
    columnar frames in, columnar replies out (``orp_tpu_torch/serve/gateway.py``).
    Runs until SIGTERM/SIGINT (both run the graceful zero-loss drain and
    remove ``--ready-file``) or ``--max-seconds``; ``--ready-file`` drops
    ``host port`` once the socket is listening, for supervisors and
    loopback harnesses that need the bound port (``--port 0`` picks a free
    one). The telemetry plane is always on: the process keeps a live
    registry (scrapeable in-band via the METRICS wire kind, and over plain
    HTTP with ``--metrics-port``) even without ``--telemetry``; with
    ``--telemetry DIR`` the registry, span events, flight ring and
    manifest additionally export to DIR — flushed periodically and on
    SIGTERM, not just at clean exit."""
    import contextlib
    import signal
    import threading

    from orp_tpu_torch import obs
    from orp_tpu_torch.guard.serve import GuardPolicy
    from orp_tpu_torch.serve import MetricsServer, ServeGateway, ServeHost

    if args.bundle is None and args.fleet is None:
        raise SystemExit("error: pass --bundle DIR (a serving gateway) or "
                         "--fleet topology.json (a routing gateway)")
    if args.fleet is not None and (args.deadline_ms is not None
                                   or args.watermark is not None
                                   or args.max_pending is not None):
        raise SystemExit(
            "error: --deadline-ms/--watermark/--max-pending configure a "
            "SERVING gateway's guard policy; a --fleet router forwards "
            "blocks and enforces none of them — set these flags on the "
            "replica gateways instead")
    policy = None
    if args.deadline_ms is not None or args.watermark is not None:
        policy = GuardPolicy(deadline_ms=args.deadline_ms,
                             queue_watermark=args.watermark)
    with contextlib.ExitStack() as stack:
        if not obs.enabled():
            # a gateway is a long-lived serving process: its counters and
            # latency series must accumulate SOMEWHERE scrapeable even
            # without --telemetry (which, when passed, already opened a
            # session before this command ran — see main())
            stack.enter_context(obs.active())
        if args.device_profile:
            # flag-gated device-time attribution (obs/devprof): per-bucket
            # queue/device seconds + the live utilization gauge land in
            # this process's registry — `orp top` renders dev-util, the
            # /metrics scrape exports serve_device_* (bill gated ≤5% by
            # the bench's profile_overhead phase; off = zero cost)
            from orp_tpu_torch.obs import devprof

            stack.enter_context(devprof.profiling())
        if args.fleet is not None:
            from orp_tpu_torch.serve.fleet import FleetError, FleetHost, \
                load_topology

            try:
                topo = load_topology(args.fleet)
            except FleetError as e:
                raise SystemExit(f"error: {e}") from None
            host = stack.enter_context(FleetHost(topo["replicas"]))
        else:
            host = stack.enter_context(
                ServeHost(max_live_engines=args.max_live_engines,
                          engine_kwargs={"device": _device(args)}))
            host.add_tenant(args.tenant, args.bundle, policy=policy,
                            max_pending=args.max_pending)
        stop = threading.Event()
        gw = stack.enter_context(ServeGateway(
            host, addr=args.addr, port=args.port,
            default_tenant=args.tenant,
            frame_deadline_s=args.frame_deadline_s,
            max_inflight_replies=args.max_inflight))
        mserver = None
        if args.metrics_port is not None:
            mserver = stack.enter_context(MetricsServer(
                gw.metrics_text, health_fn=gw.health_report,
                addr=args.addr, port=args.metrics_port))
        if threading.current_thread() is threading.main_thread():
            # supervisors send SIGTERM and expect a clean zero-loss
            # shutdown, not an abort mid-frame; SIGINT (ctrl-C) takes
            # the same path so by-hand runs drain identically. The drain
            # exits the telemetry session normally, which flushes the
            # bundle — no separate flush hook needed here
            handler = (lambda signum, frame:
                       _gateway_shutdown(gw, args.ready_file, stop))
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        addr, port = gw.address
        line = {"addr": addr, "port": port, "tenant": args.tenant,
                "bundle": args.bundle}
        if args.fleet is not None:
            line["fleet"] = args.fleet
            line["replicas"] = {r.name: f"{r.addr}:{r.port}"
                                for r in topo["replicas"]}
        if mserver is not None:
            line["metrics_port"] = mserver.address[1]
        scrape_note = ("" if mserver is None else
                       f"; metrics http://{mserver.address[0]}:"
                       f"{mserver.address[1]}/metrics")
        what = (f"routing {len(topo['replicas'])} replica(s) from "
                f"{args.fleet}" if args.fleet is not None else
                f"serving {args.bundle} as tenant {args.tenant!r}")
        print(json.dumps(line) if args.json
              else f"{what} on {addr}:{port} (orp-ingest v1/v2; SIGTERM "
                   f"or ctrl-C to drain{scrape_note})",
              flush=True)
        if args.ready_file:
            pathlib.Path(args.ready_file).write_text(f"{addr} {port}\n")
        try:
            # parked, not polling: wakes at --max-seconds or the signal
            stop.wait(args.max_seconds)
        except KeyboardInterrupt:
            _gateway_shutdown(gw, args.ready_file, stop)
        if not stop.is_set() and args.ready_file:
            # --max-seconds elapsed without a signal: same clean exit
            pathlib.Path(args.ready_file).unlink(missing_ok=True)


def cmd_warm(args):
    """Pre-populate the persistent kernel-build cache for training: build the
    fused walk's library (``fused_mf``) into the cache and capture the fused
    walk's programs for the selected pipeline's exact shapes and training
    config on empty tensors — no paths simulated, no training run. The next
    real run of the SAME config on that cache runs ``nvcc`` 0 times; CUDA
    graphs cannot be serialized, so the captures only measure what a run
    will pay (``aot.warm_fused_walk``)."""
    from orp_tpu_torch.aot import enable_persistent_cache, warm_fused_walk
    from orp_tpu_torch.api.pipelines import _backward_cfg
    from orp_tpu_torch.models.mlp import HedgeMLP

    if not args.fused:
        # the fused walk IS the program being warmed; mirror _train_cfg's
        # --fused branch (shuffle="blocks") so the warmed program is the one
        # `orp <cmd> --fused` will run
        args.fused = True
    _need_card(args, "warm")
    # --cache-dir None: aot.cache.resolve_cache_dir() (ORP_TORCH_CACHE_DIR,
    # else the gitignored build/orp_tpu_torch/)
    cache_dir = enable_persistent_cache(args.cache_dir, min_compile_secs=0.0)
    if cache_dir is None:
        raise SystemExit("error: the compile cache is disabled "
                         "(ORP_TESTS_NO_COMPILE_CACHE is set) — nothing to warm")
    default_dual = "separate" if args.pipeline == "pension" else "mse_only"
    train = _train_cfg(args, default_dual)
    n_features = {"euro": 1, "heston": 2, "pension": 3}[args.pipeline]
    if args.pipeline == "euro":
        # the head shape is part of the static model, hence of the program:
        # --unconstrained here must mirror `orp euro --unconstrained` (the
        # north-star benchmark's free-psi config) or the warm misses the cache
        model = HedgeMLP(n_features=1,
                         constrain_self_financing=not args.unconstrained)
    else:
        model = HedgeMLP(n_features=n_features)
    n_dates = args.steps // args.rebalance_every
    cfg = _backward_cfg(train)
    meta = warm_fused_walk(model, cfg, n_paths=args.paths, n_dates=n_dates)
    out = {
        "cache_dir": str(cache_dir),
        "pipeline": args.pipeline,
        **meta,
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"warmed {out['fn']} ({args.pipeline}) into {cache_dir}: "
              f"compile {out['compile_wall_s']}s, lower {out['lower_wall_s']}s")


def cmd_doctor(args):
    """One-shot environment/bundle self-check — the first thing to run on a
    broken pod, before any simulation or compile spend. Every failing check
    prints a fix in flag-speak; exit 1 when anything failed."""
    from orp_tpu_torch.serve.health import doctor_report

    rep = doctor_report(args.bundle, mesh=args.mesh, cache_dir=args.cache_dir,
                        telemetry_dir=args.telemetry_dir,
                        gateway=args.gateway, metrics=args.metrics,
                        quality=args.quality, perf=args.perf,
                        fleet=args.fleet, store=args.store,
                        pilot=args.pilot,
                        gateway_timeout_s=args.gateway_timeout_s,
                        device=args.device)
    if args.json:
        print(json.dumps(rep))
    else:
        for c in rep["checks"]:
            mark = "ok  " if c["ok"] else "FAIL"
            print(f"{mark} {c['check']:<15} {c['detail']}")
            if not c["ok"] and c.get("fix"):
                print(f"     fix: {c['fix']}")
        print("healthy" if rep["ok"] else "NOT healthy")
    if not rep["ok"]:
        raise SystemExit(1)


def cmd_store(args):
    """``orp store put|stat|gc`` — operate a content-addressed bundle
    store: publish an exported bundle under catalog tenant names (put),
    report the dedup/occupancy picture (stat), or reclaim unreferenced
    blobs (gc — never touches anything the catalog still points at)."""
    from orp_tpu_torch.store import open_store

    store = open_store(args.root)
    if args.action == "put":
        tenants = [t for t in (args.tenants or "").split(",") if t]
        if not args.bundle or not tenants:
            raise SystemExit(
                "error: store put needs --bundle DIR (an `orp export` "
                "output) and --tenants NAME[,NAME…] (the catalog names "
                "to publish under)")
        try:
            published = store.publish_many(tenants, args.bundle)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
        out = {"root": str(args.root), "published": published,
               "stats": store.stats()}
        if args.json:
            print(json.dumps(out))
        else:
            for name, ent in published.items():
                print(f"published {name}@v{ent['version']} "
                      f"manifest {ent['manifest'][:12]} "
                      f"({ent['files']} files)")
            st = out["stats"]
            print(f"store: {st['blobs']} blobs, {st['blob_bytes']} bytes, "
                  f"dedup ratio {st['dedup_ratio']}")
    elif args.action == "stat":
        # stats() counts tenants; the report names them (dict wins the key)
        out = {"root": str(args.root), **store.stats(),
               "tenants": store.tenants()}
        if args.json:
            print(json.dumps(out))
        else:
            print(f"{out['root']}: {len(out['tenants'])} tenants, "
                  f"{out['manifests']} manifests, {out['blobs']} blobs "
                  f"({out['blob_bytes']} bytes), dedup ratio "
                  f"{out['dedup_ratio']}")
            if out["dangling_refs"]:
                print(f"WARNING: {out['dangling_refs']} dangling blob "
                      "reference(s) — the catalog points at bytes the CAS "
                      "no longer holds; re-publish with `orp store put`")
            if out["orphan_blobs"]:
                print(f"{out['orphan_blobs']} orphan blob(s), "
                      f"{out['orphan_bytes']} bytes reclaimable via "
                      "`orp store gc`")
    else:  # gc
        out = {"root": str(args.root),
               **store.gc(dry_run=args.dry_run)}
        if args.json:
            print(json.dumps(out))
        else:
            verb = "would remove" if out["dry_run"] else "removed"
            print(f"{verb} {out['removed']} blob(s), "
                  f"{out['removed_bytes']} bytes; kept {out['kept']} "
                  "referenced blob(s)")


def cmd_top(args):
    """Live serving dashboard off a running gateway: scrape the METRICS
    wire kind (plus a HEALTH probe for queue depth / drain state), digest
    into req/s, p99, shed/BUSY rates and the per-tenant table. Two scrapes
    ``--interval`` seconds apart turn lifetime counters into rates; with
    ``--watch`` the screen refreshes until ctrl-C."""
    import time as _time

    from orp_tpu_torch.serve.gateway import GatewayClient
    from orp_tpu_torch.serve.scrape import render_top, top_snapshot

    if args.fleet is not None:
        return _top_fleet(args)
    if args.gateway is None:
        raise SystemExit("error: pass --gateway HOST:PORT (one gateway) "
                         "or --fleet topology.json (the whole fleet)")
    addr, _, port = str(args.gateway).rpartition(":")
    addr = addr or "127.0.0.1"
    target = f"{addr}:{port}"

    def scrape(previous=None, interval=None):
        # ONLY the network I/O sits in the caller's scrape-failure except:
        # a render/print problem (BrokenPipeError from `orp top | head`,
        # say) must not masquerade as a dead gateway
        try:
            with GatewayClient(addr, int(port),
                               timeout_s=args.timeout_s) as client:
                text = client.metrics()
                health = client.health()
        except (OSError, ValueError, RuntimeError) as e:
            raise SystemExit(
                f"error: could not scrape {target}: {e} — is an `orp "
                "serve-gateway` listening there? (probe with `orp doctor "
                f"--metrics {target}`)") from None
        return top_snapshot(text, previous=previous, interval_s=interval,
                            health=health)

    try:
        snap = scrape()
        while True:
            _time.sleep(args.interval)
            snap = scrape(previous=snap, interval=args.interval)
            if args.json:
                print(json.dumps(snap))
            else:
                print(render_top(snap, target=target), flush=True)
            if not args.watch:
                return
    except KeyboardInterrupt:
        return  # --watch exits clean on ctrl-C, like top(1)


def _top_fleet(args):
    """``orp top --fleet topology.json``: scrape EVERY gateway in the
    topology twice, ``--interval`` apart, and aggregate (reusing
    ``top_snapshot`` per gateway): fleet-wide rates, the per-gateway
    table, and the routing-version agreement line."""
    import time as _time

    from orp_tpu_torch.serve.fleet import (FleetError, fleet_snapshot,
                                     load_topology, render_fleet_top)
    from orp_tpu_torch.serve.gateway import GatewayClient
    from orp_tpu_torch.serve.scrape import top_snapshot

    try:
        topo = load_topology(args.fleet)
    except FleetError as e:
        raise SystemExit(f"error: {e}") from None
    if not topo["gateways"]:
        raise SystemExit(f"error: {args.fleet} lists no gateways — add "
                         'a "gateways": ["host:port", …] section')

    def scrape_all(previous=None, interval=None):
        per = {}
        for addr, port in topo["gateways"]:
            target = f"{addr}:{port}"
            try:
                with GatewayClient(addr, port,
                                   timeout_s=args.timeout_s) as client:
                    text = client.metrics()
                    health = client.health()
            except (OSError, ValueError, RuntimeError) as e:
                raise SystemExit(
                    f"error: could not scrape fleet gateway {target}: {e} "
                    f"— probe the fleet with `orp doctor --fleet "
                    f"{args.fleet}`") from None
            prev_snap = (previous or {}).get(target, {}).get("snap")
            per[target] = {
                "snap": top_snapshot(text, previous=prev_snap,
                                     interval_s=interval, health=health),
                "routing": health.get("routing"),
            }
        return per

    try:
        per = scrape_all()
        while True:
            _time.sleep(args.interval)
            per = scrape_all(previous=per, interval=args.interval)
            snap = fleet_snapshot(per)
            if args.json:
                print(json.dumps(snap))
            else:
                print(render_fleet_top(snap), flush=True)
            if not args.watch:
                return
    except KeyboardInterrupt:
        return  # --watch exits clean on ctrl-C, like top(1)


def cmd_trace(args):
    """Reconstruct one frame's span tree from a telemetry bundle's
    ``events.jsonl``: ``orp trace <trace_id> --events DIR`` prints the
    decode → queue → dispatch → resolve → encode chain the serving process
    recorded under that trace id (stamp frames with
    ``submit_block(..., trace=obs.new_trace())`` and run the gateway with
    ``--telemetry DIR``)."""
    from orp_tpu_torch.obs.spans import parse_trace_id
    from orp_tpu_torch.obs.tracetree import format_trace_tree, load_trace

    try:
        parse_trace_id(args.trace_id)
    except ValueError:
        # validated SEPARATELY from the bundle read: a torn events.jsonl
        # raises JSONDecodeError (a ValueError subclass), and blaming the
        # trace id for a corrupt bundle sends the operator the wrong way
        raise SystemExit(
            f"error: {args.trace_id!r} is not a trace id — pass the "
            "16-hex-digit id the producer stamped (obs.trace_hex)"
        ) from None
    try:
        spans, roots, summary = load_trace(args.events, args.trace_id)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    except ValueError as e:
        raise SystemExit(
            f"error: {args.events}: events.jsonl does not parse ({e}) — "
            "torn bundle? (a killed gateway can leave a partial last "
            "line; every complete line still parses)") from None
    if not spans:
        raise SystemExit(
            f"error: no spans for trace {args.trace_id} in {args.events} — "
            "wrong bundle, or the gateway ran without --telemetry")
    if args.json:
        print(json.dumps({"trace_id": args.trace_id, **summary,
                          "tree": roots}))
    else:
        print(format_trace_tree(args.trace_id, roots, summary))


def cmd_report(args):
    """Render the training-convergence record of a telemetered walk: per
    date, the final fit loss/mae, the epochs (or GN iterations) consumed,
    the trainer-ladder rung that produced the committed columns (the NaN
    sentinel's ``guard/degrade`` events overlay the configured optimizer)
    and — for Gauss-Newton walks — the GN Gram condition number."""
    from orp_tpu_torch.obs.report import format_report, load_convergence

    try:
        rec = load_convergence(args.events)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    except ValueError as e:
        raise SystemExit(
            f"error: {args.events}: events.jsonl does not parse ({e}) — "
            "torn bundle?") from None
    if args.json:
        print(json.dumps(rec))
    else:
        print(format_report(rec))


def cmd_profile(args):
    """Run a workload under the performance observatory: device-time
    attribution on (queue vs device seconds per dispatch, host vs device
    per span), every ``nvcc`` run and graph capture metered per stage, the
    FLOP ledger + roofline fractions joined — ONE run, no cold/warm pair
    (subsumes ``tools/profile_north_star.py``). ``--trace-dir`` wraps the
    run in ``torch.profiler`` with CUDA activities: the obs spans name the
    regions of the Chrome trace it leaves there (``trace.json``)."""
    from orp_tpu_torch.obs import devprof

    if args.trace_dir is not None:
        _need_card(args, "profile --trace-dir")
    # no default ledger: the run appends only to a --ledger the caller names
    ledger = _ledger_path(args)
    try:
        out = devprof.profile_run(
            workload=args.workload, bundle=args.bundle,
            n_log2=args.paths_log2, quick=args.quick,
            trace_dir=args.trace_dir, device=_device(args))
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    if ledger is not None:
        from orp_tpu_torch.obs import perf as _perf

        try:
            for rec in _profile_ledger_records(out):
                _perf.ledger_append(ledger, rec)
        except (OSError, ValueError) as e:
            print(f"perf-ledger append failed: {e}", file=sys.stderr)
            ledger = None
    if args.json:
        print(json.dumps(out))
        return
    print(f"orp profile — {out['workload']} "
          f"({out.get('n_paths', out.get('n_requests'))} "
          f"{'paths' if out['workload'] == 'north_star' else 'requests'}, "
          f"platform {out['platform']})")
    if out["workload"] == "north_star":
        print(f"{'stage':<12}{'wall s':>10}{'compile s':>11}"
              f"{'execute s':>11}{'host s':>9}{'device s':>10}"
              f"{'frac peak':>11}")
        for name, st in out["stages"].items():
            rf = st.get("roofline") or {}
            frac = rf.get("frac_peak_flops")
            print(f"{name:<12}{st['wall_s']:>10.3f}"
                  f"{(st['compile_s'] if st['compile_s'] is not None else float('nan')):>11.3f}"
                  f"{(st['execute_wall_s'] if st['execute_wall_s'] is not None else float('nan')):>11.3f}"
                  f"{st['host_s']:>9.3f}{st['device_wait_s']:>10.3f}"
                  + (f"{frac:>11.2e}" if frac is not None else f"{'-':>11}"))
    else:
        print(f"device utilization {out['device_utilization']:.1%}")
        print(f"{'bucket':>8}{'count':>7}{'device ms':>11}{'queue ms':>10}")
        for b, st in sorted(out["buckets"].items(), key=lambda kv: int(kv[0])):
            print(f"{b:>8}{st['count']:>7}"
                  f"{st['device_s_median'] * 1e3:>11.4f}"
                  f"{st['queue_s_median'] * 1e3:>10.4f}")
        rf = out.get("roofline")
        if rf and "error" not in rf:
            print(f"roofline: bucket {rf['bucket']} achieved "
                  f"{rf['achieved_flops_per_s']:.3g} FLOP/s = "
                  f"{rf['frac_peak_flops']:.2e} of peak "
                  f"({rf['peak_source']})")
    if ledger is not None:
        print(f"perf ledger -> {ledger}")
    if "trace_dir" in out:
        print(f"perfetto trace -> {out['trace_dir']}")


def _profile_ledger_records(out: dict) -> list:
    """The orp-perf-v1 rows an ``orp profile`` run seeds: one per
    north-star stage (the stage wall as a single-sample record carries
    repeats=1 and is therefore never GATED — the gate's min-repeats
    refusal is the contract — but it still lands the time series), or the
    serve workload's per-bucket device medians with their honest counts."""
    from orp_tpu_torch.obs import perf as _perf

    recs = []
    if out["workload"] == "north_star":
        fp = {"n_paths": out["n_paths"], "n_dates": out["n_dates"],
              "quick": out["quick"]}
        for name, st in out["stages"].items():
            recs.append(_perf.make_record_from_summary(
                "profile_north_star", name, repeats=1,
                median=st["wall_s"], iqr=0.0, fingerprint_extra=fp,
                extra={"compile_s": st["compile_s"],
                       "device_wait_s": st["device_wait_s"]}))
    else:
        fp = {"n_requests": out["n_requests"], "quick": out["quick"],
              "policy": out.get("policy")}
        for b, st in out["buckets"].items():
            recs.append(_perf.make_record_from_summary(
                "profile_serve", f"bucket_{b}_device_s",
                repeats=st["count"], median=st["device_s_median"],
                # the per-dispatch window's real spread — an iqr of 0.0
                # would hand a later perf-gate a zero-width noise band
                # that trips on ordinary container wobble
                iqr=st.get("device_s_iqr", 0.0), fingerprint_extra=fp))
    return recs


def cmd_perf_gate(args):
    """Noise-aware perf-regression verdict against the ledger's matching-
    fingerprint history: green within k*IQR of the history medians (or on
    a fresh baseline), exit 1 in flag-speak on a real regression, refusal
    (exit 2) when either side has fewer than --min-repeats repeats. With
    ``--bundle`` the gate takes its own measurement first (repeats of a
    fixed serve schedule) and appends it to the ledger ONLY on a green
    verdict (a regressed run must never shift the baseline it failed
    against); without, it judges the ledger's newest matching record.
    The measurement reaches obs before the verdict either way."""
    from orp_tpu_torch.obs import perf as _perf

    try:
        out = _perf.gate_cli(
            ledger=args.ledger, bundle=args.bundle,
            workload=args.workload, phase=args.phase,
            repeats=args.repeats, evals=args.evals, rows=args.rows,
            k=args.k, min_repeats=args.min_repeats,
            device=_device(args) if args.bundle is not None else None)
    except (ValueError, OSError) as e:
        raise SystemExit(f"error: {e}") from None
    if args.json:
        print(json.dumps(out))
    else:
        mark = {"ok": "green", "no_history": "green (baseline seeded)",
                "refused": "REFUSED", "regression": "REGRESSION"}
        print(f"perf-gate {mark[out['verdict']]}: {out['reason']}")
    if out["verdict"] == "refused":
        raise SystemExit(2)
    if not out["ok"]:
        raise SystemExit(
            f"error: perf regression on {out['record']['workload']}/"
            f"{out['record']['phase']}: {out['reason']} — if this change "
            "is intentional, reseed the history (move the ledger aside or "
            "append accepted runs with `orp serve-bench --ledger`/"
            "`orp perf-gate --bundle`)")


def cmd_lint(args):
    """CUDA/H100-aware static analysis of the port: one shared contract with
    ``python -m orp_tpu_torch.lint`` (orp_tpu_torch/lint/engine.py:run_cli) —
    findings exit 1, usage errors exit 2."""
    from orp_tpu_torch.lint.engine import run_cli

    rc = run_cli(args.paths, args.select, args.json, fmt=args.fmt,
                 concurrency=args.concurrency, changed=args.changed,
                 list_rules=args.list_rules, markdown=args.markdown)
    if rc:
        raise SystemExit(rc)


def cmd_calibrate(args):
    from orp_tpu_torch.calib import (
        annualized_drift, estimate_cir_params, log_returns, rolling_volatility,
    )

    src = args.prices if args.prices is not None else args.csv
    if src is None:
        raise SystemExit(
            "error: calibrate needs a price series — pass a CSV "
            "positionally (legacy point estimate) or via --prices CSV "
            "(rolling fit with RQMC-bootstrap CI bands)")
    try:
        prices = np.loadtxt(src, delimiter=",", usecols=args.column,
                            skiprows=args.skiprows)
    except (OSError, ValueError) as e:
        raise SystemExit(
            f"error: could not read a price column from {src!r}: {e} — "
            "expected one float per line (CSV); a header row needs "
            "--skiprows 1, a multi-column file needs --column N") from None
    if args.prices is not None:
        # the pilot form: the full fit + the confidence band a retrain
        # trigger must leave (pilot/calibrate.py's significance gate)
        from orp_tpu_torch.pilot import calibrate_window

        try:
            win = calibrate_window(prices, vol_window=args.window,
                                   n_boot=args.boot, seed=0)
        except ValueError as e:
            raise SystemExit(
                f"error: {e} — feed a longer --prices series, shrink "
                "--window, or raise --boot") from None
        if args.json:
            print(json.dumps(win.to_meta()))
            return
        f = win.fit
        print(f"CIRParams(a={f.params.a:.6f}, b={f.params.b:.6f}, "
              f"c={f.params.c:.6f})  mu={f.mu:.5f}  sigma0={f.sigma0:.5f}  "
              f"(n_prices={f.n_prices}, vol_window={f.vol_window})")
        print(f"{int(win.level * 100)}% RQMC-bootstrap bands "
              f"(n_boot={win.n_boot}, failed_resamples={win.n_failed}):")
        for k in ("a", "b", "c", "mu", "sigma0"):
            lo, hi = win.ci[k]
            print(f"  {k:>6}: [{lo:.6f}, {hi:.6f}]")
        return
    rets = log_returns(prices)
    vol = rolling_volatility(rets, window=args.window)
    try:
        params = estimate_cir_params(vol)
    except ValueError as e:
        print(f"calibration failed: {e}", file=sys.stderr)
        raise SystemExit(1)
    out = {
        "a": params.a, "b": params.b, "c": params.c,
        "mu": annualized_drift(prices, args.years),
        "sigma0": float(vol[-1]),
    }
    print(json.dumps(out) if args.json else
          f"CIRParams(a={params.a:.6f}, b={params.b:.6f}, c={params.c:.6f})  "
          f"mu={out['mu']:.5f}  sigma0={out['sigma0']:.5f}")


def cmd_pilot(args):
    """``orp pilot retrain|status`` — file a manual retrain request into an
    ``orp-pilot-v1`` journal (the controller consumes it on its next poll,
    debounced through the shared cooldown) or render the journal's state."""

    from orp_tpu_torch.pilot import (TERMINAL_STATES, journal_append, last_cycle,
                               read_journal, unconsumed_requests)

    jp = pathlib.Path(args.journal)
    if args.action == "retrain":
        try:
            rec = journal_append(jp, {
                "kind": "trigger_request", "source": "manual",
                "tenant": args.tenant,
                "reason": args.reason or "manual retrain request"})
        except (OSError, ValueError) as e:
            raise SystemExit(
                f"error: {jp}: {e} — point --journal at the pilot's "
                "workdir journal (PilotConfig.workdir/pilot.jsonl)"
            ) from None
        out = {"filed": True, "journal": str(jp), "seq": rec["seq"],
               "tenant": args.tenant, "reason": rec["reason"]}
        print(json.dumps(out) if args.json else
              f"filed retrain request seq={rec['seq']} for tenant "
              f"{args.tenant!r} in {jp} — the controller consumes it on "
              "its next poll")
        return
    # status
    try:
        records, problems = read_journal(jp)
    except ValueError as e:
        raise SystemExit(f"error: {jp}: {e}") from None
    if not jp.exists():
        raise SystemExit(
            f"error: {jp} does not exist — no pilot has journaled here "
            "yet (a controller seeds it at construction, `orp pilot "
            "retrain --journal PATH` seeds it with a request)")
    cid, recs = last_cycle(records)
    pending = unconsumed_requests(records)
    out = {"journal": str(jp), "records": len(records),
           "torn_tail_lines": len(problems),
           "pending_requests": [
               {"seq": r.get("seq"), "tenant": r.get("tenant"),
                "reason": r.get("reason")} for r in pending]}
    if cid is None:
        out["last_cycle"] = None
    else:
        state = recs[-1].get("state")
        out["last_cycle"] = {
            "cycle": cid, "state": state,
            "terminal": state in TERMINAL_STATES,
            **({"resumable": True} if state not in TERMINAL_STATES else {}),
        }
        for key in ("why", "error", "version", "elapsed_s"):
            if key in recs[-1]:
                out["last_cycle"][key] = recs[-1][key]
    if args.json:
        print(json.dumps(out))
        return
    print(f"{jp}: {len(records)} record(s)"
          + (f", {len(problems)} torn-tail line(s) tolerated"
             if problems else ""))
    lc = out["last_cycle"]
    if lc is None:
        print("no cycles journaled yet")
    else:
        extra = "".join(f"  {k}={lc[k]}" for k in
                        ("why", "error", "version", "elapsed_s") if k in lc)
        print(f"cycle {lc['cycle']}: {lc['state']}"
              + ("" if lc["terminal"]
                 else "  (resumable: PilotController.resume())") + extra)
    if pending:
        for r in out["pending_requests"]:
            print(f"pending retrain request seq={r['seq']} "
                  f"tenant={r['tenant']!r}: {r['reason']}")
    else:
        print("no pending retrain requests")


def build_parser():
    p = argparse.ArgumentParser(prog="orp_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the commands compute: the card (default; "
                        "raises without one) or the CPU, where every kernel "
                        "is its plain PyTorch version (the counterpart of "
                        "JAX_PLATFORMS=cpu)")
    sub = p.add_subparsers(dest="command", required=True)

    pe = sub.add_parser("euro", help="European option hedge")
    pe.add_argument("--paths", type=int, default=4096)
    pe.add_argument("--steps", type=int, default=364)
    pe.add_argument("--rebalance-every", type=int, default=7)
    pe.add_argument("--T", type=float, default=1.0)
    pe.add_argument("--s0", type=float, default=100.0)
    pe.add_argument("--strike", type=float, default=100.0)
    pe.add_argument("--r", type=float, default=0.08)
    pe.add_argument("--sigma", type=float, default=0.15)
    pe.add_argument("--option-type", choices=["call", "put"], default="call")
    pe.add_argument("--unconstrained", action="store_true",
                    help="drop the psi=1-phi self-financing head")
    pe.add_argument("--engine", choices=["scan", "pallas"], default="scan",
                    help="path simulator: the scan path or the fused CUDA kernel")
    _add_train_flags(pe)
    _add_mesh_flag(pe)
    _add_oos_flag(pe)
    _add_quantile_flag(pe)
    _add_export_flag(pe)
    pe.set_defaults(fn=cmd_euro)

    ph = sub.add_parser("heston", help="European hedge under Heston stochastic vol")
    ph.add_argument("--paths", type=int, default=1 << 16)
    ph.add_argument("--steps", type=int, default=364)
    ph.add_argument("--rebalance-every", type=int, default=7)
    ph.add_argument("--T", type=float, default=1.0)
    ph.add_argument("--s0", type=float, default=100.0)
    ph.add_argument("--strike", type=float, default=100.0)
    ph.add_argument("--r", type=float, default=0.08)
    ph.add_argument("--v0", type=float, default=0.0225)
    ph.add_argument("--kappa", type=float, default=1.5)
    ph.add_argument("--theta", type=float, default=0.0225)
    ph.add_argument("--xi", type=float, default=0.25)
    ph.add_argument("--rho", type=float, default=-0.6)
    ph.add_argument("--option-type", choices=["call", "put"], default="call")
    ph.add_argument("--engine", choices=["scan", "pallas"], default="scan",
                    help="path simulator: the scan path or the fused CUDA kernel")
    ph.add_argument("--scheme", choices=["qe", "euler"], default=None,
                    help="variance transition: Andersen QE-M (coarse-grid "
                    "accurate; default) or full-truncation Euler — both "
                    "available on both engines")
    _add_train_flags(ph)
    _add_mesh_flag(ph)
    _add_oos_flag(ph)
    _add_quantile_flag(ph)
    _add_export_flag(ph)
    ph.set_defaults(fn=cmd_heston)

    pp = sub.add_parser("pension", help="pension-liability hedge")
    pp.add_argument("--paths", type=int, default=4096)
    pp.add_argument("--steps", type=int, default=1000)
    pp.add_argument("--rebalance-every", type=int, default=25)
    pp.add_argument("--T", type=float, default=10.0)
    pp.add_argument("--mu", type=float, default=0.08)
    pp.add_argument("--r", type=float, default=0.03)
    pp.add_argument("--sigma", type=float, default=0.15)
    pp.add_argument("--sv", action="store_true", help="CIR stochastic-vol fund")
    pp.add_argument("--single-step", action="store_true",
                    help="one rebalance interval (Single Time Step shape)")
    pp.add_argument("--engine", choices=["scan", "pallas"], default="scan",
                    help="path simulator: the scan path (exact binomial) or the "
                         "fused CUDA kernel (normal-approx binomial)")
    _add_train_flags(pp)
    _add_mesh_flag(pp)
    _add_oos_flag(pp)
    _add_quantile_flag(pp)
    _add_export_flag(pp)
    pp.set_defaults(fn=cmd_pension)

    ps = sub.add_parser("sweep", help="sigma sweep")
    ps.add_argument("--sigmas", default="0.05,0.10,0.15,0.20,0.30")
    ps.add_argument("--paths", type=int, default=4096)
    ps.add_argument("--steps", type=int, default=1000)
    ps.add_argument("--rebalance-every", type=int, default=25)
    ps.add_argument("--T", type=float, default=10.0)
    ps.add_argument("--engine", choices=["scan", "pallas"], default="scan",
                    help="path simulator: the scan path (exact binomial) or the "
                         "fused CUDA kernel (normal-approx binomial)")
    _add_train_flags(ps)
    _add_mesh_flag(ps)
    ps.set_defaults(fn=cmd_sweep)

    pb = sub.add_parser("basket", help="multi-asset basket-call hedge")
    pb.add_argument("--paths", type=int, default=1 << 17)
    pb.add_argument("--steps", type=int, default=52)
    pb.add_argument("--rebalance-every", type=int, default=1)
    pb.add_argument("--T", type=float, default=1.0)
    pb.add_argument("--s0", default="100,100,100,100,100")
    pb.add_argument("--weights", default="0.2,0.2,0.2,0.2,0.2")
    pb.add_argument("--sigmas", default="0.1,0.12,0.15,0.18,0.2")
    pb.add_argument("--strike", type=float, default=100.0)
    pb.add_argument("--r", type=float, default=0.08)
    pb.add_argument("--rho", type=float, default=0.3)
    pb.add_argument("--instruments", choices=["basket", "assets"], default="basket",
                    help="hedge with the tradeable basket + bond, or a VECTOR "
                         "hedge (one phi per asset + bond; lower CV variance)")
    _add_train_flags(pb)
    _add_mesh_flag(pb)
    _add_oos_flag(pb)
    _add_quantile_flag(pb)
    _add_export_flag(pb)
    pb.set_defaults(fn=cmd_basket)

    pg = sub.add_parser(
        "greeks",
        help="pathwise AD greeks of a European option vs Black-Scholes",
    )
    pg.add_argument("--paths", type=int, default=1 << 17)
    pg.add_argument("--steps", type=int, default=52)
    pg.add_argument("--T", type=float, default=1.0)
    pg.add_argument("--s0", type=float, default=100.0)
    pg.add_argument("--strike", type=float, default=100.0)
    pg.add_argument("--r", type=float, default=0.08)
    pg.add_argument("--sigma", type=float, default=0.15)
    pg.add_argument("--option-type", choices=["call", "put"], default="call")
    pg.add_argument("--seed", type=int, default=1234)
    pg.add_argument("--gamma-bump", type=float, default=0.01,
                    help="relative spot bump of the CRN gamma difference")
    pg.add_argument("--json", action="store_true")
    pg.set_defaults(fn=cmd_greeks)

    pa = sub.add_parser(
        "asian",
        help="arithmetic-Asian call with the exact geometric control variate",
    )
    pa.add_argument("--paths", type=int, default=1 << 17)
    pa.add_argument("--avg-dates", type=int, default=52)
    pa.add_argument("--steps-per-avg", type=int, default=7)
    pa.add_argument("--T", type=float, default=1.0)
    pa.add_argument("--s0", type=float, default=100.0)
    pa.add_argument("--strike", type=float, default=100.0)
    pa.add_argument("--r", type=float, default=0.08)
    pa.add_argument("--sigma", type=float, default=0.15)
    pa.add_argument("--seed", type=int, default=1234)
    pa.add_argument("--json", action="store_true")
    pa.set_defaults(fn=cmd_asian)

    pbar = sub.add_parser(
        "barrier",
        help="down-and-out call: bridge-corrected QMC vs the reflection "
             "closed form",
    )
    pbar.add_argument("--paths", type=int, default=1 << 17)
    pbar.add_argument("--monitor-dates", type=int, default=52)
    pbar.add_argument("--barrier", type=float, default=90.0)
    pbar.add_argument("--T", type=float, default=1.0)
    pbar.add_argument("--s0", type=float, default=100.0)
    pbar.add_argument("--strike", type=float, default=100.0)
    pbar.add_argument("--r", type=float, default=0.08)
    pbar.add_argument("--sigma", type=float, default=0.25)
    pbar.add_argument("--naive", action="store_true",
                      help="knot-only monitoring (measures the bias the "
                           "bridge correction removes)")
    pbar.add_argument("--seed", type=int, default=1234)
    pbar.add_argument("--json", action="store_true")
    pbar.set_defaults(fn=cmd_barrier)

    plb = sub.add_parser(
        "lookback",
        help="lookback call (fixed or floating strike): exact bridge-"
             "extreme QMC vs the Conze-Viswanathan / Goldman-Sosin-Gatto "
             "closed forms",
    )
    plb.add_argument("--paths", type=int, default=1 << 17)
    plb.add_argument("--monitor-dates", type=int, default=13)
    plb.add_argument("--floating", action="store_true",
                     help="floating strike S_T - min S (default: fixed "
                          "strike on the running max)")
    plb.add_argument("--T", type=float, default=1.0)
    plb.add_argument("--s0", type=float, default=100.0)
    plb.add_argument("--strike", type=float, default=110.0)
    plb.add_argument("--r", type=float, default=0.08)
    plb.add_argument("--sigma", type=float, default=0.25)
    plb.add_argument("--naive", action="store_true",
                     help="knot-only extreme (measures the low bias the "
                          "bridge sampling removes)")
    plb.add_argument("--seed", type=int, default=1234)
    plb.add_argument("--json", action="store_true")
    plb.set_defaults(fn=cmd_lookback)

    pv = sub.add_parser(
        "surface",
        help="European price / implied-vol surface from ONE Sobol path set",
    )
    pv.add_argument("--paths", type=int, default=1 << 17)
    pv.add_argument("--strikes", default="80,90,95,100,105,110,120",
                    help="comma-separated strike list")
    pv.add_argument("--maturities", type=int, default=13,
                    help="equally spaced maturities out to T")
    pv.add_argument("--steps-per-maturity", type=int, default=4)
    pv.add_argument("--T", type=float, default=1.0)
    pv.add_argument("--s0", type=float, default=100.0)
    pv.add_argument("--r", type=float, default=0.08)
    pv.add_argument("--sigma", type=float, default=0.15)
    pv.add_argument("--option-type", choices=["call", "put"], default="call")
    pv.add_argument("--seed", type=int, default=1234)
    pv.add_argument("--json", action="store_true")
    pv.set_defaults(fn=cmd_surface)

    pm = sub.add_parser(
        "bermudan",
        help="Bermudan option price by Sobol-QMC Longstaff-Schwartz LSM "
             "vs the CRR binomial oracle",
    )
    pm.add_argument("--paths", type=int, default=1 << 17)
    pm.add_argument("--exercise-dates", type=int, default=50)
    pm.add_argument("--steps-per-exercise", type=int, default=4)
    pm.add_argument("--T", type=float, default=1.0)
    pm.add_argument("--s0", type=float, default=36.0)
    pm.add_argument("--strike", type=float, default=40.0)
    pm.add_argument("--r", type=float, default=0.06)
    pm.add_argument("--sigma", type=float, default=0.2)
    pm.add_argument("--option-type", choices=["call", "put"], default="put")
    pm.add_argument("--seed", type=int, default=1234)
    pm.add_argument("--json", action="store_true")
    pm.set_defaults(fn=cmd_bermudan)

    px = sub.add_parser(
        "export",
        help="train a hedge pipeline and export the policy as a serve bundle",
    )
    px.add_argument("--pipeline", choices=["euro", "heston", "pension"],
                    default="euro")
    px.add_argument("--out", required=True, help="bundle directory to write")
    px.add_argument("--paths", type=int, default=4096)
    px.add_argument("--steps", type=int, default=364)
    px.add_argument("--rebalance-every", type=int, default=7)
    px.add_argument("--T", type=float, default=1.0)
    px.add_argument("--aot", action="store_true",
                    help="also compile + serialize the per-bucket serving "
                         "set into the bundle (orp_tpu_torch/aot: the sm_90a "
                         "libraries and a CUDA graph per bucket): a cold serve "
                         "process then runs ZERO nvcc builds; needs the card")
    px.add_argument("--aot-buckets", default="8,16,32,64,128,256,512,1024",
                    help="with --aot: request sizes to ship executables for "
                         "(each rounds up to its power-of-two bucket; the "
                         "default covers every bucket the serve-bench "
                         "schedule and its batcher bursts can reach)")
    px.add_argument("--aot-mesh", default="1", metavar="N[,M…]",
                    help="with --aot: mesh sizes (topologies) to ship "
                         "executable sets for — one aot/<topo>/ set per "
                         "size (1 = single device, card only; N > 1 = a "
                         "manifest of the N-rank mesh's padded buckets, whose "
                         "ranks capture their shard's graphs at load)")
    _add_train_flags(px)
    px.set_defaults(fn=cmd_export)

    pw = sub.add_parser(
        "warm",
        help="pre-populate the persistent kernel-build cache: build the "
             "fused walk's library and time its CUDA-graph captures "
             "for a pipeline/shape without simulating or training (the "
             "next real run of the same config runs no nvcc); needs the card",
    )
    pw.add_argument("--pipeline", choices=["euro", "heston", "pension"],
                    default="euro")
    pw.add_argument("--paths", type=int, default=1 << 20)
    pw.add_argument("--steps", type=int, default=364)
    pw.add_argument("--rebalance-every", type=int, default=7)
    pw.add_argument("--T", type=float, default=1.0)
    pw.add_argument("--unconstrained", action="store_true",
                    help="euro pipeline: warm the free-psi head's program "
                         "(matches `orp euro --unconstrained`, the "
                         "north-star benchmark config)")
    pw.add_argument("--cache-dir", default=None,
                    help="persistent cache directory (default: "
                         "aot.cache.resolve_cache_dir(): env "
                         "ORP_TORCH_CACHE_DIR, else build/orp_tpu_torch)")
    _add_train_flags(pw)
    pw.set_defaults(fn=cmd_warm)

    ppr = sub.add_parser(
        "profile",
        help="run a workload under the performance observatory: device-"
             "time attribution (queue vs device per dispatch, host vs "
             "device per span), per-stage compile seconds, FLOP ledger + "
             "roofline fractions — one run, no cold/warm pair; "
             "--trace-dir additionally emits a torch.profiler Chrome "
             "trace with obs-span-named regions (subsumes "
             "tools/profile_north_star.py)",
    )
    ppr.add_argument("--workload", choices=["north-star", "serve"],
                     default="north-star",
                     help="north-star: the 1M-path 52-date hedge walk by "
                          "stages; serve: a request schedule through a "
                          "bundle's engine with the per-bucket "
                          "queue/device table")
    ppr.add_argument("--paths-log2", type=int, default=20,
                     help="north-star path count as a power of two")
    ppr.add_argument("--bundle", default=None,
                     help="policy bundle directory (required for "
                          "--workload serve)")
    ppr.add_argument("--trace-dir", default=None, metavar="DIR",
                     help="run under torch.profiler (CPU and CUDA "
                          "activities) and leave its Chrome trace in "
                          "DIR/trace.json (obs spans name the regions); "
                          "needs the card")
    ppr.add_argument("--quick", action="store_true",
                     help="CI smoke shape: 2^10 paths / a handful of "
                          "requests, same stages, same record fields")
    ppr.add_argument("--ledger", default=None,
                     help="append the run's stage walls to this "
                          "orp-perf-v1 ledger (default: none; a relative "
                          "path resolves against the working directory; "
                          "the checkout's root ledger is refused)")
    ppr.add_argument("--json", action="store_true",
                     help="emit the breakdown record as one JSON line")
    _add_telemetry_flag(ppr)
    ppr.set_defaults(fn=cmd_profile)

    ppg = sub.add_parser(
        "perf-gate",
        help="noise-aware perf-regression gate against an orp-perf-v1 "
             "ledger (--ledger): "
             "median outside k*IQR of the matching-fingerprint history "
             "(and past a relative floor) exits 1 in flag-speak; "
             "container noise stays green; under-min-repeats refuses "
             "(exit 2)",
    )
    ppg.add_argument("--ledger", required=True,
                     help="the orp-perf-v1 ledger to judge against (no "
                          "default; the checkout's root ledger is refused)")
    ppg.add_argument("--bundle", default=None,
                     help="measure a serve phase NOW over this bundle, "
                          "append it, and gate it (otherwise the ledger's "
                          "newest matching record is judged)")
    ppg.add_argument("--workload", default=None,
                     help="without --bundle: select the ledger workload "
                          "to judge (default: the newest record)")
    ppg.add_argument("--phase", default=None,
                     help="without --bundle: select the ledger phase")
    ppg.add_argument("--repeats", type=int, default=5,
                     help="with --bundle: timed measurement repeats")
    ppg.add_argument("--evals", type=int, default=32,
                     help="with --bundle: engine evaluations per repeat")
    ppg.add_argument("--rows", type=int, default=64,
                     help="with --bundle: rows per evaluation")
    ppg.add_argument("--k", type=float, default=4.0,
                     help="noise-band multiplier: regression = median "
                          "outside k*IQR of history AND past the "
                          "relative floor")
    ppg.add_argument("--min-repeats", type=int, default=3,
                     help="refuse (exit 2) when either side carries fewer "
                          "repeats than this — a one-draw median has no "
                          "noise band to judge against")
    ppg.add_argument("--json", action="store_true",
                     help="emit the verdict as one JSON line")
    _add_telemetry_flag(ppg)
    ppg.set_defaults(fn=cmd_perf_gate)

    psb = sub.add_parser(
        "serve-bench",
        help="benchmark the serving path of an exported bundle "
             "(bucketed engine + micro-batcher); writes the record to "
             "--out",
    )
    psb.add_argument("--bundle", required=True, help="bundle directory "
                     "(orp export / --export-dir output)")
    psb.add_argument("--requests", type=int, default=200)
    psb.add_argument("--batch-sizes", default="1,7,64,1000",
                     help="comma-separated request sizes the schedule cycles")
    psb.add_argument("--batcher-requests", type=int, default=256,
                     help="single-row burst size for the batcher phase")
    psb.add_argument("--max-wait-us", type=float, default=500.0,
                     help="batcher idle-device coalescing window")
    psb.add_argument("--sweep-concurrency", default="1,2,4",
                     help="comma-separated submitter-thread counts for the "
                          "sustained concurrency sweep ('' skips the sweep)")
    psb.add_argument("--sweep-requests", type=int, default=2048,
                     help="total single-row requests per sweep level")
    psb.add_argument("--out", required=True,
                     help="record file to write ('' skips the file; the "
                          "record always prints as one JSON line)")
    psb.add_argument("--mesh", type=int, default=None, metavar="N",
                     help="serve every phase on an N-rank batch-sharded "
                          "engine (rows sharded over a ('paths',) mesh, one "
                          "process a rank: torchrun --nproc-per-node N)")
    psb.add_argument("--mesh-sweep", default="", metavar="N,M…",
                     help="after the main phases, measure big-batch engine "
                          "rows/s at each mesh size and pin the served bits "
                          "equal across topologies ('' skips)")
    psb.add_argument("--mesh-sweep-rows", type=int, default=1 << 15,
                     help="batch rows per mesh-sweep evaluation")
    psb.add_argument("--degrade-at", type=int, default=None, metavar="N",
                     help="topology-degradation drill: inject a device loss "
                          "at request N of a single-row stream on the "
                          "largest available mesh (or --mesh); records "
                          "mttr_ms (drain→rebuild→replay wall), the failure "
                          "count during the window and a post-recovery "
                          "bits-equal pin vs the single-device engine")
    psb.add_argument("--degrade-requests", type=int, default=64,
                     help="stream length of the degradation drill")
    psb.add_argument("--degrade-survivors", type=int, default=None,
                     help="device count the injected loss reports alive "
                          "(default: mesh size minus one)")
    psb.add_argument("--ingest", action="store_true",
                     help="append the columnar-ingest sweep: per-request vs "
                          "submit_block vs gateway-loopback at each "
                          "--ingest-blocks size, bits pinned equal across "
                          "lanes; promotes submit_ns_per_row / "
                          "ingest_rows_per_s to record fields and fails if "
                          "columnar does not beat the per-request path. "
                          "Also measures + gates (≤5%%) the trace_overhead "
                          "AND drift_overhead per-block bills, and embeds "
                          "the bundle's orp-quality-v1 hedge-error record "
                          "when it bakes a validation set")
    psb.add_argument("--ingest-rows", type=int, default=4096,
                     help="total rows per ingest lane (must divide by every "
                          "block size)")
    psb.add_argument("--ingest-blocks", default="1,64,1024",
                     help="comma-separated block sizes for the ingest sweep")
    psb.add_argument("--gateway-drill", action="store_true",
                     help="append the gateway-kill chaos drill: a "
                          "ResilientGatewayClient streams sequenced frames, "
                          "the gateway is killed right after admitting "
                          "frame --drill-kill-at and restarted on the same "
                          "port; records frame-level MTTR, rows_lost "
                          "(contract 0), duplicate_serves (contract 0) and "
                          "a bits-equal pin vs an uninterrupted run — the "
                          "phase FAILS when any contract is violated")
    psb.add_argument("--drill-blocks", type=int, default=64,
                     help="frames the drill client streams")
    psb.add_argument("--drill-rows", type=int, default=256,
                     help="rows per drill frame")
    psb.add_argument("--drill-kill-at", type=int, default=None, metavar="K",
                     help="admitted-frame count at which the gateway dies "
                          "(default: a third of --drill-blocks)")
    psb.add_argument("--fleet", action="store_true",
                     help="append the horizontal-fleet phase: N in-process "
                          "fleet gateways (FleetHost routing tables) fan "
                          "frames out to M serve replicas at each "
                          "--fleet-replicas count — aggregate rows/s + p99 "
                          "per count, a routing-agreement pin across "
                          "gateways, the cross-connection coalescing "
                          "bitwise pin, and (at the largest count) the "
                          "kill-one-replica drill with fleet-level MTTR, "
                          "rows_lost 0 and duplicate_serves 0; the phase "
                          "FAILS when any contract is violated")
    psb.add_argument("--fleet-replicas", default="1,2,4",
                     help="comma-separated replica counts the fleet phase "
                          "measures")
    psb.add_argument("--fleet-gateways", type=int, default=2,
                     help="fleet gateway processes fanning traffic out")
    psb.add_argument("--fleet-tenants", type=int, default=6,
                     help="tenant names spread over the replicas")
    psb.add_argument("--fleet-blocks", type=int, default=10,
                     help="blocks each tenant streams per measurement")
    psb.add_argument("--fleet-rows", type=int, default=64,
                     help="rows per fleet block")
    psb.add_argument("--density", action="store_true",
                     help="append the tenant-density sweep: publish "
                          "--density-tenants distinct catalog tenants into "
                          "a content-addressed store (one shared policy — "
                          "the dedup ratio is measured, gated > 1) and "
                          "serve them through one host capped at "
                          "--density-max-live engines; records cold/warm/"
                          "hot activation histograms, the tenants-at-p99 "
                          "curve against --density-budget-ms, and pins "
                          "warm re-activation at ZERO nvcc runs and graph "
                          "captures — the "
                          "phase FAILS when either contract is violated")
    psb.add_argument("--density-tenants", type=int, default=1000,
                     help="distinct catalog tenants the density sweep "
                          "publishes and touches")
    psb.add_argument("--density-rows", type=int, default=8,
                     help="rows per density request")
    psb.add_argument("--density-max-live", type=int, default=8,
                     help="live-engine cap of the density host (evictions "
                          "drive the warm tier)")
    psb.add_argument("--pilot", action="store_true",
                     help="append the closed-loop model-CI/CD drill "
                          "(orp_tpu_torch/pilot): a synthetic regime shift trips "
                          "the drift monitor of a live host; the pilot "
                          "recalibrates (RQMC-bootstrap bands), warm-start "
                          "retrains and canary-promotes through the zero-"
                          "downtime swap — one sabotaged cycle must REJECT "
                          "with the incumbent bitwise-untouched, one "
                          "honest cycle must promote under concurrent "
                          "traffic with rows_lost=0, one mid-training kill "
                          "must resume from the journal bitwise-"
                          "identically; the phase raises on any violated "
                          "contract (--quick shrinks it to smoke size)")
    psb.add_argument("--density-budget-ms", type=float, default=500.0,
                     help="cold-activation p99 budget the tenants-within-"
                          "budget headline is scored against")
    psb.add_argument("--precision", action="store_true",
                     help="append the raw-speed matrix: the precision-tier "
                          "sweep (f32/bf16/int8 rows/s with BANDED accuracy "
                          "pins and the quality-banded reload_tenant "
                          "promotion drill), the mixed-date megakernel A/B "
                          "(fused single dispatch vs loop-of-buckets, f32 "
                          "pinned BITWISE) and the ragged-vs-pow2 batching "
                          "A/B (measured serve/pad_waste_rows collapse at "
                          "bitwise-equal bits); the phases FAIL on any "
                          "violated pin (--quick shrinks the row counts)")
    psb.add_argument("--precision-rows", type=int, default=4096,
                     help="rows per precision-tier timed evaluation")
    psb.add_argument("--precision-band", type=float, default=0.05,
                     help="relative hedge-error regression the tier "
                          "promotion drill tolerates (the reload_tenant "
                          "quality band)")
    psb.add_argument("--quick", action="store_true",
                     help="CI smoke shape: shrink the ingest sweep, the "
                          "gateway drill and the fleet phase to tiny "
                          "row/block counts (same lanes, same bitwise and "
                          "speedup gates)")
    psb.add_argument("--repeats", type=int, default=3,
                     help="measurement repeats for the headline phases "
                          "(sweep, ingest, drill): every committed "
                          "headline is a median with an IQR, never one "
                          "draw")
    psb.add_argument("--ledger", default=None,
                     help="append the run's headline phases to this "
                          "orp-perf-v1 ledger (default: none; a relative "
                          "path resolves next to --out, so the ledger "
                          "lives beside the bench record it seeds; the "
                          "checkout's root ledger is refused) — the "
                          "history `perf-gate` compares against")
    psb.add_argument("--prewarm", action="store_true",
                     help="assert the warmup contract: fail loudly if any "
                          "measured request paid a first-touch bucket "
                          "compile (cache_misses_after_warmup must be 0)")
    psb.add_argument("--json", action="store_true",
                     help="accepted for uniformity with the other "
                          "subcommands; the record always prints as JSON")
    _add_telemetry_flag(psb)
    psb.set_defaults(fn=cmd_serve_bench)

    pgw = sub.add_parser(
        "serve-gateway",
        help="serve a bundle over the orp-ingest-v1 TCP front: length-"
             "prefixed columnar frames in, columnar replies out — the "
             "non-Python-per-row ingest plane (probe with "
             "`orp doctor --gateway host:port`)",
    )
    pgw.add_argument("--bundle", default=None,
                     help="policy bundle directory to serve (omit with "
                          "--fleet: a router gateway serves no policy "
                          "itself)")
    pgw.add_argument("--fleet", default=None, metavar="TOPOLOGY",
                     help="run as a FLEET gateway instead of a serving "
                          "one: route every frame to its tenant's replica "
                          "per the rendezvous table over the topology.json "
                          "replica set (health-driven — replicas are "
                          "probed via the HEALTH wire kind and unhealthy "
                          "ones' tenants remap automatically); the "
                          "forwarding lane is the reconnect-replay client, "
                          "so replica blips and deaths keep "
                          "exactly-once-serve")
    pgw.add_argument("--tenant", default="default",
                     help="tenant name frames route to when their tenant "
                          "field is empty (16 ASCII bytes max on the wire)")
    pgw.add_argument("--addr", default="127.0.0.1",
                     help="bind address (default loopback; bind 0.0.0.0 "
                          "only behind your own transport security)")
    pgw.add_argument("--port", type=int, default=7433,
                     help="bind port (0 = pick a free one; see "
                          "--ready-file)")
    pgw.add_argument("--deadline-ms", type=float, default=None,
                     help="per-row queue-age budget (guard policy): rows "
                          "aged past it come back status shed-deadline")
    pgw.add_argument("--watermark", type=int, default=None,
                     help="row-counted admission watermark: past it a "
                          "block's tail rows come back status "
                          "shed-watermark")
    pgw.add_argument("--max-pending", type=int, default=None,
                     help="tenant quota in rows: past it a block's tail "
                          "rows come back status shed-quota")
    pgw.add_argument("--max-live-engines", type=int, default=4)
    pgw.add_argument("--frame-deadline-s", type=float, default=30.0,
                     help="partial-frame read deadline: a client holding "
                          "half a frame past it gets an ERROR frame and a "
                          "reset, freeing the handler (a sequenced client "
                          "replays the frame on reconnect)")
    pgw.add_argument("--max-inflight", type=int, default=8,
                     help="per-connection unanswered-frame bound: past it "
                          "sequenced frames are refused with a BUSY frame "
                          "(backpressure — the producer resends; no rows "
                          "shed)")
    pgw.add_argument("--device-profile", action="store_true",
                     help="enable device-time attribution for this serving "
                          "process (orp_tpu_torch/obs/devprof): per-bucket "
                          "queue/device seconds + the live device-"
                          "utilization gauge on the scrape path — the "
                          "`orp top` dev-util column; measured overhead "
                          "≤5%% of the columnar lane, zero when off")
    pgw.add_argument("--metrics-port", type=int, default=None, metavar="P",
                     help="also serve plain-HTTP Prometheus scrape on this "
                          "port (GET /metrics = the live exposition, GET "
                          "/healthz = the JSON health doc; 0 picks a free "
                          "port, reported in the startup line). The same "
                          "exposition answers the in-band METRICS wire "
                          "kind on the ingest port either way")
    pgw.add_argument("--max-seconds", type=float, default=None,
                     help="serve for this long then drain and exit "
                          "(default: until SIGTERM/ctrl-C — both run the "
                          "graceful zero-loss drain)")
    pgw.add_argument("--ready-file", default=None, metavar="PATH",
                     help="write 'host port' to PATH once listening (how a "
                          "supervisor or loopback harness learns a "
                          "--port 0 binding)")
    pgw.add_argument("--json", action="store_true",
                     help="emit the bound address as a JSON line")
    _add_telemetry_flag(pgw)
    pgw.set_defaults(fn=cmd_serve_gateway)

    pt = sub.add_parser(
        "top",
        help="live serving dashboard off a running gateway: scrape the "
             "METRICS/HEALTH wire kinds and print req/s, p99, queue "
             "depth, shed/BUSY rates and the per-tenant table",
    )
    pt.add_argument("--gateway", default=None, metavar="HOST:PORT",
                    help="the running `orp serve-gateway` ingest address")
    pt.add_argument("--fleet", default=None, metavar="TOPOLOGY",
                    help="aggregate ALL of topology.json's gateways into "
                         "one fleet table instead of scraping one: fleet "
                         "req/s (two-scrape rates summed), per-gateway "
                         "p99/queue/shed columns, and the routing-table "
                         "version agreement line")
    pt.add_argument("--interval", type=float, default=1.0,
                    help="seconds between the two scrapes that turn "
                         "lifetime counters into rates (and the refresh "
                         "period under --watch)")
    pt.add_argument("--watch", action="store_true",
                    help="keep refreshing until ctrl-C instead of one shot")
    pt.add_argument("--timeout-s", type=float, default=5.0,
                    help="bound on the scrape connect and every recv")
    pt.add_argument("--json", action="store_true",
                    help="emit the digested snapshot as one JSON line")
    pt.set_defaults(fn=cmd_top)

    ptr = sub.add_parser(
        "trace",
        help="reconstruct one frame's span tree (decode → queue → "
             "dispatch → resolve → encode) from a telemetry bundle's "
             "events.jsonl by trace id",
    )
    ptr.add_argument("trace_id",
                     help="the trace id the producer stamped (16-hex-digit "
                          "canonical spelling; 0x-hex and decimal accepted)")
    ptr.add_argument("--events", required=True, metavar="DIR|FILE",
                     help="the gateway's --telemetry DIR (or its "
                          "events.jsonl directly)")
    ptr.add_argument("--json", action="store_true",
                     help="emit the span tree + segment summary as JSON")
    ptr.set_defaults(fn=cmd_trace)

    pdoc = sub.add_parser(
        "doctor",
        help="one-shot environment/bundle self-check (devices + topology "
             "fingerprint, compile-cache dir writable, bundle format/digest/"
             "AOT-topology coverage, obs sink writable) with flag-speak "
             "fixes — the first thing to run on a broken pod",
    )
    pdoc.add_argument("--bundle", default=None,
                      help="policy bundle directory to verify (format, "
                           "fingerprint, policy-step digest, AOT coverage)")
    pdoc.add_argument("--mesh", type=int, default=None, metavar="N",
                      help="check AOT topology coverage and device count "
                           "for an N-device mesh (default: single device)")
    pdoc.add_argument("--cache-dir", default=None,
                      help="kernel-build cache dir to probe (default: the "
                           "enable_persistent_cache resolution)")
    pdoc.add_argument("--telemetry-dir", default=None, metavar="DIR",
                      help="probe DIR as an obs sink target (--telemetry "
                           "runs stream events.jsonl there live)")
    pdoc.add_argument("--gateway", default=None, metavar="HOST:PORT",
                      help="probe a running ingest gateway: TCP connect + "
                           "orp-ingest PING/PONG round trip")
    pdoc.add_argument("--metrics", default=None, metavar="HOST:PORT",
                      help="probe a gateway's LIVE scrape (METRICS wire "
                           "kind): the exposition must parse and carry the "
                           "core serve series (requests/latency, queue "
                           "age, sheds); also triggers the serving "
                           "process's flight-recorder dump")
    pdoc.add_argument("--quality", default=None, metavar="BUNDLE",
                      help="probe a bundle's model-health plumbing: baked "
                           "per-feature baseline sketch + pinned "
                           "validation-set fingerprint present, and a "
                           "shrunken hedge-quality estimate produces a "
                           "parseable orp-quality-v1 record with a nonzero "
                           "RQMC confidence interval (the preflight for "
                           "drift monitoring and reload quality_band gates)")
    pdoc.add_argument("--perf", default=None, metavar="LEDGER",
                      help="probe the performance-observatory plumbing: "
                           "torch.profiler importable + trace dir writable, "
                           "the orp-perf-v1 ledger LEDGER (a path; no "
                           "default) parseable and appendable, "
                           "and the roofline peak table covering this "
                           "device_kind (flag-speak fix line when "
                           "fraction-of-peak falls back to the measured-"
                           "matmul peak)")
    pdoc.add_argument("--fleet", default=None, metavar="TOPOLOGY",
                      help="probe a whole serve fleet from topology.json: "
                           "PING every replica and gateway, read each "
                           "gateway's routing view and verify "
                           "ROUTING-TABLE AGREEMENT (same tenant sample → "
                           "same replica from every gateway, same table "
                           "version) plus per-replica health ages")
    pdoc.add_argument("--store", default=None, metavar="ROOT",
                      help="probe a content-addressed bundle store: catalog "
                           "parseable, CAS directory writable, and the "
                           "catalog closure free of dangling blob "
                           "references (orphan blobs report as reclaimable "
                           "via `orp store gc`, not as failures)")
    pdoc.add_argument("--pilot", default=None, metavar="JOURNAL",
                      help="probe a closed-loop pilot from its orp-pilot-v1 "
                           "journal: parseable (torn tail tolerated) and "
                           "appendable, the last cycle's verdict present on "
                           "its hash-linked promotions chain with every "
                           "link verifying, and the trigger sources named "
                           "by the journaled config reachable (events_dir "
                           "readable, prices_path >= calib_window rows)")
    pdoc.add_argument("--gateway-timeout-s", type=float, default=5.0,
                      help="bound on the gateway probe's connect and every "
                           "recv — a dead-but-accepting endpoint fails "
                           "within it instead of blocking")
    pdoc.add_argument("--json", action="store_true",
                      help="machine-readable report")
    pdoc.set_defaults(fn=cmd_doctor)

    pst = sub.add_parser(
        "store",
        help="operate a content-addressed bundle store (orp_tpu_torch/store): "
             "put publishes an exported bundle under catalog tenant "
             "names (identical trees dedup to shared blobs), stat "
             "reports tenants/blobs/dedup-ratio/orphans, gc reclaims "
             "unreferenced blobs — never anything the catalog points at",
    )
    pst.add_argument("action", choices=("put", "stat", "gc"),
                     help="put: publish --bundle under --tenants; "
                          "stat: occupancy + dedup report; "
                          "gc: drop unreferenced blobs")
    pst.add_argument("--root", required=True,
                     help="store root directory (holds blobs/, "
                          "catalog.json and the shared warm/ cache)")
    pst.add_argument("--bundle", default=None,
                     help="exported bundle directory to publish "
                          "(`orp export --out`; put only)")
    pst.add_argument("--tenants", default=None, metavar="NAME[,NAME…]",
                     help="catalog names to publish the bundle under "
                          "(put only; one bundle, many tenants — the "
                          "whole-book shape)")
    pst.add_argument("--dry-run", action="store_true",
                     help="gc only: report what would be removed "
                          "without unlinking anything")
    pst.add_argument("--json", action="store_true",
                     help="machine-readable output")
    pst.set_defaults(fn=cmd_store)

    prep = sub.add_parser(
        "report",
        help="render a telemetered walk's training-convergence record "
             "(per-date loss trajectory, epochs/GN iterations, "
             "trainer-ladder rung, GN Gram conditioning) from a "
             "--telemetry bundle",
    )
    prep.add_argument("--events", required=True, metavar="DIR|FILE",
                      help="the training run's --telemetry DIR (or its "
                           "events.jsonl directly)")
    prep.add_argument("--json", action="store_true",
                      help="emit the merged record as one JSON line")
    prep.set_defaults(fn=cmd_report)

    pl = sub.add_parser(
        "lint",
        help="CUDA/H100-aware static analysis of orp_tpu_torch (host "
             "syncs, recompile and capture hazards, dtype drift, silent "
             "excepts, blocking dispatch loops, single-device "
             "assumptions, per-row ingest work, unbounded socket I/O, "
             "dynamic obs instrument names, unrecorded numeric "
             "acceptance gates, unblocked stop-clocks, bare writes in "
             "store/bundle persistence code, unobserved/lock-holding "
             "pilot transitions — the port's rule table in README.md — "
             "plus the project-wide --concurrency pass: guarded-by "
             "drift, blocking work under a lock, lock-order cycles — "
             "rules ORP020-ORP022); non-zero exit on findings",
    )
    from orp_tpu_torch.lint.__main__ import add_lint_arguments

    add_lint_arguments(pl)
    pl.set_defaults(fn=cmd_lint)

    pc = sub.add_parser(
        "calibrate",
        help="CIR calibration from a price CSV; --prices CSV runs the "
             "pilot's rolling-window form (full fit + RQMC-bootstrap CI "
             "bands on every parameter — the band a retrain trigger must "
             "leave)")
    pc.add_argument("csv", nargs="?", default=None,
                    help="price CSV (legacy point-estimate form)")
    pc.add_argument("--prices", default=None, metavar="CSV",
                    help="price CSV for the pilot form: CIRParams + mu + "
                         "sigma0 with 95%% RQMC-bootstrap confidence bands "
                         "(pilot/calibrate.py; --boot resamples)")
    pc.add_argument("--column", type=int, default=0)
    pc.add_argument("--skiprows", type=int, default=0)
    pc.add_argument("--window", type=int, default=40,
                    help="rolling-volatility window (both forms)")
    pc.add_argument("--boot", type=int, default=64,
                    help="bootstrap resamples per CI band (--prices form)")
    pc.add_argument("--years", type=float, default=10.0)
    pc.add_argument("--json", action="store_true")
    pc.set_defaults(fn=cmd_calibrate)

    ppl = sub.add_parser(
        "pilot",
        help="operate the closed-loop model-CI/CD plane (orp_tpu_torch/pilot): "
             "retrain files a manual retrain request into an orp-pilot-v1 "
             "journal (consumed by the controller's next poll, debounced "
             "through the shared cooldown); status renders the journal — "
             "last cycle, state, pending requests")
    ppl.add_argument("action", choices=("retrain", "status"),
                     help="retrain: file a trigger_request; "
                          "status: render the journal state")
    ppl.add_argument("--journal", required=True, metavar="PATH",
                     help="the pilot journal (PilotConfig.workdir/"
                          "pilot.jsonl)")
    ppl.add_argument("--tenant", default=None,
                     help="tenant the request targets (default: any — the "
                          "hub matches its own tenant)")
    ppl.add_argument("--reason", default=None,
                     help="free-text reason journaled with the request")
    ppl.add_argument("--json", action="store_true",
                     help="machine-readable output")
    ppl.set_defaults(fn=cmd_pilot)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # opt-in persistent kernel-build cache for ANY command:
    # ORP_TORCH_CACHE_DIR set in the environment routes every nvcc build and
    # library load of this run through the one cache entry point
    # (orp_tpu_torch/aot/cache.py); unset costs nothing
    from orp_tpu_torch.aot.cache import enable_from_env

    enable_from_env()
    ok = False
    try:
        out = _run(args)
        ok = True
        return out
    finally:
        if _GROUP_FORMED:
            # end the group this command formed, every rank together after a
            # run that succeeded: a rank that exits while its peer still holds
            # the group can abort in gloo's teardown (a follower of serve-bench
            # is done long before rank 0)
            import torch.distributed as dist

            _GROUP_FORMED.clear()
            if dist.is_initialized():
                if ok:
                    dist.barrier()
                dist.destroy_process_group()


def _run(args):
    tdir = getattr(args, "telemetry", None)
    if tdir:
        # one session around the whole command: the pipeline binds its config
        # fingerprint from inside (pipelines._bind_run_manifest), the session
        # drops events.jsonl + metrics.prom + manifest.json + flight.jsonl
        # in DIR; events stream live, metrics.prom is rewritten
        # periodically, and the SIGTERM hook below flushes the bundle before
        # a kill lands (SIGINT needs no hook — the KeyboardInterrupt unwinds
        # this context manager, which exports). A command that installs its
        # own SIGTERM handler afterwards (serve-gateway's graceful drain)
        # wins, and exits the session cleanly anyway
        from orp_tpu_torch import obs

        with obs.telemetry(tdir, manifest_extra={"cli_command": args.command}):
            obs.install_signal_flush()
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
