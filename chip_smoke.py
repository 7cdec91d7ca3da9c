#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``orp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero before its
last line):

1. card: ``nvidia-smi`` name and power limit; a CUDA device is required;
2. build: both CUDA kernels from ``orp_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, in parallel;
3. kernel vs plain version on the card: K1 (fused Sobol-GBM) at 65,536 and at
   1,048,576 paths x 364 steps, store 7, ``rtol=3e-5``; K2 (mixed-date head)
   on 1,048,576 rows over 52 dates under the fixture policy,
   ``rtol=1e-5, atol=1e-6``;
4. serve: the committed north-star policy through ``HedgeEngine``: mixed-date
   blocks of 1, 7 and 4,096 rows (held against the stored JAX outputs) and one
   bucketed ``evaluate``; then the main path, one 1,048,576-row request, with
   the launch counts set to 0 just before it: K2's count must move, K1's not;
5. replay: ``european_oos`` at 4,096 paths (held against the stored JAX
   report); then the main path, 1,048,576 fresh paths x 364 steps on the fused
   kernel with the counts set to 0 just before it: |bp error| of the
   OLS-martingale price vs Black-Scholes < 1bp, K1's count must move, K2's not;
6. times: each kernel and its plain version with CUDA events at the main
   path's shapes, beside the kernel's bound.

Output: a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz
INT32_OP_PER_S = 16.7e12        # 132 SMs x 64 INT32 lanes x 1.98 GHz

N_FULL = 1 << 20
N_STEPS, STORE = 364, 7
OOS_SEED = 4321


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def k1_bound_ms(n_paths: int, n_steps: int, store_every: int) -> tuple[float, str]:
    """Least time for the fused GBM: bytes (direction table in, knots out)
    against operations (int32 Sobol/scramble work, f32 AS241 + update)."""
    n_knots = n_steps // store_every + 1
    bytes_ = n_steps * 32 * 4 + n_knots * n_paths * 4
    # the XOR chain needs one op per set index bit: sum of popcounts of 0..n-1
    popcounts = sum(bin(i).count("1") for i in range(n_paths))
    # per path-step: 2 bit reversals, Laine-Karras (add + 4 mul/xor), bucket shift
    int_ops = n_steps * (popcounts + 12 * n_paths)
    # per path-step: bucket centre (3), update (3), AS241: central 33 ops on
    # 85% of draws (|u - 0.5| <= 0.425), tail 37 on 15%; per knot exp + mul
    f32_ops = n_paths * (n_steps * (6 + 0.85 * 33 + 0.15 * 37) + 2 * (n_knots - 1))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OP_PER_S, f32_ops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_bound_ms(model, n_rows: int, n_dates: int) -> tuple[float, str]:
    """Least time for the mixed-date head: rows in/out and params once, against
    the forward's f32 operations (2 per FMA, bias adds, LeakyReLU)."""
    sizes = model.layer_sizes
    bytes_ = n_rows * (4 + 4 * sizes[0] + 4 * sizes[-1]) + 4 * n_dates * model.n_params()
    flops = 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        flops += 2 * a * b + b + (2 * b if i < len(sizes) - 2 else 0)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = n_rows * flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA "
              "device", file=sys.stderr)
        return 2
    if not (HERE / "orp_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the orp_tpu_torch package is not beside chip_smoke.py",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(HERE))
    import numpy as np

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_oos
    from orp_tpu_torch.qmc import fused_gbm
    from orp_tpu_torch.serve import HedgeEngine, load_bundle, megakernel
    from orp_tpu_torch.utils import bs_call, cuda_build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(reports)} in {build_s:.2f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 3. kernel vs plain on the card --------------------------------------
    gbm_kw = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / N_STEPS, seed=OOS_SEED,
                  store_every=STORE, device=dev)
    k1_err = 0.0
    for n in (65_536, N_FULL):
        got = fused_gbm.gbm_log_fused(n, N_STEPS, **gbm_kw)
        torch.cuda.synchronize()
        want = fused_gbm.gbm_log_plain(n, N_STEPS, **gbm_kw)
        torch.cuda.synchronize()
        check(got.shape == (n, N_STEPS // STORE + 1), f"K1 shape {tuple(got.shape)}")
        torch.testing.assert_close(got, want, rtol=3e-5, atol=0.0)
        k1_err = max(k1_err, max_err(got, want))
        print(f"[K1] {n} x {N_STEPS} store {STORE}: max|kernel - plain| = "
              f"{max_err(got, want):.3e} (rtol 3e-5)", flush=True)
    del got, want

    policy = load_bundle(NORTH_STAR_POLICY)
    model, n_dates = policy.model, policy.n_dates
    p1 = {k: v.to(dev) for k, v in policy.backward.params1_by_date.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    dates = torch.randint(0, n_dates, (N_FULL,), device=dev, generator=gen, dtype=torch.int32)
    feats = (1.0 + 0.1 * torch.randn(N_FULL, 1, device=dev, generator=gen)).contiguous()
    packed = megakernel.pack_head_params(model, p1)
    got = megakernel.mixed_head_forward(model, p1, dates, feats, packed=packed)
    torch.cuda.synchronize()
    want = megakernel.mixed_head_plain(model, p1, dates, feats)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    k2_err = max_err(got, want)
    print(f"[K2] {N_FULL} rows x {n_dates} dates: max|kernel - plain| = {k2_err:.3e} "
          "(rtol 1e-5, atol 1e-6)", flush=True)
    bad = megakernel.mixed_head_forward(model, p1, torch.tensor([0, n_dates, -1], device=dev,
                                                                 dtype=torch.int32),
                                        feats[:3], packed=packed)
    check(bool(torch.isfinite(bad[0]).all()) and bool(torch.isnan(bad[1:]).all()),
          "K2 writes NaN rows for out-of-range dates")

    # -- 4. serve (main path: K2) ---------------------------------------------
    with np.load(NORTH_STAR_POLICY / "reference.npz") as z:
        ref = {k: z[k] for k in z.files}
    engine = HedgeEngine(policy)
    rng = np.random.default_rng(11)
    big_dates = rng.integers(0, n_dates, N_FULL).astype(np.int32)
    big_states = (1.0 + 0.1 * rng.standard_normal((N_FULL, 1))).astype(np.float32)
    big_prices = np.concatenate([big_states, np.full((N_FULL, 1), 0.0108, np.float32)], 1)
    t0 = time.perf_counter()
    for n in (1, 7):
        phi, psi, v = engine.evaluate_mixed_async(ref["dates"][:n], ref["states"][:n],
                                                  ref["prices"][:n]).result()
        check(phi.shape == psi.shape == v.shape == (n,), f"serve block of {n} rows")
        np.testing.assert_allclose(v, ref["v"][:n], rtol=1e-5, atol=1e-6)
    phi, psi, v = engine.evaluate_mixed_async(ref["dates"], ref["states"],
                                              ref["prices"]).result()
    for got_, k in ((phi, "phi"), (psi, "psi"), (v, "v")):
        np.testing.assert_allclose(got_, ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    d0 = int(ref["dates"][0])
    m = ref["dates"] == d0
    phi_d, _, v_d = engine.evaluate(d0, ref["states"][m], ref["prices"][m])
    np.testing.assert_allclose(v_d, ref["v"][m], rtol=1e-5, atol=1e-6)
    lat_ms = {}
    for n in (1, 4096):
        walls = []
        for _ in range(31):
            t1 = time.perf_counter()
            engine.evaluate_mixed_async(ref["dates"][:n], ref["states"][:n],
                                        ref["prices"][:n]).result()
            walls.append((time.perf_counter() - t1) * 1e3)
        lat_ms[n] = sorted(walls)[len(walls) // 2]
    # the main path's run: one 1M-row request, counts set to 0 just before it
    megakernel.mixed_head_forward.launches = 0
    fused_gbm.gbm_log_fused.launches = 0
    t1 = time.perf_counter()
    phi, psi, v = engine.evaluate_mixed_async(big_dates, big_states, big_prices).result()
    serve_s = [time.perf_counter() - t1]
    serve_launches = megakernel.mixed_head_forward.launches
    check(serve_launches > 0, "K2 (mixed_head) launched on the serve path")
    check(fused_gbm.gbm_log_fused.launches == 0, "serve path launches no K1")
    check(phi.shape == (N_FULL,) and bool(np.isfinite(phi).all() and np.isfinite(v).all()),
          "1M-row serve block finite")
    for _ in range(2):
        t1 = time.perf_counter()
        engine.evaluate_mixed_async(big_dates, big_states, big_prices).result()
        serve_s.append(time.perf_counter() - t1)
    serve_wall = time.perf_counter() - t0
    rows_s = N_FULL / sorted(serve_s)[1]
    print(f"[serve] blocks 1/7/4096/1048576 + evaluate(date {d0}): 4096-row block "
          f"matches the stored JAX outputs (rtol 1e-5, atol 1e-6); 1M-row block "
          f"{rows_s:,.0f} rows/s host-to-host (median of 3); request latency host-to-"
          f"host (median of 31): 1 row {lat_ms[1]:.3f} ms, 4096 rows {lat_ms[4096]:.3f} ms; "
          f"K2 launches in the 1M-row request {serve_launches}; {serve_wall:.2f} s", flush=True)

    # -- 5. replay (main path: K1) --------------------------------------------
    stored = json.loads((NORTH_STAR_POLICY / "reference.json").read_text())
    euro = EuropeanConfig(constrain_self_financing=False)
    train = TrainConfig(dual_mode="mse_only")
    small = european_oos(policy, euro, SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                                 rebalance_every=7, seed_fund=OOS_SEED,
                                                 engine="pallas"), train)
    for k in ("v0", "phi0", "v0_plain", "v0_cv", "cv_std", "acv_std"):
        np.testing.assert_allclose(getattr(small.report, k), stored[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(small.report.var_overall, stored["var_overall"], rtol=1e-4)
    small_bp = abs(small.report.v0_acv - stored["v0_acv"]) / stored["v0_acv"] * 1e4
    check(small_bp <= 0.05, f"4096-path v0_acv within 0.05bp of JAX ({small_bp:.4f}bp)")
    torch.cuda.synchronize()
    # the main path's run: counts set to 0 just before it
    fused_gbm.gbm_log_fused.launches = 0
    megakernel.mixed_head_forward.launches = 0
    t1 = time.perf_counter()
    res = european_oos(policy, euro, SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364,
                                               rebalance_every=7, seed_fund=OOS_SEED,
                                               engine="pallas"), train)
    torch.cuda.synchronize()
    oos_s = time.perf_counter() - t1
    replay_launches = fused_gbm.gbm_log_fused.launches
    check(replay_launches > 0, "K1 (fused_gbm) launched on the replay path")
    check(megakernel.mixed_head_forward.launches == 0, "replay path launches no K2")
    rep = res.report
    bs, _ = bs_call(100.0, 100.0, 0.08, 0.15, 1.0)
    bp_err = (rep.v0_acv - bs) / bs * 1e4
    var99 = float(rep.var_overall[rep.var_qs.index(0.99)])
    fields = [rep.v0, rep.phi0, rep.psi0, rep.v0_plain, rep.v0_cv, rep.cv_std, rep.v0_acv,
              rep.acv_std, *rep.var_overall]
    check(all(math.isfinite(x) for x in fields), "report fields finite")
    check(res.backward.values.shape == (N_FULL, n_dates + 1), "replayed ledger shape")
    check(abs(bp_err) < 1.0, f"|bp_err| {bp_err:.4f} < 1bp")
    print(f"[replay] 4096 paths match the stored JAX report (|dv0_acv| {small_bp:.4f}bp); "
          f"{N_FULL} paths x {N_STEPS} steps: v0_acv {rep.v0_acv:.6f} vs BS {bs:.6f} "
          f"bp_err {bp_err:+.4f}, cv_std {rep.cv_std:.4f}, acv_std {rep.acv_std:.4f}, "
          f"var99 {var99:.4f}, v0_network {rep.v0:.4f}; wall {oos_s:.2f} s; K1 launches "
          f"{replay_launches}", flush=True)
    del res

    # -- 6. times at the main path's shapes -----------------------------------
    k1 = lambda: fused_gbm.gbm_log_fused(N_FULL, N_STEPS, **gbm_kw)  # noqa: E731
    k1_plain = lambda: fused_gbm.gbm_log_plain(N_FULL, N_STEPS, **gbm_kw)  # noqa: E731
    k2 = lambda: megakernel.mixed_head_forward(model, p1, dates, feats,  # noqa: E731
                                               packed=packed)
    k2_plain = lambda: megakernel.mixed_head_plain(model, p1, dates, feats)  # noqa: E731
    k1_plain_ms = cuda_ms(k1_plain, reps=1, rounds=3)
    k1_ms = cuda_ms(k1, reps=10)
    k1_ms_2 = cuda_ms(k1, reps=10)
    k2_plain_ms = cuda_ms(k2_plain, reps=2, rounds=3)
    k2_ms = cuda_ms(k2, reps=200)
    k2_ms_2 = cuda_ms(k2, reps=200)
    k1_bound, k1_by = k1_bound_ms(N_FULL, N_STEPS, STORE)
    k2_bound, k2_by = k2_bound_ms(model, N_FULL, n_dates)
    print(f"[times] K1 {k1_ms:.4f} / {k1_ms_2:.4f} ms (bound {k1_bound:.4f} ms by {k1_by}, "
          f"plain {k1_plain_ms:.2f} ms); K2 {k2_ms:.5f} / {k2_ms_2:.5f} ms (bound "
          f"{k2_bound:.5f} ms by {k2_by}, plain {k2_plain_ms:.3f} ms); inputs L2-warm",
          flush=True)

    kernels = {"kernels": [
        {"name": "fused_gbm", "route": "cuda", "source": "orp_tpu_torch/csrc/fused_gbm.cu",
         "replaces": "orp_tpu/qmc/pallas_sobol.py:199", "launches": replay_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "mixed_head", "route": "cuda", "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": serve_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
