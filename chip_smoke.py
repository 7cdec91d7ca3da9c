#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``orp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero before its
last line):

1. card: ``nvidia-smi`` name and power limit; a CUDA device is required;
2. build: every CUDA kernel from ``orp_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all at once (``mixed_head`` in a
   process of its own, waited for before K2's first check: its long build
   runs beside the path kernels' checks and phases 5-9, and K2's checks of
   phase 3 and phase 4 run after phase 9);
3. kernel vs plain version on the card: K1 (fused Sobol-GBM, the GbmLog step
   of the multi-factor kernel) at 33, 65,536, 1,048,576 and 2,097,185 paths
   x 364 steps, store 7, and at 65,536 x 364 stored every step (365 knots,
   past the reference's single-call cap), ``rtol=3e-5``;
   K3b (Heston QE-M) and K3a (Heston Euler) at the 1M and 65,536-path
   shapes, store 7 (S ``rtol=3e-5``; QE v ``rtol=2e-3,
   atol=1e-6``; Euler v ``rtol=3e-5, atol=3e-6``); K2 (mixed-date head) on
   1,048,576 rows over 52 dates, ``rtol=1e-5, atol=1e-6``, and K2's bf16
   kernel at the same shapes against ``mixed_head_plain`` in bf16 by
   ``BF16_RULE`` (>= 99.9% of elements bitwise, each within 4 bf16 spacings)
   and bitwise against its documented order (``mixed_head_bf16_order``);
3b. K3c (the pension system) against ``pension_plain`` on the card at 65,536
    paths x 1,000 steps, store 25, in all four variants (constant-vol or SV
    fund, ``normal`` or ``inversion`` thinning), and at 1,048,576 paths in the
    main path's variant (constant vol, inversion): Y, v and lambda bitwise
    equal, and the survivors N equal on every knot (inside ``test_pallas``'s
    rtol 3e-5, which holds the plain version to the JAX package); the
    population and fund laws from the kernel's 1M paths (``|E[N_T] - 8616| <
    40``, ``|sd(N_T) - 132| < 30``, ``|E[Y_T] - e^0.8| < 0.02``);
4. serve: the committed north-star policy through ``HedgeEngine`` (blocks of
   1, 7 and 4,096 rows held against the stored JAX outputs), then its main
   path, one 1,048,576-row request: K2 moves, no other kernel;
5. replay: ``european_oos`` at 4,096 paths (held against the stored JAX
   report), then its main path at 1,048,576 fresh paths: |bp error| of the
   OLS-martingale price vs Black-Scholes < 1bp; K1 moves, no other kernel;
6. fixture walk: ``heston_hedge`` at 4,096 paths from the stored JAX initial
   params, held against the stored JAX report inside the walk's band
   (``tools/torch_walk_spread.py``); the stored JAX walk's per-date params
   replayed on the card's in-sample paths, ``v0_cv`` and ``v0_acv`` within
   0.5bp of the stored report and ``v0`` at rtol 1e-3; then the same walk in
   float64 on the card and on the CPU, on the same paths: the same limits,
   the same accepted iterations on every date, per-date losses at rtol 1e-7;
7. main path A: ``heston_hedge`` at 1,048,576 paths x 364 steps (QE-M, the
   Gauss-Newton walk), then ``heston_oos`` on 1,048,576 fresh paths: the
   hedged-CV and OLS-martingale prices within 3 standard errors of the
   Heston characteristic-function price, in and out of sample; K3b moves in
   each run, no other kernel;
8. the Euler scheme: ``heston_oos`` of the trained policy on 1,048,576 fresh
   Euler paths, the same checks; K3a moves, no other kernel;
9. main path B: ``european_hedge`` at 1,048,576 paths with the GN walk:
   |v0_acv - BS| < 1bp (the north star); K1 moves, no other kernel;
10. serve the trained Heston policy: ``save_bundle`` -> ``load_bundle`` ->
    ``HedgeEngine.evaluate_mixed_async`` on 4,096 rows over all 52 dates,
    held against ``mixed_head_plain`` at ``rtol=1e-5, atol=1e-6``; K2 moves;
11. the pension fixture (4,096 paths, ``_data/pension_walk``): (a) the stored
    JAX per-date params replayed by ``pension_oos`` on the card's in-sample
    paths, V0 / phi0 / psi0 within 1e-5 of the stored JAX replay; (b) the
    same walk in float64 on the card and on the CPU from the card's paths:
    the same accepted iterations in both legs on every date, V0 within 1e-9;
    (c) the f32 card walk from the stored JAX initial params against the
    stored JAX report, inside the band of the walk on the card's paths
    (``tools/torch_walk_spread.py --walk pension --device cuda``), and
    against the same f32 walk on the CPU from the card's paths, inside the
    CPU's one-ulp band;
12. main path C: ``pension_hedge`` at 1,048,576 paths x 1,000 steps (40
    dates, ``shared`` + ``py``, GN 60/30 with the IRLS quantile leg), V0
    within 4% of the reference's 981,038 and ``|phi0 + psi0 - V0| < 2% V0``,
    then ``pension_oos`` on 1,048,576 fresh paths (phi0 / psi0 equal to
    training's at rtol 1e-5: the t=0 features are the same on every path);
    K3c moves by one in each run, no other kernel; then ``separate`` mode at
    262,144 paths (V0 in the same band, two param sets) and the SV fund at
    65,536 paths (finite; phi0 + psi0 printed beside PARITY.md's 981,732);
13. serve the card-trained pension policy: ``save_bundle`` -> ``load_bundle``
    -> one 1,048,576-row mixed-date block (3 features, 40 dates, the shared
    combine) through K2, held against ``mixed_head_plain`` at ``rtol=1e-5,
    atol=1e-6``;
14. [tiers]: the north-star policy's 1,048,576-row block (phase 4) and the
    card-trained pension policy's (phase 13) through ``HedgeEngine(policy,
    precision=tier)`` at f32, bf16 and int8: K2's f32 kernel (f32, int8) or
    bf16 kernel (bf16) launches once per param set and no other kernel does;
    outputs finite f32; f32 and int8 agree with the port's CPU tier on the
    same rows at ``rtol=1e-5, atol=1e-6`` (``tests/test_torch_precision.py``
    holds the CPU tiers to the JAX package's engine); bf16 equals bitwise the
    tier computed by K2's documented bf16 arithmetic in plain PyTorch
    (``megakernel.mixed_head_bf16_order``, then the engine's
    ``serve_outputs``), its agreement with the CPU tier printed by
    ``BF16_RULE``'s measures; max |dphi|, |dpsi|, |dv| against the f32 tier printed beside
    ``PRECISION_BANDS`` (not gated: on these policies the JAX package's own
    tiers fall outside its bands too); rows/s host-to-host; K2's f32 and
    bf16 kernels timed at both policies' shapes and at 4,096 rows, beside
    their bounds;
15. [adam] main path D: ``european_hedge`` at 1,048,576 paths with the north
    star's Adam configuration (``benchmarks/north_star.py``: 120 + 51 x 30
    epochs, batches of 16,384, ``shuffle="blocks"``, lr 1e-3; ``fused=False``):
    |v0_acv - BS| < 1bp; K1 moves, no other kernel; the wall, the Adam steps,
    the epochs run, ms per step and launches per step (``torch.profiler``,
    each epoch a CUDA graph and op by op); then the trained policy as one
    1,048,576-row mixed-date block through ``HedgeEngine``: K2 moves, no other
    kernel, held against ``mixed_head_plain`` at ``rtol=1e-5, atol=1e-6``;
16. [adam-f64] the same Adam walk in float64 on the card (CUDA graphs) and on
    the CPU, on the same 4,096 K1 paths x 52 dates and the same orders (drawn
    on the host from one seed), ``shuffle=False`` and ``"blocks"``: every
    date's fit on the card against the same fit on the CPU from the card's
    inputs, params, values and holdings at rtol 1e-7 and the same epochs on
    every date (the free-running walks are chaotic in f64: the date where
    they part is printed);
17. [adam-reference] the reference's own Adam workloads at their own sizes and
    defaults (``tools/parity_runs.py``'s configs, copied): the Euro flagship
    (``euro_flagship_cfg(1234)``) inside ``test_golden_euro_flagship_hedge``'s
    bands against the reference values (phi0, psi0, discounted payoff, VaR99,
    terminal residual std), its network V0 within 3 standard deviations of
    the JAX package's own walk over 24 walk seeds (the golden 6% band around
    11.352 printed: that walk lands outside it on 13 of 24); ``Multi#25-26`` (``seeds3_cfg(1234)``:
    ``shared`` + ``py``, Adam 500/100, exact thinning, 4,096 x 1,000 steps):
    V0 within 3.5% of 981,038, ``|phi0 + psi0 - V0| < 2% V0``, phi0 in (600k,
    780k), psi0 in (200k, 380k); the hybrid walk (GN 60/30 with the Adam
    quantile leg): V0 within 3.5%; each wall;
18. [exact] ``simulate_pension`` with ``binomial_mode="exact"`` at 1,048,576
    paths x 1,000 steps stored every 25 (the scan path; each path's deaths
    drawn under the threefry key of ``(seed, step, path index)``, as the JAX
    package draws them): ``|E[N_T] - 8616| < 40``, ``|sd(N_T) - 132| < 30``;
    its wall beside the non-addressed per-step generator's (PERF.md); [mesh]
    holds four ranks' shards to this run;
19. [fused] the fused walk (``TrainConfig(fused=True)``: each GN leg's LM
    iteration a CUDA graph replayed per iteration, each Adam epoch a graph run
    for every epoch, nothing read back until the walk ends, the date loop
    under ``torch.cuda.set_sync_debug_mode("error")``): the north star at
    1,048,576 paths (GN 30 + 51 x 10) bitwise phase 9's host-loop walk
    (ledgers, per-date params, accepted iterations) and within 1bp of BS, K1
    once; the benchmark's GN configuration (150 + 51 x 75 iterations, row
    blocks of 16,384) within 1bp, with one blocked LM iteration's census (op
    by op: ms, host launch calls, device kernels; as a graph: ms, nodes,
    capture and instantiate seconds); the pension at 1,048,576 x 1,000 steps
    bitwise phase 12's walk (both legs), K3c once; each wall beside the host
    loop's;
20. [fused-adam] ``examples/out_of_sample.py``'s training (16,384 paths, Adam
    120/30, batch 2,048, lr 1e-3, blocks), host loop and fused: bitwise, both
    walls, the epochs run past the early stop, the synchronizing CUDA calls of
    each (``set_sync_debug_mode("warn")``);
21. [obs] the telemetry spine (``orp_tpu_torch.obs``): phase 9's north star under
    ``obs.telemetry`` (host loop), bitwise [euro]'s, with 52 ``train/fit`` and 52
    ``train/outputs`` spans under ``train/walk``, K1 launched once inside
    ``pipeline/simulate``, a ``train/convergence`` record with 52 finite
    ``gram_cond`` values, a manifest naming the card's stack and the configs'
    fingerprint, ``metrics.prom`` with the span series; the same walk fused,
    bitwise [fused]'s, one ``train/walk`` span, its date loop under
    ``no_host_sync``; [serve]'s 1M-row block under telemetry and
    ``devprof.profiling()``, bitwise the untelemetered block, the serve spans and
    counters, ``queue_s + device_s == t_done - t_dispatch``; each wall beside the
    untelemetered one, the 1-row latency with telemetry off beside [serve]'s;
22. [resume] phase 9's walk with ``checkpoint_dir``: the checkpointed walk,
    and the walk killed by ``FaultPlan(kill_after_step=25)`` then resumed, each
    bitwise phase 9's; walls and bytes on disk; the directory removed;
23. [guard] phase 9's walk with ``nan_guard=True``: clean, bitwise and silent;
    with ``FaultPlan(seed=3, nan_dates={1}, nan_frac=0.02)`` the ladder's
    ``final_solve`` rung at date 50 only, date 51 bitwise, every ledger
    finite, V0 within 5% of the clean run and |v0_acv - BS| < 1bp; with
    [fused-adam]'s Adam walk the same plan lands on the ``gauss_newton`` rung;
24. [basket] main path E, BASELINE.json config 5 (``BasketConfig()``: 5
    assets, rho 0.3) at 1,048,576 paths x 52 weekly steps on the scan path
    (the JAX package's basket is scan-only): ``basket_hedge`` with the basket
    hedge and the vector hedge (``instruments="assets"``; the fused GN walk,
    30 + 51 x 10, row blocks of 16,384) and the vector hedge with [adam]'s
    Adam. Each run and its ``basket_oos`` on fresh paths: ``v0_cv`` and
    ``v0_acv`` within 3 standard errors of ``v0_plain``, ``|v0_acv / oracle_mm
    - 1| < 40bp`` (the Levy bound of ``tests/test_basket.py``), no kernel
    launch. The vector hedge's ``cv_std`` below the basket hedge's; the fused
    vector walk bitwise its host loop at 16,384 paths. Each trained policy
    -> ``save_bundle`` -> ``load_bundle`` -> one 1,048,576-row mixed-date block
    through ``HedgeEngine``: K2's ``Runtime<8>`` instance (5 features, 2 or 6
    outputs) launches once and no other kernel does, the block held against
    ``mixed_head_plain`` at ``rtol=1e-5, atol=1e-6``; the kernel alone in f32
    against the plain version at the same tolerance, in bf16 bitwise its
    documented summation order (``megakernel.mixed_head_bf16_order``; its
    agreement with the plain version on the CPU and on the card printed);
    ``tier_phase`` for the vector head; K2's f32 and bf16 times at both heads beside their bounds;
25. [greeks] at 1,048,576 paths: ``european_greeks`` call and put (52 steps)
    inside ``tests/test_greeks.py``'s bands against ``bs_greeks``;
    ``digital_greeks`` within 4 standard errors of the closed forms, call +
    put partitioning the paths; ``heston_greeks`` (364 steps) at 8 independently
    scrambled seeds against central differences of the characteristic-function
    price, the mean of each greek within its band or 3 of the replicates'
    standard errors, the larger; ``basket_greeks`` at ``BasketConfig()``
    against CRN central-difference reprices on the card; each wall;
26. [exotics] ``examples/option_analytics.py``'s steps 2-5 at 1,048,576 paths
    (plain PyTorch on the scan path, as the JAX package runs them; no kernel
    launches in the phase), each in its JAX test's form: the arithmetic Asian
    (52 dates x 7 steps) with its geometric leg within 4 ``se_plain`` of the
    closed form, the control cutting ``se`` over 10x, below ``bs_call``; the
    bridge barrier (13 dates) within 3 SE of the reflection price, the naive
    estimator high by > 10 SE and falling at 250 dates; the fixed (K=110) and
    floating lookbacks within 3 SE of their closed forms, the naive ones low by
    > 10 SE; the flat surface at the CLI's strikes (13 maturities x 4 steps)
    within 0.035 of ``bs_call`` at every node with finite IVs within 6e-3 of
    sigma, the Heston QE surface's skew and terminal nodes within 0.04 of the
    CF price; the Bermudan LSM (LS2001, 50 dates x 4 steps) and its Heston xi
    -> 0 limit inside the CRR bracket, the Heston LSM's European leg within
    0.05 of ``heston_put`` and its premium over 3 SE. Before them, each pricer
    on the card against the CPU at 4,096 paths on the same indices (floats
    within 1e-4 relative; surfaces within 1e-4 of the largest node, IVs 3e-4,
    NaN masks equal; the LSM within 2 SE, the share of paths whose exercise
    date differs printed); the CIR calibration on
    ``examples/stochastic_vol_calibration.py``'s series; ``utils.flops
    .phase_report`` of [fused]'s benchmark wall; each wall;
27. [mesh] the paths mesh (``mesh_phases``): (a) an NCCL group over every
    visible card (one rank on one card) runs ``european_hedge(mesh=)`` at
    1,048,576 paths x 364 steps, 52 dates, the scan engine, GN 30 + 51 x 10,
    as the host loop and fused (NCCL's ``all_reduce`` inside the captured LM
    iteration, the date loop under ``no_host_sync``), ``v0_cv`` / ``v0_acv``
    bitwise the same call without a mesh (else within ``rtol=1e-5``), and the
    sharded engine bitwise the unsharded one at buckets 1 to 1,048,576; (b)
    four ``gloo`` ranks sharing the card, 262,144 paths each: the walk (GN
    3 + 51 x 1) within ``rtol=1e-5`` on ``v0_cv`` and 10% on ``v0`` of the
    same walk without a mesh, the sharded engine bitwise, ``fused=True`` and
    ``engine="pallas"`` refused in the reference's words, and exact thinning
    at 262,144 x 50 steps a rank, the blocks bitwise the first knots of
    [exact]'s run; in the same launch, the committed north-star policy with
    AOT sets n4, n2 and n1 (exported in this process): each rank loads the n4
    set with 0 ``nvcc`` runs and 0 capture fallbacks, one graph per bucket of
    its shard, serving buckets 1 to 1,048,576 bitwise the unsharded engine;
    then ``DegradeManager(mesh=4)`` on that bundle, a loss reporting 3
    survivors at request 5 of 32 and a 1,048,576-row block before and after:
    rebuilt on 2 ranks from the n2 set (0 ``nvcc``, one capture per bucket),
    ranks 2 and 3 stood down, every answer bitwise rank 0's single-device
    engine, 0 failed; the MTTR and the added seconds printed. Every rank is a
    process of its own (``tools/torch_mesh_ranks.py``) under a hard timeout; a
    rank that fails fails the phase; no rank launches a kernel;
28. times: each kernel with CUDA events at the main paths' shapes (the
    host's queue filled ahead of each timed round, so a kernel shorter than
    its wrapper's host cost is timed on the card), its plain version's time
    from the one run of its check in phase 3 (K1, K3a, K3b at 1M; K3c's in
    its 1M check; the dense grid timed once here), beside
    the kernel's bound (K2's from [tiers], f32 and bf16 at both shapes, and
    from [basket] at the basket heads); the GN walks' walls at 1M paths and
    the median time of one LM iteration there (MSE and, for the pension, the
    IRLS pinball leg); the basket's and the greeks' walls.

29. [host] the single-host serve path (``host_phases``): the north-star and
    pension policies trained at 65,536 paths (their widths: 106 params x 52
    dates; 3 features x 40 dates, two param sets) through ``export_dir=``,
    served with the committed north-star policy on ``ServeHost(
    max_live_engines=2)`` (mixed-date lane, block coalescing): client threads
    send ``orp-ingest-v2`` frames of 1 to 1,048,576 rows through
    ``submit_block``, every served row bitwise the tenant's own
    ``HedgeEngine``, no kernel launched by the per-date lane; single-row
    requests at many dates ride one dispatch through K2 (one launch for the
    north star, two for the pension), within ``rtol=1e-5, atol=1e-6`` of the
    plain version on the CPU; the shed statuses under ``GuardPolicy(
    deadline_ms=..., queue_watermark=...)``; a retry under ``FaultPlan(fail=
    {"serve/dispatch": 2})``; eviction to warm and back with no build and the
    params at the same device address; the canary promoting the same bundle
    and rejecting ``corrupt_reload`` with the incumbent's bits untouched; a
    quality-gated reload; the tier drill (each reduced tier refused under
    bits, then judged by the quality band); 1-row latency and 1M-row rows/s
    through the host beside the bare engine; reload and activation seconds.

30. [gateway] the network and fleet plane (``gateway_phases``), with the
    committed north-star policy (106 params x 52 dates): the policy exported
    with ``export_bundle(store=)`` into a fresh content-addressed store under
    two tenants (one tree, two manifests), a ``store://`` tenant's 65,536-row
    block bitwise the directory-loaded engine, gc of the removed tenant
    freeing its manifest only; blocks of 1 to 1,048,576 rows through TCP v1
    (``GatewayClient``), TCP v2 (``ResilientGatewayClient``) and the
    shared-memory ring (32 + 64 MiB rings in ``tempfile.gettempdir()``), every
    served row bitwise the tenant's ``HedgeEngine``, and a wrap-around run;
    512 single-row frames at 52 dates from 8 client threads through TCP and
    from one ring client, each batch one dispatch and one K2 launch, within
    ``rtol=1e-5, atol=1e-6`` of the plain version on the CPU; K2 alone at that
    batch against its plain version (``mixed_head_gateway``); the delivery
    drills (``serve/bench.gateway_drill``: kill at frame 20, a new gateway on
    the same port, 3 runs; a torn and a stalled send at ``client/send``; BUSY
    backpressure; drain-and-redirect A -> B), each with zero loss and no
    duplicate; ``serve/bench.fleet_phase`` at 1 and 2 replicas behind 2 fleet
    gateways, every replica a ``ServeHost`` on this card, with its
    kill-one-replica drill; where a fleet hop's time goes; the live scrape
    through ``MetricsServer``. Printed: 1-row round trips per lane beside
    ``ServeHost`` direct and each lane's PING alone, rows/s per lane, the
    drill's MTTR, the fleet's rows/s and p99, the store's seconds.

31. [aot] the compile-and-perf plane (``aot_plane_phases``), with the committed
    north-star policy exported as a bundle: ``export_aot`` of its buckets
    (``DEFAULT_BUCKETS`` plus 65,536 and 1,048,576 rows) at f32 and bf16; a
    fresh process (``tools/torch_aot_child.py serve``) with
    ``ORP_TORCH_CACHE_DIR`` at an empty directory loads the bundle: 0 ``nvcc``
    runs, every request an AOT hit, every bucket at dates 0, 25 and 51 and both
    tiers bitwise an eager engine; a tampered manifest (``device_kind``) gives
    one warning, one ``aot/fingerprint_mismatch`` event, no AOT bucket and the
    same bits; three ``serve/aot_dispatch`` faults demote one bucket, the bits
    unchanged; an AOT tenant of a ``ServeHost`` evicted to warm and
    re-activated with 0 ``nvcc`` runs and 0 graph captures, bitwise;
    ``warm_fused_walk`` into an empty cache (a child process),
    then a fresh process runs the fused north star at 65,536 paths with 0
    ``nvcc`` runs; printed: the cold start (an engine with an empty cache and
    no AOT set, plus its first mixed-date and bucketed requests, in a child
    process) against the same from the bundle, and graph replay against the
    eager engine in turns (1-row latency, 1M-row rows/s);
32. [perf] ``obs/perf.measure_serve_phase`` through ``gate_cli`` twice (the
    baseline, then within noise), then a ``serve/dispatch`` delay trips
    ``regression``; the ledger in a temporary directory, the repo root's
    ``PERF_LEDGER.jsonl`` and ``BENCH_serve.json`` unchanged (sha256); the
    roofline of K2's 1M-row block and of the engine's headline bucket against
    the H100 row (``peak_source == "table"``, fractions <= 1);
33. [profile] ``profile_north_star(20)``: its stage table (wall, compile,
    execute, host/device, fraction of peak), K1 launched exactly once (the
    ``sim`` stage), every fraction <= 1 on the execute wall; ``profile_serve``
    of the AOT bundle:
    the per-bucket table, the device utilization, a roofline with no error;
34. [degrade] ``serve/bench._degrade_drill`` on one card from the AOT bundle:
    0 requests failed, at least one replayed, the recovery bitwise, the
    rebuild with 0 ``nvcc`` runs; the MTTR;
35. [serve-bench] ``serve/bench.serve_bench(prewarm=True)`` with the sweep at
    concurrency 1, 4 and 16, the degrade drill, ingest, precision (with the
    mixed-date kernel's A/B and ragged batching) and density at 100 tenants,
    on a policy trained on the card at the reference's precision-test
    configuration (its holdings inside ``PRECISION_BANDS``); the record
    written under a temporary directory by ``write_bench_record``, its
    ``ledger_records`` valid ``orp-perf-v1`` records; req/s and p99 at each
    concurrency; K2 launched by the megakernel phase.
36. [pilot] the closed loop (``pilot_phases``, run after [serve-bench] while
    the compile-and-perf plane's background builds finish): the reference's drill
    (``serve_bench(pilot=True)``, 512 paths: reject, promote, promote, 0 rows
    lost, the resumed policy bitwise, the chain verified); a full-width
    calibration cycle on phase 9's north-star policy (exported there with
    its calm-regime calibration and an AOT set): the shifted market's
    trigger, the warm-started checkpointed retrain at 1,048,576 x 364 (K1
    once), the candidate promoted through ``reload_tenant(quality_band=
    0.25)`` (the validation set at 2 of its 8 replicates) under a submitter of per-date blocks and mixed-date single rows
    (K2), 0 rows lost, every row bitwise the engine that served it; a manual
    cycle killed after step 1 and resumed by a fresh controller, bitwise an
    uninterrupted run; ``CompileAudit`` on the walks and the promotions'
    engines; the capture fallbacks counted; ``doctor_report`` ok on the
    card, ``perf_peaks`` on the H100 row, a torn journal failing in
    flag-speak; K1 and K2 at this path's shapes against their plain versions.
37. [cli] the command line (``orp_tpu_torch/cli.py``, ``cli_phases``), with
    the built kernels: ``cli.main(["euro", ...])`` with the flags of phase
    9's configs (``--engine pallas --optimizer gauss_newton``, ``--oos-seed``,
    ``--export-dir``, ``--telemetry``): its in-sample JSON line bitwise phase
    9's report, |v0_acv - BS| < 1bp, K1 launched twice (training and
    ``oos_``) and no other kernel, the exported per-date params bitwise phase
    9's, ``report --events`` 52 dates; ``serve-gateway`` as a child process
    (``python -m orp_tpu_torch.cli``) serving that bundle: frames of 1, 4,096
    and 1,048,576 rows and 512 single rows at mixed dates, each reply
    bitwise the smoke's own ``HedgeEngine(load_bundle(D))``, ``top`` one
    snapshot, ``doctor --bundle --gateway`` ok, SIGTERM: exit 0, the ready
    file gone, every row sent served, ``trace`` of a stamped frame's chain;
    ``export`` of the precision-test policy and ``serve-bench --quick
    --precision`` on it in process: K2 launched, held against
    ``mixed_head_plain`` at the megakernel phase's shape; the child's time
    from spawn to its ready file, the phase's wall and the whole smoke's.

Output: a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import json
import math
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), read from the
# port's one copy of them (``orp_tpu_torch/utils/flops.py``); copied alone, the
# script has none and main() refuses before any bound is computed
sys.path.insert(0, str(HERE))
try:
    from orp_tpu_torch.utils.flops import HBM_BYTES_H100 as HBM_BYTES_PER_S
    from orp_tpu_torch.utils.flops import PEAK_F32_H100 as F32_FLOP_PER_S
    from orp_tpu_torch.utils.flops import PEAK_INT32_H100 as INT32_OP_PER_S
except ImportError:
    HBM_BYTES_PER_S = F32_FLOP_PER_S = INT32_OP_PER_S = None

N_FULL = 1 << 20
N_FIXTURE = 4096
N_STEPS, STORE = 364, 7
OOS_SEED = 4321
EULER_SEED = 5432
HESTON = dict(s0=100.0, mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
# the reference's multi-step pension (Multi Time Step.ipynb#25-26): T=10, dt=0.01,
# quarterly rebalancing, 4 factors
PENSION_STEPS, PENSION_STORE = 1000, 25
PENSION = dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0)
PENSION_SV = dict(PENSION, sigma=None, sv=True, v0=0.15, cir_a=0.00336, cir_b=0.15431,
                  cir_c=0.01583)  # StochVolConfig()
N_SEPARATE, N_SV, N_K3C_CHECK = 1 << 18, 1 << 16, 1 << 16
N_K1_WIDE = (1 << 21) + 33
PENSION_V0_REF = 981_038.0   # Multi#26(out), 4,096 paths
PENSION_V0_BAND = 0.04       # test_golden_pension_gn_irls_three_seed_mean's loose band
PENSION_SV_REF = 981_732.0   # PARITY.md:44, Adam at 4,096 paths, c = 0.01583
# the 4,096-path pension walk's bands, V0 relative, phi0 and psi0 as shares of V0.
# Around the stored JAX report: about twice the largest gap of 8 one-ulp-perturbed
# runs on the card (tools/torch_walk_spread.py --walk pension --device cuda: 3.89%,
# 12.85%, 16.82%). The card's paths are another sample of the survivors than the
# JAX package's: the reference's f32 CDF walk saturates (a 128-death step) where
# its cdf plateaus below 1, and one ulp of exp(-lam dt) moves the plateau, so N
# parts on ~38% of knots and the fits land apart. Against the same walk in f32 on
# the CPU from the card's own paths: about twice the largest gap of 16 such runs on
# the CPU (0.40%, 1.20%, 1.48%; tests/test_torch_fixture.py holds the CPU port to
# that band around the JAX report).
PENSION_FIXTURE_BAND = {"v0": 0.08, "phi0": 0.26, "psi0": 0.34}
PENSION_SAME_PATHS_BAND = {"v0": 0.01, "phi0": 0.03, "psi0": 0.03}
# the 4,096-path walk's band around the stored JAX report: about twice the
# largest gap of 16 one-ulp-perturbed runs (tools/torch_walk_spread.py;
# tests/test_torch_fixture.py holds the CPU port to the same band)
FIXTURE_BAND_BP = {"v0_cv": 5.0, "v0_acv": 30.0}
FIXTURE_V0_RTOL = 5e-2
# tests/test_greeks.py's Heston greeks case: each greek's central-difference bump of the
# characteristic-function price (_cf_fd) and its band
HESTON_GREEKS = dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
HESTON_GREEKS_FD = {"delta": ("s0", 0.05, "atol", 5e-3), "vega_v0": ("v0", 3e-4, "rtol", 2e-2),
                    "vega_theta": ("theta", 3e-4, "rtol", 2e-2),
                    "vega_xi": ("xi", 2e-3, "rtol", 5e-2), "rho_rate": ("r", 1e-4, "rtol", 5e-3),
                    "vega_kappa": ("kappa", 1e-2, "atol", 5e-3)}
HESTON_GREEKS_SEEDS = tuple(range(77, 85))
# [exotics]: examples/option_analytics.py's steps 2-5 at its and the CLI's configurations
# (orp_tpu/cli.py:1843-1937), each gated in the form of its JAX test
EXOTIC_ASIAN = dict(s0=100.0, k=100.0, r=0.08, sigma=0.15, T=1.0)            # tests/test_asian.py
EXOTIC_BARRIER = dict(s0=100.0, k=100.0, h=90.0, r=0.08, sigma=0.25, T=1.0)  # tests/test_barrier.py
EXOTIC_LOOKBACK = dict(s0=100.0, k=110.0, r=0.08, sigma=0.25, T=1.0)         # tests/test_lookback.py
SURFACE_STRIKES = [80.0, 90.0, 95.0, 100.0, 105.0, 110.0, 120.0]            # the CLI's default
SURFACE_HESTON = dict(v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)  # test_surface's H
SURFACE_HESTON_STRIKES = [85.0, 95.0, 100.0, 105.0, 115.0]
LSM_LS = dict(k=40.0, r=0.06, sigma=0.2, T=1.0)   # Longstaff-Schwartz 2001 Table 1, s0 = 36
LSM_HESTON = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6)  # tests/test_lsm.py's HESTON
LSM_XI0 = dict(v0=0.04, kappa=1e-6, theta=0.04, xi=1e-6, rho=0.0)   # Heston's GBM limit
N_CROSS = 4096


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list[str]:
    """The lines of an ``nvcc -Xptxas -v`` log that name each kernel (its mangled
    name) and give its registers and spills."""
    return [line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line or "spill" in line]


def heston_greeks_oracle() -> dict:
    """``{greek: (oracle, "rtol" | "atol", band)}`` of the Heston greeks case at s0 = k =
    100, r = 0.08, T = 1: the characteristic-function price (band rtol 5e-3) and
    the central differences of it at ``HESTON_GREEKS_FD``'s bumps."""
    from orp_tpu_torch.utils import heston_call

    base = dict(s0=100.0, k=100.0, r=0.08, T=1.0, **HESTON_GREEKS)

    def price(**over):
        p = {**base, **over}
        return heston_call(p["s0"], p["k"], p["r"], p["T"], **{k: p[k] for k in HESTON_GREEKS})

    out = {"price": (price(), "rtol", 5e-3)}
    for greek, (name, h, how, lim) in HESTON_GREEKS_FD.items():
        fd = (price(**{name: base[name] + h}) - price(**{name: base[name] - h})) / (2 * h)
        out[greek] = (fd, how, lim)
    return out


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype


def sobol_int_ops(n_paths: int, n_dims: int) -> int:
    """int32 operations of ``n_dims`` scrambled Sobol words per path, each word
    split by XOR linearity over a warp of 32 consecutive indices: per warp and
    dimension, one op per set index bit 5-31 (the popcount of the warp's number)
    and the scramble key ``hash_combine(seed, dim)`` (12) once; per path, one
    XOR for its lane bits (the warp's 32 words in Gray-code order), then two bit
    reversals, the Laine-Karras hash (add + 4 mul/xor) and the bucket shift
    (12)."""
    n_warps = -(-n_paths // 32)
    warp_ops = sum(bin(w).count("1") + 12 for w in range(n_warps))
    return n_dims * (warp_ops + 13 * n_paths)


# f32 operations of one AS241 draw: central 33 on 85% of uniforms
# (|u - 0.5| <= 0.425), tail 37 on 15%
AS241_OPS = 0.85 * 33 + 0.15 * 37


def bound(bytes_: float, int_ops: float, f32_ops: float) -> tuple[float, str]:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OP_PER_S, f32_ops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound_ms(n_paths: int, n_steps: int, store_every: int) -> tuple[float, str]:
    """Least time for the fused GBM: the direction table in and the knots out,
    against the Sobol int32 work and the f32 AS241 + update (6) per
    path-step, exp + mul per knot."""
    n_knots = n_steps // store_every + 1
    bytes_ = n_steps * 32 * 4 + n_knots * n_paths * 4
    f32_ops = n_paths * (n_steps * (6 + AS241_OPS) + 2 * (n_knots - 1))
    return bound(bytes_, sobol_int_ops(n_paths, n_steps), f32_ops)


def k3_bound_ms(n_paths: int, n_steps: int, store_every: int, scheme: str) -> tuple[float, str]:
    """Least time for the fused Heston: the direction table in and the S and v
    knots out, against two Sobol words per path-step and the f32 work: the
    asset's AS241 plus, for Euler, the variance's AS241 and 20 update ops; for
    QE-M 38 ops shared by both variance branches plus the cheaper branch's 15
    (the exponential one: no inverse normal), so a lower bound whatever the
    branch mix; exp + mul per knot of S."""
    n_knots = n_steps // store_every + 1
    bytes_ = n_steps * 2 * 32 * 4 + 2 * n_knots * n_paths * 4
    step_ops = AS241_OPS + (AS241_OPS + 20 if scheme == "euler" else 38 + 15)
    f32_ops = n_paths * (n_steps * step_ops + 2 * (n_knots - 1))
    return bound(bytes_, sobol_int_ops(n_paths, 2 * n_steps), f32_ops)


# f32 operations of the pension step besides its AS241 draws (exp, sqrt and a
# division count one each, so the count is a lower bound): the constant-vol
# fund 3, the SV fund 18; mortality and survival 7; inversion thinning 11 and
# 7 per walk trip; normal thinning 11
K3C_FUND_OPS = {False: 3, True: 18}
K3C_MORT_OPS, K3C_INV_OPS, K3C_TRIP_OPS, K3C_NORMAL_OPS = 7, 11, 7, 11


def k3c_bound_ms(n_paths: int, n_steps: int, store_every: int, sv: bool, inversion: bool,
                 walk_trips: float) -> tuple[float, str]:
    """Least time for the fused pension system: the direction table in and the
    3 (4 with SV) state slots' knots out, against one Sobol word per used
    factor per path-step, the AS241 of each normal factor and the step's f32
    work, with the CDF walk's trips counted from this run's deaths
    (``walk_trips``, one per death)."""
    n_knots = n_steps // store_every + 1
    slots = 4 if sv else 3
    bytes_ = n_steps * 4 * 32 * 4 + slots * n_knots * n_paths * 4
    words = (4 if sv else 3) * n_steps
    normals = (3 if sv else 2) + (0 if inversion else 1)
    step = normals * AS241_OPS + K3C_FUND_OPS[sv] + K3C_MORT_OPS + (
        K3C_INV_OPS if inversion else K3C_NORMAL_OPS)
    f32_ops = n_paths * n_steps * step + walk_trips * K3C_TRIP_OPS
    return bound(bytes_, sobol_int_ops(n_paths, words), f32_ops)


def k2_bound_ms(model, n_rows: int, n_dates: int, elem: int = 4) -> tuple[float, str]:
    """Least time for the mixed-date head: rows in/out and params once, at
    ``elem`` bytes an element (4 for f32, 2 for bf16; dates are int32), against
    the forward's f32 operations (2 per FMA, bias adds, LeakyReLU; the bf16
    kernel's roundings are not counted, so the bound is a lower one)."""
    sizes = model.layer_sizes
    bytes_ = (n_rows * (4 + elem * sizes[0] + elem * sizes[-1])
              + elem * n_dates * model.n_params())
    flops = 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        flops += 2 * a * b + b + (2 * b if i < len(sizes) - 2 else 0)
    return bound(bytes_, 0, n_rows * flops)


class Counts:
    """The kernels' launch counters: set to 0 just before a main path's run,
    read just after it. Each counter is a wrapper (its ``launches``) or a
    ``(wrapper, attribute)`` pair."""

    def __init__(self, **counters):
        self.counters = {k: v if isinstance(v, tuple) else (v, "launches")
                         for k, v in counters.items()}

    def reset(self) -> None:
        for fn, attr in self.counters.values():
            setattr(fn, attr, 0)

    def read(self) -> dict[str, int]:
        return {k: getattr(fn, attr) for k, (fn, attr) in self.counters.items()}

    def only(self, name: str, what: str) -> int:
        """Check that the run launched kernel ``name`` and no other."""
        got = self.read()
        check(got[name] > 0, f"{name} launched on {what} ({got})")
        check(all(v == 0 for k, v in got.items() if k != name),
              f"{what} launches no kernel but {name} ({got})")
        return got[name]


def report_fields(rep) -> list[float]:
    return [rep.v0, rep.phi0, rep.psi0, rep.v0_plain, rep.v0_cv, rep.cv_std, rep.v0_acv,
            rep.acv_std, *rep.var_overall]


def check_heston_price(rep, price: float, n: int, what: str) -> str:
    """The hedged-CV and OLS-martingale prices within 3 standard errors of the
    characteristic-function price; all report fields finite."""
    check(all(math.isfinite(x) for x in report_fields(rep)), f"{what}: report fields finite")
    parts = []
    for name, v, std in (("v0_cv", rep.v0_cv, rep.cv_std), ("v0_acv", rep.v0_acv,
                                                             rep.acv_std)):
        lim = 3.0 * std / math.sqrt(n)
        check(abs(v - price) < lim, f"{what}: |{name} - heston_call| = {abs(v - price):.5f} "
              f"< 3 SE = {lim:.5f}")
        parts.append(f"{name} {v:.6f} ({(v - price) / price * 1e4:+.3f}bp, 3 SE "
                     f"{lim / price * 1e4:.2f}bp)")
    return ", ".join(parts)


def f64_heston_walk(paths: dict, h, init: dict, device):
    """``heston_hedge``'s walk (Gauss-Newton, ``mse_only``, from ``init``) and
    report in float64 on ``device``, on given paths ``{"S", "v"}`` of the
    364-step grid stored weekly."""
    import torch

    from orp_tpu_torch.api import TrainConfig, pipelines
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.sde import TimeGrid, bond_curve, payoffs
    from orp_tpu_torch.train import backward

    f64 = torch.float64  # orp: noqa[ORP001] -- the f64 walk this check holds card against CPU
    s = paths["S"].to(device=device, dtype=f64)
    v = paths["v"].to(device=device, dtype=f64)
    coarse = TimeGrid(1.0, N_STEPS).reduced(STORE)
    b = bond_curve(coarse, h.r, f64, device)
    payoff = payoffs.european(s[:, -1], h.strike, h.option_type)
    cfg = pipelines._backward_cfg(TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"))
    res = backward.backward_induction(HedgeMLP(n_features=2, dtype=f64),
                                      torch.stack([s / h.s0, v], dim=-1), s / h.s0, b / h.s0,
                                      payoff / h.s0, cfg, initial_params=(init, None))
    times = coarse.times(f64).numpy()
    report = pipelines._report(res, s, payoff, h.r, h.strike, h.s0, times, "sort")
    return pipelines.PipelineResult(report=report, backward=res, times=times,
                                    adjustment_factor=h.s0)


def event_ms(fn):
    """``(fn(), ms)`` of one call, timed with CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def check_pension_paths(got: dict, want: dict, what: str) -> float:
    """K3c against its plain version on the card: every output bitwise equal
    (Y, v, lambda, and the survivors N on every knot); returns the largest
    |error| (0)."""
    import torch

    check(sorted(got) == sorted(want), f"{what}: outputs {sorted(got)}")
    for k in got:
        check(torch.equal(got[k], want[k]), f"{what}: {k} bitwise equal to the plain version "
              f"(max |d| {max_err(got[k], want[k]):.3e})")
    return max(max_err(got[k], want[k]) for k in got)


def k3c_checks(dev) -> dict:
    """K3c against ``pension_plain`` on the card in four variants at 65,536
    paths and in the main variant at 1M, then the laws from the 1M paths."""
    import torch

    from orp_tpu_torch.qmc import fused_mf

    out = {"err": 0.0}
    grid = dict(dt=10.0 / PENSION_STEPS, seed=1234, store_every=PENSION_STORE, device=dev)
    runs = [(N_K3C_CHECK, sv, mode) for sv in (False, True) for mode in ("normal", "inversion")]
    for n, sv, mode in runs + [(N_FULL, False, "inversion")]:
        kw = dict(PENSION_SV if sv else PENSION, binomial_mode=mode, **grid)
        got = fused_mf.pension_fused(n, PENSION_STEPS, **kw)
        torch.cuda.synchronize()
        want, plain_ms = event_ms(lambda: fused_mf.pension_plain(n, PENSION_STEPS, **kw))
        for k, v in got.items():
            check(v.shape == (n, PENSION_STEPS // PENSION_STORE + 1), f"K3c {k} shape")
        what = f"K3c {'sv' if sv else 'const-vol'} {mode} {n}"
        out["err"] = max(out["err"], check_pension_paths(got, want, what))
        print(f"[K3c] {'sv' if sv else 'const-vol'} {mode}, {n} x {PENSION_STEPS} store "
              f"{PENSION_STORE}: {'/'.join(sorted(got))} bitwise equal to the plain version "
              f"(N on every knot); plain version {plain_ms / 1e3:.2f} s", flush=True)
        del want
    out["plain_ms"] = plain_ms  # the main variant at the main path's shape, timed once
    n_t, y_t = got["N"][:, -1].double(), got["Y"][:, -1].double()  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    laws = (float(n_t.mean()), float(n_t.std()), float(y_t.mean()))
    check(abs(laws[0] - 8616) < 40 and abs(laws[1] - 132) < 30,
          f"population law E[N_T] {laws[0]:.1f} (8616 +- 40), sd {laws[1]:.1f} (132 +- 30)")
    check(abs(laws[2] - math.exp(0.8)) < 0.02, f"fund law E[Y_T] {laws[2]:.5f} vs e^0.8")
    # deaths over the run = the CDF walk's trips (one per death; no CLT draws at dt=0.01)
    out["trips"] = float((got["N"][:, 0].double() - got["N"][:, -1].double()).sum())  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    print(f"[K3c] laws from the kernel's {N_FULL} paths: E[N_T] {laws[0]:.2f} (8616), sd "
          f"{laws[1]:.2f} (132), E[Y_T] {laws[2]:.5f} (e^0.8 = {math.exp(0.8):.5f}); deaths "
          f"(walk trips) {out['trips']:.0f}", flush=True)
    return out


def pension_walk(cfg, paths: dict, init: dict, device, dtype: str):
    """The fixture's dual walk and report in ``dtype`` (``"float32"`` or
    ``"float64"``) on ``device``, on given paths ``{"Y", "lam", "N"}`` and from
    ``init``."""
    import dataclasses

    import torch

    from orp_tpu_torch.api import pipelines
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import backward

    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, dtype=dtype))
    on = {k: v.to(device=device, dtype=pipelines._DTYPES[dtype]) for k, v in paths.items()}
    inp = pipelines.pension_inputs(cfg, dtype, torch.device(device), paths=on)
    model = HedgeMLP(n_features=3, dtype=pipelines._DTYPES[dtype])
    res = backward.backward_induction(model, inp.features, inp.y, inp.b, inp.terminal,
                                      pipelines._backward_cfg(cfg.train),
                                      initial_params=(init, None))
    return pipelines._pension_result(cfg, inp, res, model, "sort")


def pension_gaps(rep, ref) -> dict[str, float]:
    """V0 relative, phi0 and psi0 as shares of V0, of ``rep`` against ``ref``."""
    get = (lambda k: ref[k]) if isinstance(ref, dict) else (lambda k: getattr(ref, k))
    return {"v0": rep.v0 / get("v0") - 1, "phi0": (rep.phi0 - get("phi0")) / get("v0"),
            "psi0": (rep.psi0 - get("psi0")) / get("v0")}


def pension_fields(rep) -> list[float]:
    return [rep.v0, rep.phi0, rep.psi0, rep.discounted_payoff, *rep.var_overall]


def pension_phases(dev, counts, launches) -> dict:
    """Phases 11-13: the pension fixture, the main path (train 1M, replay 1M),
    the separate and SV walks, and serving the card-trained policy."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from orp_tpu_torch import PENSION_WALK
    from orp_tpu_torch.api import (HedgeRunConfig, SimConfig, StochVolConfig, TrainConfig,
                                   pension_hedge, pension_oos, pipelines)
    from orp_tpu_torch.serve import HedgeEngine, load_bundle, megakernel, save_bundle
    from orp_tpu_torch.serve.bundle import model_meta
    from orp_tpu_torch.train import backward, gn, losses
    from orp_tpu_torch.utils.measure import cuda_ms

    out = {}
    train = TrainConfig(dual_mode="shared", holdings_combine="py", optimizer="gauss_newton",
                        gn_iters_first=60, gn_iters_warm=30)
    sim = SimConfig(n_paths=N_FULL, T=10.0, dt=0.01, rebalance_every=PENSION_STORE, seed=1234,
                    engine="pallas", binomial_mode="inversion")
    main_cfg = HedgeRunConfig(sim=sim, train=train)

    def with_sim(cfg, **kw):
        return dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, **kw))

    # -- 11. the pension fixture ------------------------------------------------
    ref = json.loads((PENSION_WALK / "reference.json").read_text())
    with np.load(PENSION_WALK / "init.npz") as z:
        init = {k: z[k] for k in z.files}
    jax_walk = load_bundle(PENSION_WALK)
    fx_cfg = with_sim(main_cfg, n_paths=N_FIXTURE)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="replay_walk with dual_mode='shared'")
        rp = pension_oos(jax_walk, fx_cfg, allow_in_sample=True).report
    rp_rel = {k: getattr(rp, k) / ref["oos"][k] - 1 for k in ("v0", "phi0", "psi0")}
    for k, rel in rp_rel.items():
        check(abs(rel) <= 1e-5, f"replayed JAX pension walk {k} within 1e-5 of JAX ({rel:+.2e})")
    print(f"[pension-fixture] the stored JAX walk's params replayed on the card's {N_FIXTURE} "
          f"in-sample paths: V0 {rp_rel['v0']:+.2e}, phi0 {rp_rel['phi0']:+.2e}, psi0 "
          f"{rp_rel['psi0']:+.2e} vs the stored JAX replay (limit 1e-5)", flush=True)
    fx_paths = pipelines._simulate_pension_paths(
        fx_cfg, pipelines.TimeGrid(10.0, PENSION_STEPS), "fixture", dev)
    cpu = torch.device("cpu")
    t1 = time.perf_counter()
    card64, cpu64 = (pension_walk(fx_cfg, fx_paths, init, d, "float64") for d in (dev, cpu))
    f64_s = time.perf_counter() - t1
    v0_64 = card64.report.v0 / cpu64.report.v0 - 1
    check(abs(v0_64) <= 1e-9, f"f64 pension walk: card V0 within 1e-9 of the CPU ({v0_64:+.2e})")
    for leg in ("epochs_ran", "quantile_epochs_ran"):
        check(np.array_equal(getattr(card64.backward, leg), getattr(cpu64.backward, leg)),
              f"f64 pension walk: the same accepted iterations ({leg}) on every date")
    print(f"[pension-fixture] the same walk in float64 on the card and on the CPU, same paths: "
          f"V0 {v0_64:+.2e} apart (limit 1e-9); accepted iterations equal on all 40 dates, "
          f"MSE leg {int(cpu64.backward.epochs_ran.sum())}, quantile leg "
          f"{int(cpu64.backward.quantile_epochs_ran.sum())}; {f64_s:.2f} s", flush=True)
    del card64, cpu64
    # (c) the f32 walk on the card from the stored JAX init, against the stored
    # JAX report and against the same f32 walk on the CPU from the card's paths
    t1 = time.perf_counter()
    fx = pension_walk(fx_cfg, fx_paths, init, dev, "float32").report
    torch.cuda.synchronize()
    fx_s = time.perf_counter() - t1
    fx_cpu = pension_walk(fx_cfg, fx_paths, init, cpu, "float32").report
    for rep_, what in ((fx, "card"), (fx_cpu, "CPU")):
        check(all(math.isfinite(x) for x in pension_fields(rep_)),
              f"pension fixture f32 walk on the {what}: report finite")
    gaps, same = pension_gaps(fx, ref), pension_gaps(fx, fx_cpu)
    for name, got, band in (("the stored JAX report", gaps, PENSION_FIXTURE_BAND),
                            ("the CPU's f32 walk on the same paths", same,
                             PENSION_SAME_PATHS_BAND)):
        for k, lim in band.items():
            check(abs(got[k]) <= lim, f"pension fixture f32 walk {k} within {lim} of {name} "
                  f"({got[k]:+.4f})")
    print(f"[pension-fixture] the f32 walk on the card from the stored JAX init: V0 "
          f"{gaps['v0']:+.4%}, phi0 {gaps['phi0']:+.4%} of V0, psi0 {gaps['psi0']:+.4%} of V0 "
          f"vs the stored JAX report (bands {PENSION_FIXTURE_BAND}); vs the same f32 walk on "
          f"the CPU from the card's paths: V0 {same['v0']:+.4%}, phi0 {same['phi0']:+.4%}, "
          f"psi0 {same['psi0']:+.4%} (bands {PENSION_SAME_PATHS_BAND}); accepted iterations "
          f"on the card: MSE leg {int(fx.epochs_ran.sum())}; wall {fx_s:.2f} s", flush=True)
    del fx_paths

    # -- 12. main path C: pension_hedge + pension_oos at 1M (K3c) ----------------
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    ph = pension_hedge(main_cfg)
    torch.cuda.synchronize()
    out["hedge_s"] = time.perf_counter() - t1
    out["hedge"] = ph  # held against the fused walk in [fused]
    launches["pension"] = counts.only("pension", "the 1M-path pension_hedge")
    check(launches["pension"] == 1, f"pension_hedge launches K3c once ({launches['pension']})")
    rep, bw = ph.report, ph.backward
    n_dates = PENSION_STEPS // PENSION_STORE
    check(bw.values.shape == (N_FULL, n_dates + 1) and bw.phi.shape == (N_FULL, n_dates),
          "pension ledger shapes (n, 41) / (n, 40)")
    check(all(math.isfinite(x) for x in pension_fields(rep)), "pension report fields finite")
    v0_gap = rep.v0 / PENSION_V0_REF - 1
    check(abs(v0_gap) < PENSION_V0_BAND, f"pension V0 {rep.v0:.0f} within 4% of 981,038 "
          f"({v0_gap:+.3%})")
    split = abs(rep.phi0 + rep.psi0 - rep.v0) / rep.v0
    check(split < 0.02, f"|phi0 + psi0 - V0| / V0 = {split:.4f} < 2%")
    print(f"[pension] pension_hedge {N_FULL} paths x {PENSION_STEPS} steps (shared + py, GN "
          f"60/30 + IRLS quantile leg): V0 {rep.v0:.1f} ({v0_gap:+.3%} vs 981,038), phi0 "
          f"{rep.phi0:.1f}, psi0 {rep.psi0:.1f}, |phi0 + psi0 - V0| {split:.4%} of V0; wall "
          f"{out['hedge_s']:.2f} s; K3c launches {launches['pension']}", flush=True)
    print(f"[pension] accepted iterations per date (0..39), MSE leg: {bw.epochs_ran.tolist()}")
    print(f"[pension] accepted iterations per date (0..39), quantile leg: "
          f"{bw.quantile_epochs_ran.tolist()}")
    print(f"[pension] final MSE loss per date: {[float(f'{x:.4e}') for x in bw.train_loss]}")
    print(f"[pension] final pinball loss per date: "
          f"{[float(f'{x:.4e}') for x in bw.quantile_loss]}", flush=True)
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        oos = pension_oos(ph, with_sim(main_cfg, seed=OOS_SEED))
    torch.cuda.synchronize()
    oos_s = time.perf_counter() - t1
    oos_k3c = counts.only("pension", "the 1M-path pension_oos")
    check(oos_k3c == 1, f"pension_oos launches K3c once ({oos_k3c})")
    check(any("dual_mode='shared'" in str(w.message) for w in caught),
          "pension_oos warns about the shared replay")
    check(all(math.isfinite(x) for x in pension_fields(oos.report)), "pension_oos finite")
    np.testing.assert_allclose([oos.report.phi0, oos.report.psi0], [rep.phi0, rep.psi0],
                               rtol=1e-5)
    print(f"[pension] pension_oos {N_FULL} fresh paths (seed {OOS_SEED}): V0 {oos.report.v0:.1f}"
          f" (the quantile leg's value, the shared replay), phi0 {oos.report.phi0:.1f} and psi0 "
          f"{oos.report.psi0:.1f} equal training's (rtol 1e-5); wall {oos_s:.2f} s; K3c "
          f"launches {oos_k3c}", flush=True)
    del oos
    # separate mode: two param sets
    sep_cfg = dataclasses.replace(with_sim(main_cfg, n_paths=N_SEPARATE), train=dataclasses.replace(
        train, dual_mode="separate", holdings_combine="single"))
    t1 = time.perf_counter()
    sep = pension_hedge(sep_cfg)
    torch.cuda.synchronize()
    out["separate_s"] = time.perf_counter() - t1
    sep_gap = sep.report.v0 / PENSION_V0_REF - 1
    check(all(math.isfinite(x) for x in pension_fields(sep.report)), "separate report finite")
    check(abs(sep_gap) < PENSION_V0_BAND, f"separate V0 within 4% of 981,038 ({sep_gap:+.3%})")
    check(sep.backward.params2_by_date is not None
          and sep.backward.params2_by_date["w0"].shape == (n_dates, 3, 8),
          "separate mode keeps the second param set per date")
    print(f"[pension] separate + single at {N_SEPARATE} paths: V0 {sep.report.v0:.1f} "
          f"({sep_gap:+.3%} vs 981,038), phi0 {sep.report.phi0:.1f}, psi0 {sep.report.psi0:.1f};"
          f" params2_by_date present; wall {out['separate_s']:.2f} s", flush=True)
    del sep
    # the CIR-vol fund (K3c's 4-output SV step on the main path)
    sv_cfg = dataclasses.replace(with_sim(main_cfg, n_paths=N_SV), sv=StochVolConfig())
    t1 = time.perf_counter()
    svr = pension_hedge(sv_cfg)
    torch.cuda.synchronize()
    out["sv_s"] = time.perf_counter() - t1
    check(all(math.isfinite(x) for x in pension_fields(svr.report)), "SV report finite")
    total = svr.report.phi0 + svr.report.psi0
    print(f"[pension] SV fund (StochVolConfig()) at {N_SV} paths: V0 {svr.report.v0:.1f}, "
          f"phi0 + psi0 {total:.1f} (PARITY.md:44, Adam at 4,096 paths: 981,732; no band: "
          f"GN-IRLS has no anchor there); wall {out['sv_s']:.2f} s", flush=True)
    del svr

    # -- 13. serve the card-trained pension policy (K2) --------------------------
    p1 = {k: v.detach().cpu().numpy() for k, v in bw.params1_by_date.items()}
    bundle_dir = HERE / "build" / "chip_smoke" / "pension_policy"
    meta = {"model": model_meta(ph.model), "times": ph.times.tolist(),
            "adjustment_factor": ph.adjustment_factor, "dual_mode": ph.dual_mode,
            "holdings_combine": ph.holdings_combine, "cost_of_capital": ph.cost_of_capital,
            "sim_seed": ph.sim_seed}
    save_bundle(bundle_dir, meta, p1, None, {"train_loss": bw.train_loss,
                                             "train_mae": bw.train_mae,
                                             "train_mape": bw.train_mape,
                                             "epochs_ran": bw.epochs_ran})
    policy = load_bundle(bundle_dir)
    engine = HedgeEngine(policy)
    rng = np.random.default_rng(17)
    dates = rng.integers(0, n_dates, N_FULL).astype(np.int32)
    t_d = np.asarray(ph.times)[dates]
    y = np.exp(0.15 * np.sqrt(t_d) * rng.standard_normal(N_FULL) + 0.07 * t_d)
    pop_n = 1.0 - 0.014 * t_d + 0.002 * rng.standard_normal(N_FULL)
    lam = 0.01 * np.exp(0.075 * t_d) + 6e-5 * np.sqrt(t_d) * rng.standard_normal(N_FULL)
    states = np.stack([y, pop_n, lam], 1).astype(np.float32)
    prices = np.stack([y, np.exp(0.03 * t_d)], 1).astype(np.float32)
    counts.reset()
    phi, psi, v = engine.evaluate_mixed_async(dates, states, prices).result()
    serve_k2 = counts.only("mixed_head", "the pension policy's 1M-row serve block")
    p_dev = {k: t.to(dev) for k, t in policy.backward.params1_by_date.items()}
    plain = megakernel.mixed_head_plain(policy.model, p_dev, torch.from_numpy(dates).to(dev),
                                        torch.from_numpy(states).to(dev)).cpu().numpy()
    np.testing.assert_allclose(phi, plain[:, 0], rtol=1e-5, atol=1e-6, err_msg="phi")
    np.testing.assert_allclose(psi, plain[:, 1], rtol=1e-5, atol=1e-6, err_msg="psi")
    np.testing.assert_allclose(v, (plain * prices).sum(1), rtol=1e-5, atol=1e-6, err_msg="v")
    check(policy.dual_mode == "shared" and len(np.unique(dates)) == n_dates,
          "the shared policy's block covers all 40 dates")
    print(f"[serve-pension] card-trained policy -> save_bundle -> load_bundle -> HedgeEngine: "
          f"{N_FULL} rows x 3 features over {n_dates} dates (shared combine) match "
          f"mixed_head_plain (rtol 1e-5, atol 1e-6); K2 launches {serve_k2}", flush=True)
    out["policy"], out["rows"] = policy, (dates, states, prices)

    # -- one LM iteration of each leg at 1M (the last date's regression) -------
    inp = pipelines.pension_inputs(main_cfg, "times", dev)
    t = n_dates - 1
    prices_all = backward._stack_prices(inp.y, inp.b)
    model = ph.model
    theta = model.flatten({k: v[t] for k, v in bw.params1_by_date.items()})
    for leg, problem in (
            ("mse", gn._GNProblem(model, inp.features[:, t], prices_all[:, t + 1], inp.terminal,
                                  gn.GNConfig())),
            ("pinball", gn._GNProblem(model, inp.features[:, t], prices_all[:, t + 1],
                                      inp.terminal, gn.GNPinballConfig(),
                                      loss_fn=losses.make_loss("pinball"),
                                      weights=(0.99, 0.01, 1e-3)))):
        problem.start(theta)
        out[f"iter_{leg}_ms"] = cuda_ms(problem.iterate, reps=5, rounds=7)
        del problem
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tier_phase(dev, counts, policy, dates, states, prices, what: str) -> dict:
    """[tiers]: one 1M-row mixed-date request of ``policy`` through
    ``HedgeEngine(policy, precision=tier)`` for each tier. Checks: K2's f32
    kernel (f32, int8) or bf16 kernel (bf16) launches once per param set and no
    other kernel does; phi, psi and v are finite f32; f32 and int8 agree with
    the port's CPU tier (the plain versions, which tests/test_torch_precision.py
    holds to the JAX package's engine) on the same rows at rtol 1e-5 / atol
    1e-6; bf16 equals, bitwise, the tier computed by the kernel's documented
    arithmetic (``mixed_head_bf16_order`` on the policy's params cast to bf16,
    then the engine's ``serve_outputs``), and its agreement with the CPU tier
    is printed by ``BF16_RULE``'s measures. Reports each tier's max |dphi|,
    |dpsi|, |dv| against the f32 tier beside PRECISION_BANDS, the CPU tier's
    deviation, and host-to-host rows/s (median of 3)."""
    import numpy as np
    import torch

    from orp_tpu_torch.serve import HedgeEngine, loop_of_buckets
    from orp_tpu_torch.serve.bench import PRECISION_BANDS
    from orp_tpu_torch.serve.precision import bf16_agreement

    n_sets = 1 if policy.dual_mode == "mse_only" else 2
    out, ref, ref_cpu = {}, None, None
    for tier in ("f32", "bf16", "int8"):
        engine = HedgeEngine(policy, precision=tier)
        engine.evaluate_mixed_async(dates[:4096], states[:4096], prices[:4096]).result()
        torch.cuda.synchronize()
        counts.reset()
        walls = []
        t1 = time.perf_counter()
        got = engine.evaluate_mixed_async(dates, states, prices).result()
        walls.append(time.perf_counter() - t1)
        kernel = "mixed_head_bf16" if tier == "bf16" else "mixed_head"
        launches = counts.only(kernel, f"the {what} 1M-row {tier} request")
        check(launches == n_sets, f"{what} {tier}: K2 launches {launches} == {n_sets}, one "
              "per param set")
        for _ in range(2):
            t1 = time.perf_counter()
            engine.evaluate_mixed_async(dates, states, prices).result()
            walls.append(time.perf_counter() - t1)
        for name, a in zip(("phi", "psi", "v"), got):
            check(a.dtype == np.float32 and a.shape[0] == len(dates)
                  and bool(np.isfinite(a).all()), f"{what} {tier} {name}: finite f32 rows")
        cpu = loop_of_buckets(HedgeEngine(policy, device="cpu", precision=tier), dates,
                              states, prices)
        agree = {}
        if tier == "bf16":
            want = served_bf16_order(dev, policy, dates, states, prices)
            for name, a, b, c in zip(("phi", "psi", "v"), got, want, cpu):
                check(np.array_equal(a, b), f"{what} bf16 {name}: the served tier bitwise "
                      "the kernel's documented order")
                agree[name] = bf16_agreement(a, c)
        else:
            for name, a, b in zip(("phi", "psi", "v"), got, cpu):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{what} {tier} {name}: card vs CPU tier")
        if tier == "f32":
            ref, ref_cpu = got, cpu
        dev_ = [float(np.max(np.abs(a - b))) for a, b in zip(got, ref)]
        dev_cpu = [float(np.max(np.abs(a - b))) for a, b in zip(cpu, ref_cpu)]
        band = PRECISION_BANDS[tier]
        inside = max(dev_[:2]) <= band
        out[tier] = {"dev": dev_, "dev_cpu": dev_cpu, "launches": launches,
                     "rows_s": len(dates) / sorted(walls)[1], "inside": inside, "agree": agree}
        share = (" bitwise its documented order; vs the CPU tier " + ", ".join(
            f"{k} {v['equal_share']:.6%} bitwise (max {v['max_ulps']:.2f} bf16 spacings, "
            f"{'inside' if v['ok'] else 'outside'} BF16_RULE)"
            for k, v in agree.items()) + ";") if agree else ""
        print(f"[tiers] {what} {tier}: max |dphi| {dev_[0]:.4g}, |dpsi| {dev_[1]:.4g}, |dv| "
              f"{dev_[2]:.4g} vs f32 (CPU tier: {dev_cpu[0]:.4g}, {dev_cpu[1]:.4g}, "
              f"{dev_cpu[2]:.4g}); PRECISION_BANDS[{tier}] {band:g}: "
              f"{'inside' if inside else 'outside'};{share} K2 launches {launches}; "
              f"{out[tier]['rows_s']:,.0f} rows/s host-to-host (median of 3)", flush=True)
    return out


def served_bf16_order(dev, policy, dates, states, prices):
    """The bf16 tier's ``(phi, psi, v)`` of ``policy`` on the card with K2's bf16
    arithmetic in plain PyTorch: ``mixed_head_bf16_order`` under each param set
    cast to bf16, then the engine's ``serve_outputs``."""
    import numpy as np
    import torch

    from orp_tpu_torch.serve import megakernel

    m = policy.model.with_dtype(torch.bfloat16)
    d = torch.from_numpy(np.asarray(dates, np.int64)).to(dev)
    # the engine pads host rows in the model's dtype (f32) before the bf16 cast
    f = torch.from_numpy(np.asarray(states, np.float32)).to(dev).to(torch.bfloat16)
    bw = policy.backward

    def head(params):
        p = {k: torch.as_tensor(v).to(dev, torch.bfloat16) for k, v in params.items()}
        return megakernel.mixed_head_bf16_order(m, p, d, f)

    raw1 = head(bw.params1_by_date)
    # a policy stored without a second param set serves the first under both, as the engine
    raw2 = (raw1 if policy.dual_mode == "mse_only" or bw.params2_by_date is None
            else head(bw.params2_by_date))
    pr = torch.from_numpy(np.asarray(prices, np.float32)).to(dev)
    out = megakernel.serve_outputs(m, raw1, raw2, pr,
                                   policy.cost_of_capital, dual_mode=policy.dual_mode,
                                   holdings_combine=policy.holdings_combine)
    return [t.cpu().numpy() for t in out]


def k2_times(dev, policy, n_rows: int, seed: int, small: int = 4096) -> dict:
    """K2's f32 and bf16 kernels and their plain versions with CUDA events on
    ``n_rows`` random rows of ``policy``'s shape, and the kernels on the first
    ``small`` of those rows (keys ``f32_small``, ...), beside each one's bound."""
    import torch

    from orp_tpu_torch.serve import megakernel
    from orp_tpu_torch.utils.measure import cuda_ms

    model, n_dates = policy.model, policy.n_dates
    gen = torch.Generator(device=dev).manual_seed(seed)
    dates = torch.randint(0, n_dates, (n_rows,), device=dev, generator=gen, dtype=torch.int32)
    feats = (1.0 + 0.1 * torch.randn(n_rows, model.n_features, device=dev, generator=gen))
    out = {}
    for dt, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        m = model.with_dtype(dt)
        p = {k: v.to(dev, dt) for k, v in policy.backward.params1_by_date.items()}
        f = feats.to(dt).contiguous()
        packed = megakernel.pack_head_params(m, p)
        key = "f32" if dt == torch.float32 else "bf16"
        out[key] = cuda_ms(lambda: megakernel.mixed_head_forward(m, p, dates, f,
                                                                 packed=packed), reps=200)
        out[key + "_plain"] = cuda_ms(lambda: megakernel.mixed_head_plain(m, p, dates, f),
                                      reps=2, rounds=3)
        out[key + "_bound"] = k2_bound_ms(model, n_rows, n_dates, elem)
        d_s, f_s = dates[:small], f[:small].contiguous()
        out[key + "_small"] = cuda_ms(lambda: megakernel.mixed_head_forward(
            m, p, d_s, f_s, packed=packed), reps=200)
        out[key + "_small_bound"] = k2_bound_ms(model, small, n_dates, elem)
    return out


# the north star's Adam configuration (benchmarks/north_star.py: batch_size = n_paths
# // 64, blocks shuffle, lr 1e-3, 120 + 51 x 30 epochs), fused=False: the port's host loop
ADAM_TRAIN = dict(dual_mode="mse_only", epochs_first=120, epochs_warm=30, batch_size=16_384,
                  lr=1e-3, shuffle="blocks")
# examples/out_of_sample.py's training config (run there with fused=True)
EXAMPLE_TRAIN = dict(dual_mode="mse_only", epochs_first=120, epochs_warm=30, batch_size=2048,
                     lr=1e-3, shuffle="blocks")
# the reference's own Adam workloads (tools/parity_runs.py, copied: the port does not
# import it): euro_flagship_cfg(1234), seeds3_cfg(1234) and seeds3_gn_cfg(1234) with
# the Adam quantile leg; bands of tests/test_golden.py and PARITY.md
EURO_FLAGSHIP = dict(v0=11.352, phi0=0.10456, psi0=0.89544, disc=10.479, var99=4.05,
                     resid_std=1.7504)
# The network's V0 moves with the walk's random stream: the JAX package's own Adam
# walk on these paths, over walk seeds 1-24, lands at mean EURO_V0_SEEDS["mean"], sd
# EURO_V0_SEEDS["sd"], outside the golden 6% band around 11.352 on 13 of 24 seeds
# (tools/adam_seed_spread.py --package jax). The port draws its orders from its own
# generators (threefry cannot be reproduced), so its V0 is another draw of that law:
# gated within 3 sd of the JAX walk's seed mean, the 6% band printed beside it.
EURO_V0_SEEDS = dict(mean=12.052980934580168, sd=0.6369408186988019)
MULTI_V0_BAND = 0.035


def adam_launches(dev) -> dict:
    """Host launch calls and device kernels per Adam step at the north star's batch
    shape (a 1M-row fit, two epochs of 64 steps), each epoch a CUDA graph and op by
    op, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import fit, losses

    gen = torch.Generator(device=dev).manual_seed(5)
    s = torch.exp(0.15 * torch.randn(N_FULL, device=dev, generator=gen))
    data = (s[:, None], torch.stack([s, torch.full_like(s, 0.0108)], -1),
            torch.clamp(s - 1.0, min=0.0))
    model = HedgeMLP(n_features=1)
    params = {k: v.to(dev) for k, v in model.init(torch.Generator().manual_seed(3),
                                                  bias_init=(0.1, 0.0)).items()}
    cfg = fit.FitConfig(n_epochs=2, batch_size=ADAM_TRAIN["batch_size"], patience=5,
                        shuffle="blocks", lr=1e-3)
    out = {}

    def run():
        return fit.fit_core(model, params, *data, torch.Generator().manual_seed(1),
                            loss_fn=losses.mse, cfg=cfg)

    for mode, graphs in (("graph", True), ("eager", False)):
        fit.CUDA_GRAPHS = graphs
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        steps = 2 * N_FULL // ADAM_TRAIN["batch_size"]
        host = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaGraphLaunch"))
        kernels = sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        out[mode] = (host / steps, kernels / steps)
    fit.CUDA_GRAPHS = True
    return out


def adam_phases(dev, counts, bs: float) -> dict:
    """[adam], [adam-f64], [adam-reference] and [exact]: the Adam walk and exact
    thinning, this slice's paths."""
    import numpy as np
    import torch

    from orp_tpu_torch.api import (EuropeanConfig, HedgeRunConfig, MarketConfig, SimConfig,
                                   TrainConfig, european_hedge, pension_hedge)
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.qmc import fused_gbm
    from orp_tpu_torch.sde import TimeGrid, simulate_pension
    from orp_tpu_torch.serve import HedgeEngine, megakernel, policy_from_numpy
    from orp_tpu_torch.serve.bundle import model_meta
    from orp_tpu_torch.train import BackwardConfig, backward, backward_induction, fit, losses

    # -- 15. [adam] main path D: the north star's Adam walk at 1M (K1), served (K2)
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    ah = european_hedge(EuropeanConfig(constrain_self_financing=False),
                        SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364, rebalance_every=7,
                                  engine="pallas"), TrainConfig(**ADAM_TRAIN))
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t1
    k1_adam = counts.only("fused_gbm", "the 1M-path Adam european_hedge")
    rep, bw = ah.report, ah.backward
    bp = (rep.v0_acv - bs) / bs * 1e4
    check(all(math.isfinite(x) for x in report_fields(rep)), "Adam european_hedge report finite")
    check(bw.values.shape == (N_FULL, 53), "Adam european_hedge ledger shape")
    check(abs(bp) < 1.0, f"Adam european_hedge |v0_acv - BS| {bp:+.4f}bp < 1bp")
    eps = bw.epochs_ran
    steps = int(eps.sum()) * max(N_FULL // ADAM_TRAIN["batch_size"], 1)
    per_step = adam_launches(dev)
    print(f"[adam] european_hedge {N_FULL} paths x {N_STEPS} steps, Adam 120 + 51 x 30 "
          f"epochs, batch 16384, blocks, lr 1e-3: v0_acv {rep.v0_acv:.6f} vs BS {bs:.6f} "
          f"bp_err {bp:+.4f}, v0_cv {rep.v0_cv:.6f}, v0_network {rep.v0:.4f}, acv_std "
          f"{rep.acv_std:.4f}; wall {adam_s:.2f} s; {steps} Adam steps; epochs run: first "
          f"date {int(eps[-1])}, warm dates min / median / max {int(eps[:-1].min())} / "
          f"{float(np.median(eps[:-1])):.1f} / {int(eps[:-1].max())}; {adam_s * 1e3 / steps:.4f}"
          f" ms per step (wall / steps); launches per step (host calls, device kernels): "
          f"graph {per_step['graph'][0]:.4f}, {per_step['graph'][1]:.2f}; eager "
          f"{per_step['eager'][0]:.2f}, {per_step['eager'][1]:.2f}; K1 launches {k1_adam}",
          flush=True)
    meta = {"model": model_meta(ah.model), "times": ah.times.tolist(),
            "adjustment_factor": ah.adjustment_factor, "dual_mode": ah.dual_mode,
            "holdings_combine": ah.holdings_combine, "cost_of_capital": ah.cost_of_capital,
            "sim_seed": ah.sim_seed}
    apolicy = policy_from_numpy(meta, {k: v.detach().cpu().numpy()
                                       for k, v in bw.params1_by_date.items()})
    del ah, bw
    rng = np.random.default_rng(19)
    dates = rng.integers(0, 52, N_FULL).astype(np.int32)
    t_d = np.asarray(apolicy.times)[dates]
    st = np.exp(0.15 * np.sqrt(t_d) * rng.standard_normal(N_FULL) + 0.07 * t_d)
    states = st[:, None].astype(np.float32)
    prices = np.stack([st, np.exp(0.08 * t_d) / 100.0], 1).astype(np.float32)
    engine = HedgeEngine(apolicy)
    counts.reset()
    t1 = time.perf_counter()
    phi, psi, v = engine.evaluate_mixed_async(dates, states, prices).result()
    serve_s = time.perf_counter() - t1
    serve_k2 = counts.only("mixed_head", "the Adam-trained policy's 1M-row block")
    p_dev = {k: t.to(dev) for k, t in apolicy.backward.params1_by_date.items()}
    plain = megakernel.mixed_head_plain(apolicy.model, p_dev, torch.from_numpy(dates).to(dev),
                                        torch.from_numpy(states).to(dev)).cpu().numpy()
    np.testing.assert_allclose(phi, plain[:, 0], rtol=1e-5, atol=1e-6, err_msg="phi")
    np.testing.assert_allclose(psi, plain[:, 1], rtol=1e-5, atol=1e-6, err_msg="psi")
    np.testing.assert_allclose(v, (plain * prices).sum(1), rtol=1e-5, atol=1e-6, err_msg="v")
    print(f"[adam] the Adam-trained policy as one {N_FULL}-row block over 52 dates through "
          f"HedgeEngine matches mixed_head_plain (rtol 1e-5, atol 1e-6); {serve_s:.3f} s "
          f"host-to-host; K2 launches {serve_k2}", flush=True)

    # -- 16. [adam-f64] the same Adam walk in float64 on the card and on the CPU ----
    # The walk is chaotic in f64: Adam's step m / (sqrt(v) + eps) divides by small
    # gradients, so the card's and the CPU's roundings grow from date to date (the
    # free-running walks' gap is printed at every tenth date). So each date's fit is
    # held to the same fit on the CPU from the card's inputs (its warm params,
    # target and the same orders).
    t1 = time.perf_counter()
    s = fused_gbm.gbm_log_fused(N_FIXTURE, N_STEPS, s0=100.0, drift=0.08, sigma=0.15,  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
                                dt=1 / N_STEPS, seed=1235, store_every=STORE,
                                device=dev).double() / 100.0
    b = torch.exp(0.08 * torch.linspace(0.0, 1.0, 53, dtype=torch.float64)) / 100.0  # orp: noqa[ORP001] -- the f64 walk this check holds card against CPU
    term = torch.clamp(s[:, -1] - 1.0, min=0.0)
    model = HedgeMLP(n_features=1, dtype=torch.float64)  # orp: noqa[ORP001] -- the f64 walk this check holds card against CPU
    bias = (float(term.mean()), 0.0)
    sc = s.cpu()
    prices = backward._stack_prices(sc, b)
    cpu = torch.device("cpu")
    worst, parted, profile = {}, {}, {}
    for shuffle in (False, "blocks"):
        cfg = BackwardConfig(dual_mode="mse_only", epochs_first=4, epochs_warm=2,
                             patience_warm=1, batch_size=512, lr=1e-3, shuffle=shuffle)
        card = backward_induction(model, s[:, :, None], s, b.to(dev), term, cfg, bias_init=bias)
        host = backward_induction(model, sc[:, :, None], sc, b, term.cpu(), cfg, bias_init=bias)
        p_card = {k: v.cpu() for k, v in card.params1_by_date.items()}
        vals, phi_c, psi_c = card.values.cpu(), card.phi.cpu(), card.psi.cpu()
        start, _ = backward._initial_params(model, cfg, bias, None, cpu, torch.float64)  # orp: noqa[ORP001] -- the f64 walk this check holds card against CPU
        err = {"params": 0.0, "values": 0.0, "holdings": 0.0}
        parted[shuffle], profile[shuffle] = None, {}
        for step_i, t in enumerate(range(51, -1, -1)):
            first = step_i == 0
            fcfg = fit.FitConfig(n_epochs=cfg.epochs_first if first else cfg.epochs_warm,
                                 batch_size=cfg.batch_size,
                                 patience=cfg.patience_first if first else cfg.patience_warm,
                                 lr=cfg.lr, shuffle=cfg.shuffle)
            if not first:
                start = {k: v[t + 1] for k, v in p_card.items()}
            got, aux = fit.fit_core(model, start, sc[:, t, None], prices[:, t + 1], vals[:, t + 1],
                                    backward._fit_generator(cfg.seed, step_i, 0),
                                    loss_fn=losses.mse, cfg=fcfg)
            check(int(aux["n_epochs_ran"]) == int(card.epochs_ran[t]),
                  f"[adam-f64] {shuffle} date {t}: the same epochs on the card and the CPU")
            hold = model.holdings(got, sc[:, t, None])
            pairs = {"params": [(p_card[k][t], got[k]) for k in got],
                     "values": [(vals[:, t], model.value(got, sc[:, t, None], prices[:, t]))],
                     "holdings": [(phi_c[:, t], hold[:, 0]), (psi_c[:, t], hold[:, 1])]}
            for what, xs in pairs.items():
                for a_, w_ in xs:
                    np.testing.assert_allclose(a_.numpy(), w_.numpy(), rtol=1e-7, atol=1e-10,
                                               err_msg=f"[adam-f64] {shuffle} date {t} {what}")
                    rel = float((a_ - w_).abs().max() / w_.abs().max().clamp(min=1e-300))
                    err[what] = max(err[what], rel)
            gap = max(float((p_card[k][t] - host.params1_by_date[k][t]).abs().max()
                            / host.params1_by_date[k][t].abs().max()) for k in p_card)
            if t % 10 == 1:
                profile[shuffle][t] = float(f"{gap:.1e}")
            if parted[shuffle] is None and gap > 1e-7:
                parted[shuffle] = t
        worst[shuffle] = err
    print(f"[adam-f64] Adam walk in float64, {N_FIXTURE} paths x 52 dates (4 + 51 x 2 "
          f"epochs, batch 512, lr 1e-3), shuffle False and blocks: every date's fit on the "
          f"card (CUDA graphs) equals the same fit on the CPU from the card's inputs at rtol "
          f"1e-7, the same epochs on every date; largest gaps (max |card - CPU| / max "
          f"|CPU|) {worst}; the free-running card and CPU walks (f64 chaos): params gap "
          f"max |card - CPU| / max |CPU| at dates 51, 41, ..., 1 {profile}, first above "
          f"1e-7 at date {parted}; {time.perf_counter() - t1:.2f} s", flush=True)

    # -- 17. [adam-reference] the reference's Adam workloads at their own sizes -----
    out = {}
    t1 = time.perf_counter()
    eu = european_hedge(EuropeanConfig(), SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                                    rebalance_every=7, seed=1234,
                                                    seed_fund=1235),
                        TrainConfig(dual_mode="mse_only", seed=1234))
    torch.cuda.synchronize()
    euro_s = time.perf_counter() - t1
    er = eu.report
    resid = eu.backward.var_residuals[:, -1].double().cpu().numpy() * 100.0  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    ref = EURO_FLAGSHIP
    gaps = {"v0": er.v0 / ref["v0"] - 1, "phi0": er.phi0 - ref["phi0"],
            "psi0": er.psi0 - ref["psi0"], "disc": er.discounted_payoff / ref["disc"] - 1,
            "var99": er.var_overall[1] / ref["var99"] - 1,
            "resid_std": resid.std() / ref["resid_std"] - 1}
    print(f"[adam-reference] Euro flagship (euro_flagship_cfg(1234): 4096 paths, 52 dates, "
          f"Adam 500/100, scan engine): V0 {er.v0:.4f} ({gaps['v0']:+.2%} vs 11.352, band 6%),"
          f" phi0 {er.phi0:.5f} / psi0 {er.psi0:.5f} (vs 0.10456 / 0.89544, band 0.02), "
          f"discounted payoff {er.discounted_payoff:.4f} ({gaps['disc']:+.2%}, band 2%), VaR99 "
          f"{er.var_overall[1]:.4f} ({gaps['var99']:+.2%}, band 25%), terminal residual std "
          f"{resid.std():.4f} ({gaps['resid_std']:+.2%}, band 15%); epochs first "
          f"{int(eu.backward.epochs_ran[-1])}, warm median "
          f"{float(np.median(eu.backward.epochs_ran[:-1])):.1f}; wall {euro_s:.2f} s",
          flush=True)
    seeds = EURO_V0_SEEDS
    print(f"[adam-reference] Euro flagship V0 {er.v0:.4f}: "
          f"{'inside' if abs(gaps['v0']) < 0.06 else 'outside'} the golden 6% band around "
          f"11.352 (not gated: the JAX walk's own seeds fall outside it on 13 of 24); the JAX "
          f"walk's seed mean {seeds['mean']:.4f} +- 3 sd {3 * seeds['sd']:.4f} (gated)",
          flush=True)
    check(abs(er.v0 - seeds["mean"]) < 3 * seeds["sd"],
          f"Euro flagship V0 {er.v0:.4f} within 3 sd of the JAX walk's seed mean")
    check(abs(gaps["phi0"]) < 0.02 and abs(gaps["psi0"]) < 0.02,
          "Euro flagship phi0 / psi0 within 0.02")
    check(abs(gaps["disc"]) < 0.02, "Euro flagship discounted payoff within 2%")
    check(abs(gaps["var99"]) < 0.25, "Euro flagship VaR99 within 25% of 4.05")
    check(abs(gaps["resid_std"]) < 0.15, "Euro flagship terminal residual std within 15%")
    out["euro_s"] = euro_s
    multi_sim = SimConfig(n_paths=4096, T=10.0, dt=0.01, rebalance_every=25, seed=1234,
                          seed_fund=1235)
    shared = dict(dual_mode="shared", holdings_combine="py", seed=1234)
    for name, train in (("Multi#25-26", TrainConfig(**shared)),
                        ("hybrid", TrainConfig(**shared, optimizer="gauss_newton",
                                               gn_iters_first=60, gn_iters_warm=30,
                                               gn_quantile=False))):
        t1 = time.perf_counter()
        pr = pension_hedge(HedgeRunConfig(market=MarketConfig(), sim=multi_sim, train=train))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        p = pr.report
        rel = p.v0 / PENSION_V0_REF - 1
        gap = abs(p.phi0 + p.psi0 - p.v0) / p.v0
        print(f"[adam-reference] {name} (seeds3{'_gn' if name == 'hybrid' else ''}_cfg(1234):"
              f" 4096 paths x 1000 steps, exact thinning, shared + py, "
              f"{'GN 60/30 + Adam quantile leg' if name == 'hybrid' else 'Adam 500/100 both legs'}"
              f"): V0 {p.v0:.1f} ({rel:+.3%} vs 981,038, band 3.5%), phi0 {p.phi0:.1f}, psi0 "
              f"{p.psi0:.1f}, |phi0 + psi0 - V0| / V0 {gap:.4%}; epochs (GN: accepted "
              f"iterations) MSE / quantile leg {int(pr.backward.epochs_ran.sum())} / "
              f"{int(pr.backward.quantile_epochs_ran.sum())}; wall {wall:.2f} s", flush=True)
        check(all(math.isfinite(x) for x in (p.v0, p.phi0, p.psi0)), f"{name} finite")
        check(abs(rel) < MULTI_V0_BAND, f"{name} V0 within 3.5% of 981,038 ({rel:+.3%})")
        if name == "Multi#25-26":
            check(gap < 0.02, f"{name} |phi0 + psi0 - V0| < 2% V0")
            check(600e3 < p.phi0 < 780e3 and 200e3 < p.psi0 < 380e3,
                  f"{name} phi0 in (600k, 780k), psi0 in (200k, 380k)")
        out[name] = wall

    # -- 18. [exact] the law of exact thinning on the card, at 1M paths ----------
    t1 = time.perf_counter()
    grid = TimeGrid(10.0, PENSION_STEPS)
    idx = torch.arange(N_FULL, device=dev)
    kw = dict(PENSION, store_every=PENSION_STORE, binomial_mode="exact", seed=1234)
    a = simulate_pension(idx, grid, **kw)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t1
    n_t = a["N"][:, -1].double()  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    law = (float(n_t.mean()), float(n_t.std()))
    check(a["N"].shape == (N_FULL, PENSION_STEPS // PENSION_STORE + 1), "[exact] shape")
    check(bool(torch.isfinite(a["Y"]).all()) and bool(torch.equal(a["N"], torch.round(a["N"]))),
          "[exact] finite fund, integer survivors")
    check(abs(law[0] - 8616) < 40 and abs(law[1] - 132) < 30,
          f"[exact] E[N_T] {law[0]:.2f} (8616 +- 40), sd {law[1]:.2f} (132 +- 30)")
    print(f"[exact] simulate_pension exact thinning (threefry-addressed by (seed, step, path "
          f"index)), {N_FULL} paths x {PENSION_STEPS} steps stored every {PENSION_STORE} (scan "
          f"path on the card): E[N_T] {law[0]:.2f} (8616 +- 40), sd {law[1]:.2f} (132 +- 30); "
          f"{exact_s:.2f} s a run (the per-step generator it replaced: 4.78 s); [mesh] "
          f"holds four ranks' shards to this run", flush=True)
    out.update(adam_s=adam_s, steps=steps, exact_s=exact_s, exact_n=a["N"].cpu())
    return out


def walls_equal(got, want, what: str, quantile: bool = False) -> None:
    """Check two walks' ledgers, per-date params, metrics and iterations bitwise."""
    import numpy as np
    import torch

    for k in ("values", "phi", "psi", "var_residuals"):
        check(torch.equal(getattr(got, k), getattr(want, k)), f"{what}: {k} bitwise equal")
    for which in ("params1_by_date", "params2_by_date"):
        w = getattr(want, which)
        check((w is None) == (getattr(got, which) is None), f"{what}: {which} present alike")
        for k, v in (w or {}).items():
            check(torch.equal(getattr(got, which)[k], v), f"{what}: {which}[{k}] bitwise equal")
    keys = ["train_loss", "train_mae", "train_mape", "epochs_ran"]
    keys += ["quantile_loss", "quantile_epochs_ran"] if quantile else []
    for k in keys:
        check(np.array_equal(getattr(got, k), getattr(want, k)), f"{what}: {k} equal")


def timed(fn):
    """``fn()`` and its host wall, synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fused_phases(dev, counts, euro_host, euro_s: float, pension_host, pension_s: float,
                 bs: float) -> dict:
    """[fused] and [fused-adam]: the fused walk (``TrainConfig(fused=True)``), each held
    to its host loop on the same paths."""
    import dataclasses

    import numpy as np
    import torch

    from orp_tpu_torch.api import (EuropeanConfig, HedgeRunConfig, SimConfig, TrainConfig,
                                   european_hedge, pension_hedge)
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import backward, gn
    from orp_tpu_torch.train.backward import fused_loop_scope
    from orp_tpu_torch.utils.measure import count_syncs, lm_census, no_host_sync

    out = {}
    euro = EuropeanConfig(constrain_self_financing=False)
    sim = SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364, rebalance_every=STORE, engine="pallas")
    gn_train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton", fused=True)
    # every fused walk below runs its date loop under sync-debug "error"
    loops = []

    def loop_scope(device):
        loops.append(device)
        return no_host_sync(device)

    backward.fused_loop_scope = loop_scope

    # -- the north star, GN defaults, fused (K1) --------------------------------
    counts.reset()
    (fh, out["euro_fused_s"]), syncs = count_syncs(lambda: timed(
        lambda: european_hedge(euro, sim, gn_train)))
    check(len(loops) == 1, f"the fused walk's date loop ran under sync-debug 'error' ({loops})")
    k1 = counts.only("fused_gbm", "the fused 1M-path european_hedge")
    check(k1 == 1, f"the fused european_hedge launches K1 once ({k1})")
    walls_equal(fh.backward, euro_host.backward, "[fused] north star vs [euro]")
    bp = (fh.report.v0_acv - bs) / bs * 1e4
    check(abs(bp) < 1.0, f"fused european_hedge |v0_acv - BS| {bp:+.4f}bp < 1bp")
    print(f"[fused] european_hedge {N_FULL} paths, GN 30 + 51 x 10, fused (each LM iteration a "
          f"CUDA graph, the date loop under sync-debug 'error'): values, holdings, per-date "
          f"params and accepted iterations bitwise [euro]'s; v0_acv bp_err {bp:+.4f}; wall "
          f"{out['euro_fused_s']:.3f} s fused vs {euro_s:.3f} s host loop; synchronizing CUDA "
          f"calls in the whole entry point {syncs}; K1 launches {k1}", flush=True)
    out["euro_fused"] = fh  # [obs] holds its telemetered fused walk to this one

    # -- the benchmark's GN configuration, fused --------------------------------
    bench = dataclasses.replace(gn_train, gn_iters_first=150, gn_iters_warm=75,
                                gn_block_rows=1 << 14)
    counts.reset()
    bh, out["bench_fused_s"] = timed(lambda: european_hedge(euro, sim, bench))
    counts.only("fused_gbm", "the fused benchmark-config european_hedge")
    bp = (bh.report.v0_acv - bs) / bs * 1e4
    check(abs(bp) < 1.0, f"benchmark-config fused |v0_acv - BS| {bp:+.4f}bp < 1bp")
    check(bool(np.isfinite(bh.backward.train_loss).all()), "benchmark-config losses finite")
    iters = 150 + 51 * 75
    # one LM iteration of the blocked program at the walk's shapes (1M rows, one
    # feature, date 51's trained params), op by op and as a graph
    model = HedgeMLP(n_features=1)
    t = 51
    feats = torch.rand((N_FULL, 1), device=dev) + 0.5  # orp: noqa[ORP004] -- the inputs of a kernel-vs-plain check: both arms read this same tensor
    prices = torch.stack([feats[:, 0], torch.full_like(feats[:, 0], 0.01083)], -1)
    target = torch.clamp(feats[:, 0] - 1.0, min=0.0)
    prog = gn.gn_program(model, feats, prices, target,
                         gn.GNConfig(n_iters=1, block_rows=1 << 14))
    prog.start(model.flatten({k: v[t] for k, v in bh.backward.params1_by_date.items()}))
    census = lm_census(prog)
    out["bench_census"] = census
    del prog
    print(f"[fused] benchmark GN configuration (150 + 51 x 75 LM iterations, gn_block_rows "
          f"16384: {N_FULL >> 14} row blocks), fused: v0_acv bp_err {bp:+.4f}; wall "
          f"{out['bench_fused_s']:.3f} s ({out['bench_fused_s'] * 1e3 / iters:.3f} ms an LM "
          f"iteration, {iters} iterations); accepted iterations per date (0..51) "
          f"{bh.backward.epochs_ran.tolist()}", flush=True)
    print(f"[fused] one blocked LM iteration at {N_FULL} rows: op by op {census['eager_ms']:.3f} "
          f"ms with {census['host_launches']} host launch calls and {census['device_kernels']} "
          f"device kernels; as a CUDA graph {census['graph_ms']:.3f} ms, {census['nodes']} "
          f"(nodes, kernel nodes); capture {census['capture_s']:.3f} s, instantiate "
          f"{'not measured' if census['instantiate_s'] is None else census['instantiate_s']}"
          f" s", flush=True)
    del bh

    # -- the pension, fused (K3c) ------------------------------------------------
    ptrain = TrainConfig(dual_mode="shared", holdings_combine="py", optimizer="gauss_newton",
                         gn_iters_first=60, gn_iters_warm=30, fused=True)
    psim = SimConfig(n_paths=N_FULL, T=10.0, dt=0.01, rebalance_every=PENSION_STORE, seed=1234,
                     engine="pallas", binomial_mode="inversion")
    counts.reset()
    pf, out["pension_fused_s"] = timed(lambda: pension_hedge(HedgeRunConfig(sim=psim,
                                                                            train=ptrain)))
    k3c = counts.only("pension", "the fused 1M-path pension_hedge")
    check(k3c == 1, f"the fused pension_hedge launches K3c once ({k3c})")
    walls_equal(pf.backward, pension_host.backward, "[fused] pension vs [pension]", quantile=True)
    gap = pf.report.v0 / PENSION_V0_REF - 1
    check(abs(gap) < PENSION_V0_BAND, f"fused pension V0 within 4% of 981,038 ({gap:+.3%})")
    print(f"[fused] pension_hedge {N_FULL} x {PENSION_STEPS} steps (shared + py, GN 60/30 + "
          f"IRLS), fused: both legs' ledgers, params and iterations bitwise [pension]'s; V0 "
          f"{pf.report.v0:.1f} ({gap:+.3%}); wall {out['pension_fused_s']:.3f} s fused vs "
          f"{pension_s:.3f} s host loop; K3c launches {k3c}", flush=True)
    del pf

    # -- [fused-adam] the reference's own fused example (examples/out_of_sample.py) --
    esim = SimConfig(n_paths=16_384, T=1.0, dt=1 / 364, rebalance_every=STORE)
    etrain = TrainConfig(**EXAMPLE_TRAIN)
    (ah, out["adam_host_s"]), out["adam_host_syncs"] = count_syncs(
        lambda: timed(lambda: european_hedge(euro, esim, etrain)))
    (af, out["adam_fused_s"]), out["adam_fused_syncs"] = count_syncs(
        lambda: timed(lambda: european_hedge(euro, esim, dataclasses.replace(etrain,
                                                                            fused=True))))
    walls_equal(af.backward, ah.backward, "[fused-adam] fused vs host loop")
    ran = int(ah.backward.epochs_ran.sum())
    budget = EXAMPLE_TRAIN["epochs_first"] + 51 * EXAMPLE_TRAIN["epochs_warm"]
    print(f"[fused-adam] examples/out_of_sample.py's training (16384 paths, Adam 120/30, batch "
          f"2048, lr 1e-3, blocks): values and epochs_ran bitwise the host loop's; wall "
          f"{out['adam_fused_s']:.3f} s fused vs {out['adam_host_s']:.3f} s host loop; epochs "
          f"run {ran} of {budget} (the fused walk ran all {budget}: {budget - ran} past the "
          f"stop); synchronizing CUDA calls {out['adam_fused_syncs']} fused vs "
          f"{out['adam_host_syncs']} host loop; v0_acv {af.report.v0_acv:.5f}", flush=True)
    check(len(loops) == 4, f"each of the 4 fused walks' date loops ran under 'error' ({loops})")
    backward.fused_loop_scope = fused_loop_scope
    return out


def obs_phases(dev, counts, euro_host, euro_s: float, fused_host, fused_s: float, policy,
               rows, serve_lat_ms: float) -> dict:
    """[obs]: the telemetry spine (``orp_tpu_torch.obs``) on the card. [euro]'s and
    [fused]'s north star again under ``obs.telemetry`` (each bitwise its untelemetered
    run, the fused date loop under ``no_host_sync``), and [serve]'s 1M-row block under
    telemetry and ``devprof.profiling()`` (bitwise, the queue / device partition exact);
    walls beside the untelemetered ones, the 1-row latency with telemetry off beside
    [serve]'s."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from orp_tpu_torch import obs
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.obs import devprof
    from orp_tpu_torch.obs.report import load_convergence
    from orp_tpu_torch.serve import HedgeEngine
    from orp_tpu_torch.serve.engine import span as serve_span
    from orp_tpu_torch.train import backward
    from orp_tpu_torch.utils.measure import no_host_sync

    out = {}
    root = HERE / "build" / "chip_smoke" / "obs"
    euro = EuropeanConfig(constrain_self_financing=False)
    sim = SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364, rebalance_every=STORE, engine="pallas")
    gn_train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")

    def spans_of(bundle):
        events = obs.read_events(bundle / obs.EVENTS_FILE)
        check(all(obs.validate_event(e) == [] for e in events), f"{bundle.name}: events valid")
        return events, collections.Counter((e["name"], e["parent"]) for e in events
                                           if e["type"] == "span")

    # -- the host-loop walk: [euro] under a session ------------------------------
    bundle = root / "host"
    k1_at_close = {}
    counts.reset()
    with obs.telemetry(bundle, flush_every_s=None) as st:
        emit = st.sink.emit

        def emit_counting(event):  # K1's count as each span closes
            if event.get("type") == "span":
                k1_at_close.setdefault(event["name"], counts.read()["fused_gbm"])
            emit(event)

        st.sink.emit = emit_counting
        eo, out["host_s"] = timed(lambda: european_hedge(euro, sim, gn_train))
    k1 = counts.only("fused_gbm", "the telemetered 1M-path european_hedge")
    check(k1 == 1 and k1_at_close["pipeline/simulate"] == 1,
          f"K1 launches once, inside pipeline/simulate ({k1}, {k1_at_close})")
    walls_equal(eo.backward, euro_host.backward, "[obs] telemetered host loop vs [euro]")
    events, spans = spans_of(bundle)
    for key, n in ((("train/fit", "train/walk"), 52), (("train/outputs", "train/walk"), 52),
                   (("train/walk", None), 1), (("pipeline/simulate", None), 1),
                   (("pipeline/report", None), 1)):
        check(spans[key] == n, f"[obs] {n} {key} spans ({spans[key]})")
    check(sum(spans.values()) == 107, f"[obs] no other span ({dict(spans)})")
    conv = load_convergence(bundle)
    conds = conv.get("gram_cond", [])
    check(len(conds) == 52 and all(math.isfinite(c) for c in conds),
          f"[obs] 52 finite gram_cond values ({len(conds)})")
    check(np.array_equal(conv["train_loss"], eo.backward.train_loss),
          "[obs] the convergence record's losses are the walk's")
    man = obs.read_manifest(bundle)
    fp = obs.config_fingerprint(euro, sim, gn_train, "quantile_method=sort")
    check(man["platform"] == "gpu" and man["torch_version"] == torch.__version__
          and man["cuda_version"] == torch.version.cuda and man["run_fingerprint"] == fp
          and man["pipeline"] == "european_hedge" and man["device_count"] >= 1,
          f"[obs] manifest {man}")
    prom = (bundle / obs.METRICS_FILE).read_text()
    check('span_seconds{name="train/fit",quantile="0.5"}' in prom, "[obs] metrics.prom span_seconds")
    walk = [e for e in events if e["type"] == "span" and e["name"] == "train/walk"][0]
    check(walk["attrs"]["n_paths"] == N_FULL and walk["attrs"]["mesh_devices"] == 1,
          f"[obs] train/walk attrs {walk['attrs']}")
    out["walk_span_s"] = walk["dur_s"]
    fit_s = sorted(e["dur_s"] for e in events if e.get("name") == "train/fit")
    print(f"[obs] european_hedge {N_FULL} paths (GN 30 + 51 x 10) under obs.telemetry: ledgers, "
          f"per-date params and iterations bitwise [euro]'s; spans 52 train/fit + 52 "
          f"train/outputs under train/walk, pipeline/simulate and pipeline/report; K1 launches "
          f"{k1}, inside pipeline/simulate; 52 finite gram_cond ({min(conds):.4g} to "
          f"{max(conds):.4g}); manifest platform gpu, torch {man['torch_version']}, cuda "
          f"{man['cuda_version']}, run_fingerprint the configs'; train/fit span median "
          f"{fit_s[len(fit_s) // 2] * 1e3:.3f} ms", flush=True)
    print(f"[obs] walls: host loop {out['host_s']:.3f} s with telemetry vs {euro_s:.3f} s "
          f"[euro] without; train/walk span dur_s {walk['dur_s']:.3f} s inside that host "
          f"wall", flush=True)

    # -- the fused walk: [fused] under a session, the date loop under no_host_sync --
    loops = []

    def loop_scope(device):
        loops.append(device)
        return no_host_sync(device)

    bundle = root / "fused"
    default_scope = backward.fused_loop_scope
    backward.fused_loop_scope = loop_scope
    counts.reset()
    try:
        with obs.telemetry(bundle, flush_every_s=None):
            fo, out["fused_s"] = timed(lambda: european_hedge(
                euro, sim, dataclasses.replace(gn_train, fused=True)))
    finally:
        backward.fused_loop_scope = default_scope
    check(len(loops) == 1, f"[obs] the fused date loop ran under no_host_sync ({loops})")
    counts.only("fused_gbm", "the telemetered fused european_hedge")
    walls_equal(fo.backward, fused_host.backward, "[obs] telemetered fused walk vs [fused]")
    events, spans = spans_of(bundle)
    check(spans[("train/walk", None)] == 1 and spans[("train/fit", "train/walk")] == 0
          and spans[("train/outputs", "train/walk")] == 0,
          f"[obs] the fused walk is one train/walk span ({dict(spans)})")
    fwalk = [e for e in events if e["type"] == "span" and e["name"] == "train/walk"][0]
    out["fused_walk_span_s"] = fwalk["dur_s"]
    print(f"[obs] fused european_hedge under obs.telemetry: bitwise [fused]'s, one train/walk "
          f"span ({fwalk['dur_s']:.3f} s) and none inside the date loop, which ran under "
          f"no_host_sync; wall {out['fused_s']:.3f} s with telemetry vs {fused_s:.3f} s [fused] "
          f"without", flush=True)
    del eo, fo

    # -- serving: [serve]'s 1M-row block under telemetry and devprof -------------
    engine = HedgeEngine(policy)
    off = engine.evaluate_mixed_async(*rows).result()
    bundle = root / "serve"
    calls = []
    counts.reset()
    with obs.telemetry(bundle, flush_every_s=None) as st, devprof.profiling() as prof:
        complete = prof.complete

        def spy(t_dispatch, t_block, *, bucket=None):
            q, d = complete(t_dispatch, t_block, bucket=bucket)
            calls.append((q, d, prof._last_complete - t_dispatch))
            return q, d

        prof.complete = spy
        on = engine.evaluate_mixed_async(*rows).result()
        reg = st.registry.collect()
    k2 = counts.only("mixed_head", "the telemetered 1M-row serve block")
    for a, b, what in zip(on, off, ("phi", "psi", "v")):
        check(np.array_equal(a, b), f"[obs] served {what} bitwise the untelemetered block")
    _, spans = spans_of(bundle)
    check(set(spans) == {("serve/pad", None), ("serve/dispatch", None), ("serve/unpad", None)},
          f"[obs] serve spans {dict(spans)}")
    check(reg["serve/rows"]["value"] == N_FULL and reg["serve/bucket_hits"]["value"] == 1
          and reg["serve/megakernel_dispatches"]["value"] == 1,
          f"[obs] serve counters {reg}")
    (q, d, wall), = calls
    check(q >= 0.0 and d >= 0.0 and abs(q + d - wall) < 1e-9,
          f"[obs] queue_s + device_s == t_done - t_dispatch ({q!r} + {d!r} vs {wall!r})")

    # the 1-row latency: telemetry off now (three trace regions) beside [serve]'s
    def latency(n_rows: int = 1) -> float:
        walls = []
        for _ in range(31):
            t1 = time.perf_counter()
            engine.evaluate_mixed_async(*(x[:n_rows] for x in rows)).result()
            walls.append((time.perf_counter() - t1) * 1e3)
        return sorted(walls)[len(walls) // 2]

    out["lat_off_ms"] = latency()
    with obs.telemetry(root / "serve_latency", flush_every_s=None):
        out["lat_on_ms"] = latency()
    # what the off path adds to a request: its three trace regions (no-ops outside
    # a torch.profiler capture)
    for key, region in (("regions_us", serve_span), ("record_function_us",
                                                     torch.profiler.record_function)):
        t1 = time.perf_counter()
        for _ in range(1000):
            for name in ("serve/pad", "serve/dispatch", "serve/unpad"):
                with region(name):
                    pass
        out[key] = (time.perf_counter() - t1) * 1e3
    print(f"[obs] 1M-row mixed-date block under obs.telemetry + devprof.profiling: bitwise the "
          f"untelemetered block; serve/pad, serve/dispatch, serve/unpad spans; serve/rows "
          f"{reg['serve/rows']['value']}, megakernel_dispatches 1; queue_s {q * 1e3:.3f} ms + "
          f"device_s {d * 1e3:.3f} ms = t_done - t_dispatch {wall * 1e3:.3f} ms; K2 launches "
          f"{k2}", flush=True)
    print(f"[obs] 1-row request latency host to host (median of 31): telemetry off "
          f"{out['lat_off_ms']:.3f} ms vs [serve]'s {serve_lat_ms:.3f} ms in this call; "
          f"telemetry on {out['lat_on_ms']:.3f} ms; the off path's three trace regions "
          f"{out['regions_us']:.2f} us a request on this host, three record_function regions "
          f"with no profiler running {out['record_function_us']:.2f} us", flush=True)
    return out


def resilience_phases(dev, counts, euro_host, euro_s: float, bs: float) -> dict:
    """[resume] and [guard]: [euro]'s north-star walk killed and resumed from its
    checkpoints, then with the NaN guard, clean and with a poisoned date."""
    import dataclasses
    import shutil

    import torch

    from orp_tpu_torch import guard
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.guard import sentinel

    out = {}
    euro = EuropeanConfig(constrain_self_financing=False)
    sim = SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364, rebalance_every=STORE, engine="pallas")
    gn_train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    root = HERE / "build" / "chip_smoke" / "resume"
    shutil.rmtree(root, ignore_errors=True)
    try:
        full_dir, kill_dir = root / "full", root / "killed"
        ck, out["ckpt_s"] = timed(lambda: european_hedge(
            euro, sim, dataclasses.replace(gn_train, checkpoint_dir=str(full_dir))))
        walls_equal(ck.backward, euro_host.backward, "[resume] checkpointed walk vs [euro]")
        del ck
        out["ckpt_bytes"] = sum(f.stat().st_size for f in full_dir.iterdir())
        kcfg = dataclasses.replace(gn_train, checkpoint_dir=str(kill_dir))
        t0 = time.perf_counter()
        with guard.faults(guard.FaultPlan(kill_after_step=25)) as inj:
            try:
                european_hedge(euro, sim, kcfg)
                check(False, "the FaultPlan's kill after step 25 fired")
            except guard.WalkKilled:
                torch.cuda.synchronize()
        out["killed_s"] = time.perf_counter() - t0
        check(inj.log == [("train/kill", "step=25")], f"killed after step 25 ({inj.log})")
        resumed, out["resume_s"] = timed(lambda: european_hedge(euro, sim, kcfg))
        walls_equal(resumed.backward, euro_host.backward, "[resume] resumed walk vs [euro]")
        check(resumed.report.v0_acv == euro_host.report.v0_acv, "[resume] v0_acv equal")
        del resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[resume] north star {N_FULL} paths (GN 30 + 51 x 10, host loop) with checkpoint_dir:"
          f" the checkpointed walk and the walk killed after step 25 (FaultPlan) then resumed "
          f"are bitwise [euro]'s (ledgers, per-date params, iterations); walls: checkpointed "
          f"{out['ckpt_s']:.3f} s vs {euro_s:.3f} s plain, killed run {out['killed_s']:.3f}"
          f" s, resume {out['resume_s']:.3f} s; {out['ckpt_bytes'] / 1e6:.1f} MB on disk for 52 "
          f"dates; directory removed", flush=True)

    events = {"nan": [], "degrade": []}
    nan_event, degrade = sentinel.record_nan_event, sentinel.record_degrade
    sentinel.record_nan_event = lambda t, trainer, where: events["nan"].append((t, trainer))
    sentinel.record_degrade = lambda t, to: events["degrade"].append((t, to))
    try:
        clean, out["guard_clean_s"] = timed(lambda: european_hedge(
            euro, sim, dataclasses.replace(gn_train, nan_guard=True)))
        walls_equal(clean.backward, euro_host.backward, "[guard] clean guarded walk vs [euro]")
        check(events == {"nan": [], "degrade": []}, f"the clean guarded walk is silent ({events})")
        del clean
        plan = guard.FaultPlan(seed=3, nan_dates=frozenset({1}), nan_frac=0.02)
        with guard.faults(plan) as inj:
            hit, out["guard_hit_s"] = timed(lambda: european_hedge(
                euro, sim, dataclasses.replace(gn_train, nan_guard=True)))
        check([site for site, _ in inj.log] == ["train/fit_target"], f"one poisoning ({inj.log})")
        check(events["degrade"] == [(50, "final_solve")],
              f"the ladder's final_solve rung ran at date 50 only ({events})")
        check(all(t == 50 for t, _ in events["nan"]), f"NaN events at date 50 only ({events})")
        bw, hb = hit.backward, euro_host.backward
        check(torch.equal(bw.values[:, 51], hb.values[:, 51]) and
              torch.equal(bw.phi[:, 51], hb.phi[:, 51]) and
              all(torch.equal(bw.params1_by_date[k][51], v[51])
                  for k, v in hb.params1_by_date.items()), "date 51 bitwise untouched")
        check(all(bool(torch.isfinite(getattr(bw, k)).all())
                  for k in ("values", "phi", "psi", "var_residuals")), "every ledger finite")
        v0_gap = hit.report.v0 / euro_host.report.v0 - 1
        bp = (hit.report.v0_acv - bs) / bs * 1e4
        check(abs(v0_gap) < 0.05, f"guarded V0 within 5% of the clean run ({v0_gap:+.4%})")
        check(abs(bp) < 1.0, f"guarded |v0_acv - BS| {bp:+.4f}bp < 1bp")
        del hit
        events["degrade"].clear()
        esim = SimConfig(n_paths=16_384, T=1.0, dt=1 / 364, rebalance_every=STORE)
        with guard.faults(plan):
            adam_hit = european_hedge(euro, esim, TrainConfig(**EXAMPLE_TRAIN, nan_guard=True))
        check(events["degrade"] == [(50, "gauss_newton")],
              f"the Adam walk's ladder lands on gauss_newton at date 50 ({events['degrade']})")
        check(bool(torch.isfinite(adam_hit.backward.values).all()), "Adam guarded walk finite")
    finally:
        sentinel.record_nan_event, sentinel.record_degrade = nan_event, degrade
    print(f"[guard] nan_guard on the north star at {N_FULL}: clean, bitwise [euro]'s and silent "
          f"({out['guard_clean_s']:.3f} s); FaultPlan(seed=3, nan_dates={{1}}, nan_frac=0.02): "
          f"the final_solve rung at date 50 only, date 51 bitwise, every ledger finite, V0 "
          f"{v0_gap:+.4%} vs the clean run, v0_acv bp_err {bp:+.4f} ({out['guard_hit_s']:.3f} "
          f"s); at 16384 paths with Adam the same plan lands on the gauss_newton rung",
          flush=True)
    return out


# BASELINE.json config 5: the 5-asset basket call at 1M paths, weekly for a year
BASKET_STEPS = 52
BASKET_GN = dict(dual_mode="mse_only", optimizer="gauss_newton", gn_block_rows=16_384,
                 fused=True)
BASKET_LEVY_BOUND = 40e-4  # tests/test_basket.py::test_mm_oracle_vs_qmc_price
N_BASKET_HOST = 16_384


def basket_price_checks(res, r: float, what: str) -> str:
    """``v0_cv`` and ``v0_acv`` within 3 standard errors of the plain price (the
    plain estimator's iid SE), ``v0_acv`` within the Levy bound of
    ``oracle_mm``, the report finite."""
    import torch

    rep = res.report
    check(all(math.isfinite(x) for x in report_fields(rep)), f"{what}: report fields finite")
    n = res.backward.values.shape[0]
    # values[:, -1] is the payoff over the strike (adjustment_factor)
    plain_std = float(torch.std(res.backward.values[:, -1].double(), correction=0))  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    se = math.exp(-r * float(res.times[-1])) * plain_std * res.adjustment_factor / math.sqrt(n)
    for name in ("v0_cv", "v0_acv"):
        gap = getattr(rep, name) - rep.v0_plain
        check(abs(gap) < 3.0 * se, f"{what}: |{name} - v0_plain| = {abs(gap):.5f} < 3 SE = "
              f"{3.0 * se:.5f}")
    levy = rep.v0_acv / rep.oracle_mm - 1
    check(abs(levy) < BASKET_LEVY_BOUND, f"{what}: |v0_acv / oracle_mm - 1| = {abs(levy):.2e} "
          f"< {BASKET_LEVY_BOUND:.0e}")
    return (f"v0_plain {rep.v0_plain:.6f}, v0_cv {rep.v0_cv:.6f}, v0_acv {rep.v0_acv:.6f} "
            f"(3 SE {3.0 * se:.5f}; vs oracle_mm {rep.oracle_mm:.6f}: {levy * 1e4:+.2f}bp, "
            f"bound {BASKET_LEVY_BOUND * 1e4:.0f}bp), cv_std {rep.cv_std:.4f}, acv_std "
            f"{rep.acv_std:.4f}, v0_network {rep.v0:.4f}")


def basket_phases(dev, counts) -> dict:
    """[basket]: BASELINE.json config 5 (``BasketConfig()``, 5 assets, rho 0.3) at
    1,048,576 paths x 52 weekly steps on the scan path: ``basket_hedge`` with the
    basket and the vector hedge (the fused GN walk, row blocks of 16,384) and the
    vector hedge once more with [adam]'s Adam; the fused vector walk against the
    host loop at 16,384 paths, bitwise; ``basket_oos`` of each policy on fresh
    paths; each policy served as one 1M-row mixed-date block through K2's
    ``Runtime<8>`` instance, the vector head at every tier; K2's times at both
    heads."""
    import dataclasses

    import numpy as np
    import torch

    from orp_tpu_torch.api import (BasketConfig, SimConfig, TrainConfig, basket_hedge,
                                   basket_oos)
    from orp_tpu_torch.serve import HedgeEngine, load_bundle, megakernel, save_bundle
    from orp_tpu_torch.serve.bundle import model_meta
    from orp_tpu_torch.serve.precision import bf16_agreement
    from orp_tpu_torch.train import backward
    from orp_tpu_torch.train.backward import fused_loop_scope
    from orp_tpu_torch.utils.measure import no_host_sync

    out = {"policies": {}}
    cfg = BasketConfig()
    sim = SimConfig(n_paths=N_FULL, T=1.0, dt=1 / BASKET_STEPS, rebalance_every=1)
    runs = {"basket": ("basket", TrainConfig(**BASKET_GN)),
            "assets": ("assets", TrainConfig(**BASKET_GN)),
            "assets-adam": ("assets", TrainConfig(**ADAM_TRAIN))}
    backward.fused_loop_scope = no_host_sync  # the fused date loops under sync-debug "error"
    try:
        for name, (instruments, train) in runs.items():
            counts.reset()
            res, wall = timed(lambda: basket_hedge(cfg, sim, train, instruments=instruments))
            check(all(v == 0 for v in counts.read().values()),
                  f"[basket] {name}: no kernel launches on the scan path ({counts.read()})")
            bw = res.backward
            phi_shape = (N_FULL, BASKET_STEPS) + ((5,) if instruments == "assets" else ())
            check(tuple(bw.phi.shape) == phi_shape and bool(torch.isfinite(bw.values).all()),
                  f"[basket] {name}: phi {tuple(bw.phi.shape)}, ledgers finite")
            line = basket_price_checks(res, cfg.r, f"[basket] {name}")
            out[name] = {"wall": wall, "cv_std": res.report.cv_std,
                         "iters": int(bw.epochs_ran.sum())}
            print(f"[basket] basket_hedge {name} ({instruments}, "
                  f"{'Adam 120 + 51 x 30' if 'adam' in name else 'GN 30 + 51 x 10 fused'}) "
                  f"{N_FULL} paths x {BASKET_STEPS} steps: {line}; "
                  f"{'epochs' if 'adam' in name else 'accepted iterations'} {out[name]['iters']}; "
                  f"wall {wall:.3f} s; kernel launches 0", flush=True)
            # -- out of sample, on fresh paths ------------------------------------
            counts.reset()
            oos, oos_wall = timed(lambda: basket_oos(
                res, cfg, dataclasses.replace(sim, seed_fund=OOS_SEED), train,
                instruments=instruments))
            check(all(v == 0 for v in counts.read().values()),
                  f"[basket] {name} oos: no kernel launches ({counts.read()})")
            print(f"[basket] basket_oos {name} {N_FULL} fresh paths (seed {OOS_SEED}): "
                  f"{basket_price_checks(oos, cfg.r, f'[basket] {name} oos')}; wall "
                  f"{oos_wall:.3f} s",
                  flush=True)
            out[name]["oos_wall"] = oos_wall
            # -- serve: save_bundle -> load_bundle -> one 1M-row block through K2 ---
            p1 = {k: v.detach().cpu().numpy() for k, v in bw.params1_by_date.items()}
            meta = {"model": model_meta(res.model), "times": res.times.tolist(),
                    "adjustment_factor": res.adjustment_factor, "dual_mode": res.dual_mode,
                    "holdings_combine": res.holdings_combine,
                    "cost_of_capital": res.cost_of_capital, "sim_seed": res.sim_seed}
            bdir = HERE / "build" / "chip_smoke" / f"basket_{name}"
            save_bundle(bdir, meta, p1, None, {k: getattr(bw, k) for k in (
                "train_loss", "train_mae", "train_mape", "epochs_ran")})
            policy = load_bundle(bdir)
            rows = basket_rows(cfg, policy, res.times, 23)
            engine = HedgeEngine(policy)
            engine.evaluate_mixed_async(*(r[:4096] for r in rows)).result()
            torch.cuda.synchronize()
            counts.reset()
            got, serve_s = timed(lambda: engine.evaluate_mixed_async(*rows).result())
            k2 = counts.only("mixed_head", f"[basket] the {name} policy's 1M-row block")
            check(k2 == 1, f"[basket] {name}: K2 launches {k2} == 1, one per param set")
            params = {k: t.to(dev) for k, t in policy.backward.params1_by_date.items()}
            plain = megakernel.mixed_head_plain(
                policy.model, params, torch.from_numpy(rows[0]).to(dev),
                torch.from_numpy(rows[1]).to(dev)).cpu().numpy()
            phi, psi, v = got
            np.testing.assert_allclose(phi, plain[:, :-1] if phi.ndim == 2 else plain[:, 0],
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} phi")
            np.testing.assert_allclose(psi, plain[:, -1], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} psi")
            np.testing.assert_allclose(v, (plain.astype(np.float64) * rows[2]).sum(1),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} v")
            # the kernel itself against its plain version on the block's rows, f32 and bf16
            d_t = torch.from_numpy(rows[0]).to(dev)
            f_t = torch.from_numpy(rows[1]).to(dev)
            got_k = megakernel.mixed_head_forward(policy.model, params, d_t, f_t)
            want_k = megakernel.mixed_head_plain(policy.model, params, d_t, f_t)
            torch.testing.assert_close(got_k, want_k, rtol=1e-5, atol=1e-6)
            bf = policy.model.with_dtype(torch.bfloat16)
            pb = {k: t.to(torch.bfloat16) for k, t in params.items()}
            got_b = megakernel.mixed_head_forward(bf, pb, d_t, f_t.to(torch.bfloat16))
            check(torch.equal(got_b, megakernel.mixed_head_bf16_order(
                bf, pb, d_t, f_t.to(torch.bfloat16))),
                  f"[basket] {name}: K2 bf16 bitwise its documented summation order")
            # the plain version on the card (cuBLAS's bf16 GEMM) and on the CPU (its bf16
            # matmul sums the exact products in f32 and rounds once), printed: they sum a
            # dot's products in orders of their own, and a vector head's holdings are
            # small differences of terms as large as its bond holding
            card_b = bf16_agreement(got_b, megakernel.mixed_head_plain(
                bf, pb, d_t, f_t.to(torch.bfloat16)))
            got_b = got_b.cpu()
            want_b = megakernel.mixed_head_plain(
                bf, {k: t.cpu() for k, t in pb.items()}, d_t.cpu(),
                f_t.to(torch.bfloat16).cpu())
            agree = bf16_agreement(got_b, want_b)
            out["policies"][name] = (policy, rows)
            out[name].update(serve_s=serve_s, k2=k2, k2_err=max_err(got_k, want_k),
                             k2b_err=max_err(got_b, want_b))
            print(f"[basket] serve {name}: card-trained policy -> save_bundle -> load_bundle "
                  f"-> HedgeEngine, one {N_FULL}-row block over {policy.n_dates} dates "
                  f"({policy.model.n_features} features, {policy.model.n_outputs} outputs, "
                  f"{policy.model.n_params()} params, K2 Runtime<8>): matches "
                  f"mixed_head_plain (rtol 1e-5, atol 1e-6); K2 launches {k2}; "
                  f"{N_FULL / serve_s:,.0f} rows/s host-to-host; the kernel alone: f32 "
                  f"max|d| {out[name]['k2_err']:.3e} vs plain; bf16 bitwise its documented "
                  f"order (input-order f32 sums) on {got_b.numel():,} elements, vs the CPU "
                  f"plain version {agree['n_differ']} differ (max {agree['max_ulps']:.2f} bf16 "
                  f"spacings), vs the card's (cuBLAS) {card_b['n_differ']} differ (max "
                  f"{card_b['max_ulps']:.2f})", flush=True)
            del got_k, want_k, got_b, want_b
            del res, oos
        check(out["assets"]["cv_std"] < out["basket"]["cv_std"],
              f"[basket] the vector hedge's cv_std {out['assets']['cv_std']:.4f} below the "
              f"basket hedge's {out['basket']['cv_std']:.4f}")
        ratio = out["basket"]["cv_std"] / out["assets"]["cv_std"]
        print(f"[basket] cv_std: vector hedge {out['assets']['cv_std']:.4f} vs basket hedge "
              f"{out['basket']['cv_std']:.4f} ({ratio:.3f}x; PARITY.md: 1.21x)", flush=True)
        # -- the fused vector walk against the host loop, bitwise ---------------------
        small = dataclasses.replace(sim, n_paths=N_BASKET_HOST)
        fused, out["fused_small_s"] = timed(lambda: basket_hedge(
            cfg, small, TrainConfig(**BASKET_GN), instruments="assets"))
        host, out["host_small_s"] = timed(lambda: basket_hedge(
            cfg, small, TrainConfig(**dict(BASKET_GN, fused=False)), instruments="assets"))
        walls_equal(fused.backward, host.backward, "[basket] fused vector walk vs host loop")
        check(fused.report.v0_acv == host.report.v0_acv, "[basket] fused v0_acv equal")
        print(f"[basket] the fused GN vector walk at {N_BASKET_HOST} paths is bitwise its host "
              f"loop (ledgers, per-date params, iterations): fused {out['fused_small_s']:.3f} s,"
              f" host loop {out['host_small_s']:.3f} s", flush=True)
    finally:
        backward.fused_loop_scope = fused_loop_scope
    # -- the vector head at every tier; K2 times at both heads ------------------------
    policy, rows = out["policies"]["assets"]
    out["tiers"] = tier_phase(dev, counts, policy, *rows, "basket-assets")
    out["k2"] = {name: k2_times(dev, out["policies"][name][0], N_FULL, 29)
                 for name in ("basket", "assets")}
    for name, t in out["k2"].items():
        print(f"[basket] K2 Runtime<8> at the {name} head ({N_FULL} rows, 52 dates): f32 "
              f"{t['f32']:.4f} ms (bound {t['f32_bound'][0]:.5f} by {t['f32_bound'][1]}, plain "
              f"{t['f32_plain']:.2f} ms), bf16 {t['bf16']:.4f} ms (bound "
              f"{t['bf16_bound'][0]:.5f} by {t['bf16_bound'][1]}, plain {t['bf16_plain']:.2f} "
              f"ms); at 4096 rows f32 {t['f32_small']:.4f} ms, bf16 {t['bf16_small']:.4f} ms",
              flush=True)
    return out


def basket_rows(cfg, policy, times, seed: int):
    """``(dates, states, prices)`` of one 1M-row mixed-date block of a basket
    policy: dates cover all 52, the moneyness features lognormal at each
    row's date, the prices the policy's instruments over the strike (the
    assets or the basket, then the bond)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dates = policy.n_dates
    dates = np.concatenate([np.arange(n_dates), rng.integers(0, n_dates, N_FULL - n_dates)])
    t = np.asarray(times)[dates][:, None]
    sig = np.asarray(cfg.sigmas)[None, :]
    states = np.exp(sig * np.sqrt(t) * rng.standard_normal((N_FULL, len(cfg.s0)))
                    + (cfg.r - 0.5 * sig * sig) * t)
    assets = states * np.asarray(cfg.s0) / cfg.strike
    risky = assets if policy.model.n_outputs > 2 else (assets @ np.asarray(cfg.weights))[:, None]
    prices = np.concatenate([risky, np.exp(cfg.r * t) / cfg.strike], 1)
    return dates.astype(np.int32), states.astype(np.float32), prices.astype(np.float32)


def greeks_phases(dev) -> dict:
    """[greeks] at 1,048,576 paths, each against its oracle in the bands of
    ``tests/test_greeks.py``: the European call and put (52 steps) against
    ``bs_greeks``; the digital's likelihood-ratio greeks against their closed
    forms; Heston (364 steps, the mean of 8 scrambles) against central
    differences of the characteristic-function price; the basket at ``BasketConfig()`` against a
    CRN central-difference reprice on the card."""
    import numpy as np

    from orp_tpu_torch.api import BasketConfig
    from orp_tpu_torch.risk import (basket_greeks, digital_greeks, european_greeks,
                                    heston_greeks)
    from orp_tpu_torch.utils import bs_greeks

    out = {}
    euro = dict(s0=100.0, k=100.0, r=0.08, sigma=0.15, T=1.0)
    bands = {"call": dict(price=("rtol", 1e-3), delta=("atol", 2e-3), vega=("rtol", 5e-3),
                          rho=("rtol", 5e-3), theta=("rtol", 1e-2), gamma=("rtol", 5e-2)),
             "put": dict(price=("rtol", 5e-3), delta=("atol", 2e-3), theta=("atol", 5e-3),
                         rho=("rtol", 5e-3))}

    def within(got, want, how, lim, what):
        gap = abs(got - want) if how == "atol" else abs(got / want - 1)
        check(gap <= lim, f"[greeks] {what}: {got:.6g} vs {want:.6g} ({how} {gap:.2e} <= {lim})")
        return f"{what} {got:.6g} vs {want:.6g} ({how} {gap:.2e} <= {lim:.2g})"

    for kind, band in bands.items():
        g, wall = timed(lambda: european_greeks(N_FULL, **euro, kind=kind, n_steps=52,
                                                seed=77))
        want = bs_greeks(**euro, kind=kind)
        parts = [within(getattr(g, k), want[k], how, lim, f"{kind} {k}")
                 for k, (how, lim) in band.items()]
        out[f"euro_{kind}_s"] = wall
        print(f"[greeks] european_greeks {kind} {N_FULL} paths x 52 steps vs bs_greeks: "
              f"{'; '.join(parts)}; wall {wall:.3f} s", flush=True)
    sq = euro["sigma"] * math.sqrt(euro["T"])
    d1 = (math.log(euro["s0"] / euro["k"]) + (euro["r"] + euro["sigma"] ** 2 / 2) * euro["T"]) / sq
    d2 = d1 - sq
    disc = math.exp(-euro["r"] * euro["T"])
    phi2 = math.exp(-0.5 * d2 * d2) / math.sqrt(2 * math.pi)
    closed = {"price": disc * 0.5 * (1 + math.erf(d2 / math.sqrt(2))),
              "delta": disc * phi2 / (euro["s0"] * sq), "vega": -disc * phi2 * d1 / euro["sigma"]}
    dg, wall = timed(lambda: digital_greeks(N_FULL, **euro, seed=7))
    for k, want in closed.items():
        check(abs(dg[k] - want) < 4 * dg["se"][k], f"[greeks] digital {k} {dg[k]:.6g} within 4 "
              f"SE ({4 * dg['se'][k]:.2e}) of {want:.6g}")
    dp = digital_greeks(N_FULL, **euro, kind="put", seed=7)
    total = dg["price"] + dp["price"]
    check(total <= disc + 1e-6 and disc - total < 16 * disc / N_FULL,
          f"[greeks] digital call + put {total:.7f} vs e^-rT {disc:.7f}")
    out["digital_s"] = wall
    print(f"[greeks] digital_greeks {N_FULL} paths (likelihood ratio) vs closed forms: "
          + "; ".join(f"{k} {dg[k]:.6g} vs {v:.6g} (4 SE {4 * dg['se'][k]:.2e})"
                      for k, v in closed.items()) + f"; wall {wall:.3f} s", flush=True)
    # the Heston greeks as the mean of HESTON_GREEKS_SEEDS' independently scrambled runs
    # (iid replicates), each greek within its band or 3 of the replicates' standard
    # errors, the larger: vega_xi's band (5% of 0.198) is below one run's own spread at
    # 1M paths (float64 at seeds 77, 78, 1234: -0.1743, -0.2149, -0.1934, sd 0.020;
    # tools/torch_heston_greeks.py), so it holds only for the pooled mean
    runs, walls = [], []
    for seed in HESTON_GREEKS_SEEDS:
        g, wall = timed(lambda: heston_greeks(N_FULL, 100.0, 100.0, 0.08, 1.0, **HESTON_GREEKS,
                                              seed=seed))
        runs.append(g)
        walls.append(wall)
    check(all(g["n_steps"] == 364 for g in runs), "[greeks] heston_greeks at its 364 steps")
    parts = []
    for k, (want, how, lim) in heston_greeks_oracle().items():
        xs = np.array([g[k] for g in runs])
        three_se = 3.0 * float(xs.std(ddof=1)) / math.sqrt(len(xs))
        lim = max(lim, three_se if how == "atol" else three_se / abs(want))
        parts.append(within(float(xs.mean()), want, how, lim, k)
                     + f" (3 SE {three_se:.2e}; seed {HESTON_GREEKS_SEEDS[0]} alone {xs[0]:.6g})")
    out["heston_s"] = walls[0]
    print(f"[greeks] heston_greeks {N_FULL} paths x 364 steps (Euler), the mean of "
          f"{len(runs)} scrambles (seeds {HESTON_GREEKS_SEEDS[0]}-{HESTON_GREEKS_SEEDS[-1]}) vs "
          f"the CF oracle's central differences: {'; '.join(parts)}; wall {walls[0]:.3f} s a "
          f"run ({sum(walls):.3f} s in all)", flush=True)
    cfg = BasketConfig()
    bkw = dict(weights=cfg.weights, strike=cfg.strike, r=cfg.r, corr=cfg.corr(), T=1.0,
               n_steps=52, seed=11)
    bg, wall = timed(lambda: basket_greeks(N_FULL, s0=cfg.s0, sigma=cfg.sigmas, **bkw))
    out["basket_s"] = wall

    def price(s0=cfg.s0, sigma=cfg.sigmas):
        return basket_greeks(N_FULL, s0=s0, sigma=sigma, **bkw)["price"]

    parts = []
    t0 = time.perf_counter()
    for i in (0, 4):
        h = 0.5
        up, dn = list(cfg.s0), list(cfg.s0)
        up[i] += h
        dn[i] -= h
        fd = (price(s0=up) - price(s0=dn)) / (2 * h)
        parts.append(within(float(bg["delta"][i]), fd, "atol", 2e-3, f"delta[{i}]"))
    h = 0.005
    up, dn = list(cfg.sigmas), list(cfg.sigmas)
    up[1] += h
    dn[1] -= h
    fd = (price(sigma=up) - price(sigma=dn)) / (2 * h)
    parts.append(within(float(bg["vega"][1]), fd, "rtol", 2e-2, "vega[1]"))
    check(abs(bg["price"] / price() - 1) < 1e-6, "[greeks] basket price is its reprice")
    out["basket_fd_s"] = time.perf_counter() - t0
    print(f"[greeks] basket_greeks BasketConfig() {N_FULL} paths x 52 steps vs CRN central "
          f"differences on the card: {'; '.join(parts)}; price {bg['price']:.6f}, delta "
          f"{np.round(bg['delta'].cpu().numpy(), 5).tolist()}, vega "
          f"{np.round(bg['vega'].cpu().numpy(), 4).tolist()}, rho {bg['rho_rate']:.4f}; wall "
          f"{wall:.3f} s (the 7 reprices {out['basket_fd_s']:.3f} s)", flush=True)
    return out


def lsm_exercise(feats, pay, disc, degree: int):
    """``train/lsm._lsm_walk``'s walk, step for step, with each path's exercise
    date (``m``: never) and every date's decisions: ``(realized cashflows at
    t_1, dates (n,), decisions (n, m - 1))``."""
    import torch

    from orp_tpu_torch.train import lsm

    exps = lsm._monomial_exponents(feats.shape[-1], degree)
    m = pay.shape[1]
    v = pay[:, -1]
    tau = torch.where(v > 0.0, m - 1, m)
    decisions = torch.zeros((pay.shape[0], m - 1), dtype=torch.bool, device=pay.device)
    for j in range(m - 2, -1, -1):
        vd = disc * v
        _, cont = lsm._regress_date(vd, feats[:, j], pay[:, j], exps)
        decisions[:, j] = (pay[:, j] > 0.0) & (pay[:, j] > cont)
        v = torch.where(decisions[:, j], pay[:, j], vd)
        tau = torch.where(decisions[:, j], j, tau)
    return v, tau, decisions


def lsm_cross(dev, heston: bool) -> dict:
    """The 4,096-path LSM walk on the card and on the CPU from the same Sobol
    indices: each device's walk equal to its ``bermudan_lsm(_heston)`` price,
    the share of paths whose exercise date differs, where the walks'
    decisions first part (walking back from maturity) and on how many paths,
    and the price gap in the CPU run's standard errors."""
    import torch

    from orp_tpu_torch.sde import TimeGrid, heston_sim_fn, simulate_gbm_log
    from orp_tpu_torch.train import bermudan_lsm, bermudan_lsm_heston

    m, spe, degree = (25, 4, 3) if heston else (50, 4, 3)
    disc_f = math.exp(-LSM_LS["r"] * (LSM_LS["T"] / m))
    runs = []
    for d in (dev, torch.device("cpu")):
        idx = torch.arange(N_CROSS, device=d)
        grid = TimeGrid(LSM_LS["T"], m * spe)
        if heston:
            traj = heston_sim_fn("qe")(idx, grid, s0=36.0, mu=LSM_LS["r"], **LSM_HESTON, seed=9,
                                       store_every=spe)
            s = traj["S"][:, 1:]
            feats = torch.stack([s, traj["v"][:, 1:]], dim=-1)
            res = bermudan_lsm_heston(N_CROSS, 36.0, LSM_LS["k"], LSM_LS["r"], LSM_LS["T"],
                                      **LSM_HESTON, n_exercise=m, steps_per_exercise=spe, seed=9,
                                      indices=idx)
        else:
            s = simulate_gbm_log(idx, grid, 36.0, LSM_LS["r"], LSM_LS["sigma"], seed=9,
                                 store_every=spe)[:, 1:]
            feats = s[:, :, None]
            res = bermudan_lsm(N_CROSS, 36.0, **LSM_LS, n_exercise=m, steps_per_exercise=spe,
                               seed=9, indices=idx)
        pay = torch.clamp(-1.0 * (s - LSM_LS["k"]), min=0.0)  # _lsm_price's put payoff
        disc = torch.tensor(disc_f, dtype=pay.dtype, device=d)
        v, tau, decisions = lsm_exercise(feats, pay, disc, degree)
        check(float(torch.mean(disc * v)) == res["price"],
              f"[exotics] the walk on {d.type} is bermudan_lsm{'_heston' if heston else ''}'s")
        runs.append((res, tau.cpu(), decisions.cpu()))
    card, cpu = runs
    share = float((card[1] != cpu[1]).double().mean())  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    parted = (card[2] != cpu[2]).sum(dim=0)  # paths whose decision differs, per date
    dates = parted.nonzero().flatten().tolist()
    first = max(dates) if dates else None  # the walk runs from the last date back
    gap = abs(card[0]["price"] - cpu[0]["price"])
    check(gap < 2 * cpu[0]["se"], f"[exotics] LSM{' Heston' if heston else ''} card vs CPU at "
          f"{N_CROSS}: {card[0]['price']:.6f} vs {cpu[0]['price']:.6f} within 2 SE")
    return {"share": share, "gap_se": gap / cpu[0]["se"], "card": card[0]["price"],
            "cpu": cpu[0]["price"], "first": first,
            "first_paths": int(parted[first]) if dates else 0,
            "decisions": int(parted.sum()), "dates": len(dates), "of": m - 1}


def exotics_cross(dev) -> dict:
    """Each option-analytics pricer on the card and on the CPU at 4,096 paths,
    the same indices: the pricers' floats within 1e-4 relative, the surfaces'
    prices within 1e-4 of their largest node with the IVs within 3e-4 and the
    NaN masks equal, the LSM walks within 2 standard errors."""
    import numpy as np
    import torch

    from orp_tpu_torch.risk import (asian_call_qmc, down_and_out_call_qmc,
                                    heston_price_surface, lookback_call_qmc,
                                    lookback_floating_qmc, price_surface)

    fk = (EXOTIC_LOOKBACK["s0"], EXOTIC_LOOKBACK["r"], EXOTIC_LOOKBACK["sigma"],
          EXOTIC_LOOKBACK["T"])
    cross = {"asian": (asian_call_qmc, tuple(EXOTIC_ASIAN.values()), {}),
             "barrier": (down_and_out_call_qmc, tuple(EXOTIC_BARRIER.values()),
                         dict(n_monitor=13, seed=5)),
             "barrier naive": (down_and_out_call_qmc, tuple(EXOTIC_BARRIER.values()),
                               dict(n_monitor=13, bridge=False, seed=5)),
             "lookback": (lookback_call_qmc, tuple(EXOTIC_LOOKBACK.values()),
                          dict(n_monitor=13, seed=5)),
             "floating": (lookback_floating_qmc, fk, dict(n_monitor=13, seed=5))}
    gaps, worst = {}, {}
    for name, (fn, args, kw) in cross.items():
        got = fn(N_CROSS, *args, **kw, indices=torch.arange(N_CROSS, device=dev))
        want = fn(N_CROSS, *args, **kw, device="cpu")
        rel = {k: abs(got[k] / w - 1) for k, w in want.items()
               if isinstance(w, float) and w != 0.0}
        worst[name] = max(rel, key=rel.get)
        gaps[name] = rel[worst[name]]
        check(gaps[name] < 1e-4, f"[exotics] {name} card vs CPU at {N_CROSS}: {gaps[name]:.2e} "
              f"({worst[name]})")
    for name, fn, args, kw in (
            ("surface", price_surface, (100.0, 0.08, 0.15, SURFACE_STRIKES, 1.0), {}),
            ("heston surface", heston_price_surface, (100.0, 0.08, SURFACE_HESTON_STRIKES, 1.0),
             dict(SURFACE_HESTON, seed=7))):
        kw = dict(kw, n_maturities=13, steps_per_maturity=4)
        got = fn(N_CROSS, *args, **kw, indices=torch.arange(N_CROSS, device=dev))
        want = fn(N_CROSS, *args, **kw, device="cpu")
        gp, wp = got["prices"].cpu().numpy(), want["prices"].numpy()
        gi, wi = got["iv"].cpu().numpy(), want["iv"].numpy()
        gaps[name] = float(np.abs(gp - wp).max() / np.abs(wp).max())
        iv_gap = float(np.nanmax(np.abs(gi - wi)))
        check(gaps[name] < 1e-4 and (np.isnan(gi) == np.isnan(wi)).all() and iv_gap < 3e-4,
              f"[exotics] {name} card vs CPU at {N_CROSS}: prices {gaps[name]:.2e} of the "
              f"largest, IV {iv_gap:.2e}, NaN masks equal")
    lsm_x, lsm_hx = lsm_cross(dev, heston=False), lsm_cross(dev, heston=True)
    print(f"[exotics] card vs CPU at {N_CROSS} paths, same indices: "
          + ", ".join(f"{k} {v:.2e}" + (f" ({worst[k]})" if k in worst else "")
                      for k, v in gaps.items())
          + " (relative, the field furthest apart; surfaces of the largest node); "
          + "; ".join(f"{what}: exercise dates differ on {x['share']:.4%} of paths, "
                      + (f"decisions first part at date {x['first']} of 0..{x['of'] - 1} on "
                         f"{x['first_paths']} paths, {x['decisions']} decisions on {x['dates']} "
                         "dates in all" if x["first"] is not None else "every decision equal")
                      + f", price {x['card']:.6f} vs {x['cpu']:.6f} ({x['gap_se']:.3f} SE)"
                      for what, x in (("LSM", lsm_x), ("Heston LSM", lsm_hx))), flush=True)
    return {"gaps": gaps, "lsm": lsm_x, "lsm_heston": lsm_hx}


def exotics_phases(dev, counts, bench_s: float) -> dict:
    """[exotics] at 1,048,576 paths: ``examples/option_analytics.py``'s steps
    2-5 (the Asian with its geometric control, the bridge barrier and
    lookbacks, the flat and Heston surfaces, the Bermudan LSM against its CRR
    tree), each in its JAX test's form; each QMC pricer on the card against the
    CPU at 4,096 paths; the CIR calibration on the example's series; the FLOP
    accounting of [fused]'s benchmark wall. No kernel launches in the phase."""
    import numpy as np

    from orp_tpu_torch import calib
    from orp_tpu_torch.risk import (asian_call_qmc, down_and_out_call, down_and_out_call_qmc,
                                    heston_price_surface, lookback_call_fixed,
                                    lookback_call_floating, lookback_call_qmc,
                                    lookback_floating_qmc, price_surface)
    from orp_tpu_torch.train import bermudan_lsm, bermudan_lsm_heston
    from orp_tpu_torch.utils import bs_call, crr_price, flops, heston_call, heston_put

    out = {}
    counts.reset()
    out["cross"] = exotics_cross(dev)  # first: it also warms each pricer's ops on the card
    # the Asian: tests/test_asian.py's four checks
    a, out["asian_s"] = timed(lambda: asian_call_qmc(N_FULL, *EXOTIC_ASIAN.values()))
    euro = bs_call(**EXOTIC_ASIAN)[0]
    check(abs(a["geo_sample"] - a["geo_closed"]) < 4 * a["se_plain"],
          f"[exotics] Asian geometric leg {a['geo_sample']:.6f} within 4 se_plain of "
          f"{a['geo_closed']:.6f}")
    check(a["se"] * 10 < a["se_plain"], f"[exotics] Asian control cuts se: {a['se']:.2e} x 10 "
          f"< {a['se_plain']:.2e}")
    check(abs(a["price"] - a["plain"]) < 4 * a["se_plain"],
          f"[exotics] Asian controlled {a['price']:.6f} within 4 se_plain of {a['plain']:.6f}")
    check(a["price"] < euro, f"[exotics] Asian {a['price']:.6f} below bs_call {euro:.6f}")
    print(f"[exotics] asian_call_qmc {N_FULL} paths x 52 dates x 7 steps: controlled "
          f"{a['price']:.6f} +- {a['se']:.2e}, plain {a['plain']:.6f} +- {a['se_plain']:.2e} "
          f"({a['se_plain'] / a['se']:.1f}x), geometric sample {a['geo_sample']:.6f} vs closed "
          f"{a['geo_closed']:.6f} ({(a['geo_sample'] - a['geo_closed']) / a['se_plain']:+.2f} "
          f"se_plain); bs_call {euro:.6f}; wall {out['asian_s']:.3f} s", flush=True)
    # the barrier: tests/test_barrier.py, 13 monitoring dates
    bar = tuple(EXOTIC_BARRIER.values())
    oracle = down_and_out_call(*bar)
    b, out["barrier_s"] = timed(lambda: down_and_out_call_qmc(N_FULL, *bar, n_monitor=13, seed=5))
    n13 = down_and_out_call_qmc(N_FULL, *bar, n_monitor=13, bridge=False, seed=5)
    n250, out["barrier_250_s"] = timed(lambda: down_and_out_call_qmc(
        N_FULL, *bar, n_monitor=250, bridge=False, seed=5))
    check(abs(b["price"] - oracle) < 3 * b["se"],
          f"[exotics] barrier bridge {b['price']:.6f} within 3 SE of {oracle:.6f}")
    check(0.0 < b["knockout_frac"] < 1.0, "[exotics] barrier knockout share in (0, 1)")
    check(n13["price"] - oracle > 10 * n13["se"],
          f"[exotics] naive barrier {n13['price']:.6f} over {oracle:.6f} by > 10 SE")
    check(n13["price"] > n250["price"] > oracle,
          f"[exotics] naive 13 {n13['price']:.6f} > naive 250 {n250['price']:.6f} > oracle")
    print(f"[exotics] down_and_out_call_qmc {N_FULL} paths, 13 dates: bridge {b['price']:.6f} "
          f"+- {b['se']:.2e} vs reflection {oracle:.6f} ({(b['price'] - oracle) / b['se']:+.2f} "
          f"SE), knocked out {b['knockout_frac']:.4f}; naive {n13['price']:.6f} "
          f"({(n13['price'] - oracle) / n13['se']:+.1f} SE), at 250 dates {n250['price']:.6f}; "
          f"walls {out['barrier_s']:.3f} s, 250 dates {out['barrier_250_s']:.3f} s", flush=True)
    # the lookbacks: tests/test_lookback.py, 13 monitoring dates
    lk = tuple(EXOTIC_LOOKBACK.values())
    lo = lookback_call_fixed(*lk)
    lb, out["lookback_s"] = timed(lambda: lookback_call_qmc(N_FULL, *lk, n_monitor=13, seed=5))
    ln = lookback_call_qmc(N_FULL, *lk, n_monitor=13, bridge=False, seed=5)
    check(abs(lb["price"] - lo) < 3 * lb["se"],
          f"[exotics] lookback bridge {lb['price']:.6f} within 3 SE of {lo:.6f}")
    check(lo - ln["price"] > 10 * ln["se"],
          f"[exotics] naive lookback {ln['price']:.6f} under {lo:.6f} by > 10 SE")
    fk = (EXOTIC_LOOKBACK["s0"], EXOTIC_LOOKBACK["r"], EXOTIC_LOOKBACK["sigma"],
          EXOTIC_LOOKBACK["T"])
    fo = lookback_call_floating(*fk)
    fl, out["floating_s"] = timed(lambda: lookback_floating_qmc(N_FULL, *fk, n_monitor=13,
                                                                seed=5))
    fn = lookback_floating_qmc(N_FULL, *fk, n_monitor=13, bridge=False, seed=5)
    check(abs(fl["price"] - fo) < 3 * fl["se"],
          f"[exotics] floating lookback {fl['price']:.6f} within 3 SE of {fo:.6f}")
    check(fo - fn["price"] > 10 * fn["se"],
          f"[exotics] naive floating {fn['price']:.6f} under {fo:.6f} by > 10 SE")
    print(f"[exotics] lookback_call_qmc K=110 {N_FULL} paths, 13 dates: bridge "
          f"{lb['price']:.6f} +- {lb['se']:.2e} vs Conze-Viswanathan {lo:.6f} "
          f"({(lb['price'] - lo) / lb['se']:+.2f} SE), naive {ln['price']:.6f} "
          f"({(ln['price'] - lo) / ln['se']:+.1f} SE); floating {fl['price']:.6f} +- "
          f"{fl['se']:.2e} vs Goldman-Sosin-Gatto {fo:.6f} ({(fl['price'] - fo) / fl['se']:+.2f} "
          f"SE), naive {fn['price']:.6f}; walls {out['lookback_s']:.3f} / "
          f"{out['floating_s']:.3f} s", flush=True)
    # the surfaces: tests/test_surface.py's checks at the CLI's strikes
    surf, out["surface_s"] = timed(lambda: price_surface(
        N_FULL, 100.0, 0.08, 0.15, SURFACE_STRIKES, 1.0, n_maturities=13, steps_per_maturity=4))
    prices, times = surf["prices"].cpu().numpy(), surf["times"].cpu().numpy()
    iv = surf["iv"].cpu().numpy()
    bs = np.array([[bs_call(100.0, k, 0.08, 0.15, float(t))[0] for k in SURFACE_STRIKES]
                   for t in times])
    node_gap = float(np.abs(prices - bs).max())
    check(prices.shape == (13, len(SURFACE_STRIKES)) and node_gap < 0.035,
          f"[exotics] surface nodes within 0.035 of bs_call (max {node_gap:.4f})")
    check((np.diff(prices, axis=1) < 0).all() and (np.diff(prices, axis=0) > -1e-6).all(),
          "[exotics] surface prices fall in strike and rise in maturity")
    finite = np.isfinite(iv)
    iv_gap = float(np.abs(iv[finite] - 0.15).max())
    check(finite[3:, :].all() and finite[:, 1:-1].all() and iv_gap < 6e-3,
          f"[exotics] finite IVs within 6e-3 of 0.15 (max {iv_gap:.2e}, {int((~finite).sum())} "
          "NaN)")
    atm = SURFACE_STRIKES.index(100.0)
    check(abs(iv[-1, atm] - 0.15) < 1.5e-3, f"[exotics] ATM terminal IV {iv[-1, atm]:.6f}")
    hs, out["heston_surface_s"] = timed(lambda: heston_price_surface(
        N_FULL, 100.0, 0.08, SURFACE_HESTON_STRIKES, 1.0, **SURFACE_HESTON, n_maturities=13,
        steps_per_maturity=4, seed=7))
    hiv, hp = hs["iv"].cpu().numpy(), hs["prices"].cpu().numpy()
    check((np.diff(hiv[3:], axis=1) < 0).all(), "[exotics] Heston skew falls in strike")
    check(hiv[3, 0] - hiv[3, -1] > hiv[-1, 0] - hiv[-1, -1],
          "[exotics] Heston short-dated skew steeper than terminal")
    cf = [heston_call(100.0, k, 0.08, 1.0, **SURFACE_HESTON) for k in SURFACE_HESTON_STRIKES]
    cf_gap = float(np.abs(hp[-1] - np.array(cf)).max())
    check(cf_gap < 0.04, f"[exotics] Heston terminal nodes within 0.04 of heston_call "
          f"({cf_gap:.4f})")
    print(f"[exotics] price_surface {N_FULL} paths, 13 maturities x 4 steps, strikes "
          f"{SURFACE_STRIKES}: max |node - bs_call| {node_gap:.4f}, max |IV - 0.15| "
          f"{iv_gap:.2e} ({int((~finite).sum())} NaN nodes), ATM terminal IV "
          f"{iv[-1, atm]:.6f}; heston_price_surface (QE) max |terminal - heston_call| "
          f"{cf_gap:.4f}, skew {hiv[3, 0] - hiv[3, -1]:.4f} at T/4 vs {hiv[-1, 0] - hiv[-1, -1]:.4f}"
          f" at T; walls {out['surface_s']:.3f} / {out['heston_surface_s']:.3f} s", flush=True)
    # the Bermudan LSM: tests/test_lsm.py's CRR bracket (LS2001)
    berm = crr_price(36.0, **LSM_LS, exercise="bermudan", n_steps=5000, exercise_every=100)
    amer = crr_price(36.0, **LSM_LS, exercise="american", n_steps=5000)
    g, out["lsm_s"] = timed(lambda: bermudan_lsm(N_FULL, 36.0, **LSM_LS, n_exercise=50, seed=9))
    hz, out["lsm_xi0_s"] = timed(lambda: bermudan_lsm_heston(
        N_FULL, 36.0, LSM_LS["k"], LSM_LS["r"], LSM_LS["T"], **LSM_XI0, n_exercise=50, seed=9))
    for what, res in (("bermudan_lsm", g), ("bermudan_lsm_heston xi->0", hz)):
        check(berm - 0.05 < res["price"] < berm + 2 * res["se"],
              f"[exotics] {what} {res['price']:.6f} in (CRR {berm:.6f} - 0.05, + 2 SE "
              f"{2 * res['se']:.2e})")
    check(g["early_exercise_premium"] > 0.0, "[exotics] LSM premium positive")
    check(g["price"] < amer + 2 * g["se"], f"[exotics] LSM below the CRR American {amer:.6f}")
    hh, out["lsm_heston_s"] = timed(lambda: bermudan_lsm_heston(
        N_FULL, 36.0, LSM_LS["k"], LSM_LS["r"], LSM_LS["T"], **LSM_HESTON, n_exercise=25,
        steps_per_exercise=4, seed=9))
    hput = heston_put(36.0, LSM_LS["k"], LSM_LS["r"], LSM_LS["T"], **LSM_HESTON)
    check(abs(hh["european"] - hput) < 0.05,
          f"[exotics] Heston LSM European leg {hh['european']:.6f} within 0.05 of {hput:.6f}")
    check(hh["early_exercise_premium"] > 3 * hh["se"] and hh["price"] > hh["european"],
          "[exotics] Heston LSM premium above 3 SE")
    print(f"[exotics] bermudan_lsm {N_FULL} paths x 50 dates x 4 steps: {g['price']:.6f} +- "
          f"{g['se']:.2e} vs CRR Bermudan {berm:.6f} ({g['price'] - berm:+.6f}), American "
          f"{amer:.6f}, European {g['european']:.6f}, premium {g['early_exercise_premium']:.6f};"
          f" Heston xi->0 {hz['price']:.6f} +- {hz['se']:.2e} ({hz['price'] - berm:+.6f}); "
          f"Heston (25 x 4, QE) {hh['price']:.6f} +- {hh['se']:.2e}, European "
          f"{hh['european']:.6f} vs heston_put {hput:.6f}, premium "
          f"{hh['early_exercise_premium'] / hh['se']:.1f} SE; walls {out['lsm_s']:.3f} / "
          f"{out['lsm_xi0_s']:.3f} / {out['lsm_heston_s']:.3f} s", flush=True)
    # the CIR calibration (host NumPy) on examples/stochastic_vol_calibration.py's series
    rng = np.random.default_rng(7)
    closes = 100 * np.exp(np.cumsum(rng.normal(0.0003, 0.010, size=2520)))
    fit = calib.calibrate_prices(closes)
    params = calib.estimate_cir_params(calib.rolling_volatility(calib.log_returns(closes),
                                                                window=40))
    mu = calib.annualized_drift(closes, 10.0)
    check(params == fit.params and math.isfinite(mu), "[exotics] the example's calibration chain "
          "gives calibrate_prices' params")
    print(f"[exotics] calibrate_prices on the example's 2,520 closes: {params}, mu {mu:.6f}, "
          f"sigma0 {fit.sigma0:.6f}", flush=True)
    rep = flops.phase_report(flops.gn_walk_flops(N_FULL, 52, 150, 75), bench_s)
    print(f"[exotics] utils.flops.phase_report of [fused]'s benchmark GN configuration "
          f"({bench_s:.3f} s): {rep} ({card_line()})", flush=True)
    launched = counts.read()
    check(all(v == 0 for v in launched.values()), f"[exotics] no kernel launched ({launched})")
    out["flops"] = rep
    return out


# [host]: the served policies' training depth (their widths are the main paths'),
# the block sizes, and the validation set of the quality-gated reloads: 2,048 paths
# at 52 weekly steps (the 52 dates of the policy), 4 replicates
HOST_TRAIN_PATHS = 1 << 16
HOST_SIZES = (1, 7, 4096, 65_536, N_FULL)
HOST_MIXED_ROWS = 512


def _host_rows(n: int, n_features: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    states = (1.0 + 0.05 * rng.standard_normal((n, n_features))).astype(np.float32)
    prices = np.concatenate([states[:, :1], np.full((n, 1), 0.97, np.float32)], axis=1)
    return states, prices


def _hold(host, name: str):
    """The tenant's live batcher, activated; holding its condition keeps the
    worker from admitting, so requests submitted meanwhile ride one dispatch."""
    t, batcher = host._claim_batcher(name)
    host._release_claim(t)
    return batcher


def _median_ms(fn, n: int = 31) -> float:
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[n // 2]


def host_phases(dev, counts) -> dict:
    """[host]: the single-host serve path. The north-star and pension policies
    trained at HOST_TRAIN_PATHS paths and exported (``export_dir=``), served
    with the committed north-star policy as a third tenant on
    ``ServeHost(max_live_engines=2)`` with the mixed-date lane and block
    coalescing; client threads send ``orp-ingest-v2`` frames through
    ``submit_block`` and read the decoded replies."""
    import dataclasses
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.api import (EuropeanConfig, HedgeRunConfig, SimConfig, TrainConfig,
                                   european_hedge, pension_hedge)
    from orp_tpu_torch.guard import FaultPlan, GuardPolicy, faults
    from orp_tpu_torch.obs.quality import ValidationSpec
    from orp_tpu_torch.serve import (SERVED, SHED_DEADLINE, SHED_WATERMARK, CanaryRejected,
                                     HedgeEngine, MicroBatcher, ServeHost, load_bundle,
                                     megakernel, wire)
    from orp_tpu_torch.serve.bench import promotion_drill
    from orp_tpu_torch.utils import cuda_build
    from orp_tpu_torch.utils.measure import cuda_ms

    t_phase = time.perf_counter()
    out = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="orp-host-"))
    gn = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    t0 = time.perf_counter()
    european_hedge(EuropeanConfig(constrain_self_financing=False),
                   SimConfig(n_paths=HOST_TRAIN_PATHS, T=1.0, dt=1 / 364, rebalance_every=STORE,
                             engine="pallas"), gn, export_dir=root / "north-star")
    pension_hedge(HedgeRunConfig(
        sim=SimConfig(n_paths=HOST_TRAIN_PATHS, T=10.0, dt=0.01, rebalance_every=PENSION_STORE,
                      seed=1234, engine="pallas", binomial_mode="inversion"),
        train=TrainConfig(dual_mode="shared", holdings_combine="py", optimizer="gauss_newton",
                          gn_iters_first=60, gn_iters_warm=30)), export_dir=root / "pension")
    out["train_s"] = time.perf_counter() - t0
    sources = {"north-star": root / "north-star", "pension": root / "pension",
               "ns-ref": NORTH_STAR_POLICY}
    policies = {k: load_bundle(v) for k, v in sources.items()}
    ns, pen = policies["north-star"], policies["pension"]
    check(ns.model.n_params() == 106 and ns.n_dates == 52 and ns.validation is not None
          and ns.feature_sketch is not None and ns.fingerprint is not None,
          "the exported north star: 106 params, 52 dates, its baseline and fingerprint")
    check(pen.model.n_features == 3 and pen.n_dates == 40 and pen.dual_mode == "shared"
          and pen.feature_sketch is not None, "the exported pension: 3 features, 40 dates")
    direct = {k: HedgeEngine(v) for k, v in policies.items()}
    guard = GuardPolicy(deadline_ms=60_000.0, queue_watermark=N_FULL, max_retries=3,
                        backoff_ms=1.0)
    host = ServeHost(max_live_engines=2,
                     batcher_kwargs={"mixed_dates": True, "coalesce_blocks": True})
    host.add_tenant("north-star", sources["north-star"])
    host.add_tenant("pension", sources["pension"])
    host.add_tenant("ns-ref", sources["ns-ref"], policy=guard)
    try:
        # -- cold activation (a directory load) of each tenant, then (a) client
        # threads: frames -> submit_block -> reply frames, bitwise the engine
        cold = {}
        for name in ("north-star", "pension"):
            s1, p1 = _host_rows(1, policies[name].model.n_features, 0)
            t0 = time.perf_counter()
            host.evaluate(name, 0, s1, p1)
            cold[name] = time.perf_counter() - t0

        def client(name):
            res = []
            for i, n in enumerate(HOST_SIZES):
                s, pr = _host_rows(n, policies[name].model.n_features, n)
                d = (3 * i + 1) % policies[name].n_dates
                req = wire.decode_request(wire.encode_request(name, d, s, pr, seq=i + 1))
                got = host.submit_block(req["tenant"], req["date_idx"], req["states"],
                                        req["prices"], req["deadlines"]).result(timeout=600)
                back = wire.decode_reply(wire.encode_reply(got, date_idx=d, seq=req["seq"]))
                res.append((n, d, s, pr, back))
            return name, res

        counts.reset()
        with ThreadPoolExecutor(3) as pool:
            served = list(pool.map(client, ("north-star", "pension", "ns-ref")))
        after = counts.read()
        check(all(v == 0 for v in after.values()),
              f"the per-date lane launches no kernel ({after})")
        for name, res in served:
            for n, d, s, pr, back in res:
                want = direct[name].evaluate(d, s, pr)
                check(back.n_served == n and np.array_equal(back.phi, want[0])
                      and np.array_equal(back.psi, want[1]) and np.array_equal(back.value, want[2]),
                      f"[host] {name}: {n} rows at date {d} bitwise the tenant's engine")
        print(f"[host] 3 client threads x {len(HOST_SIZES)} blocks ({', '.join(map(str, HOST_SIZES))}"
              f" rows) as orp-ingest-v2 frames through ServeHost(max_live_engines=2): every "
              f"served row bitwise the tenant's own HedgeEngine; no kernel launched (the "
              f"per-date lane is cuBLAS); activations {[host.stats()[k]['activations'] for k in sources]}",
              flush=True)

        # -- (b) the mixed-date lane: single-row requests at many dates ride one
        # dispatch through K2 (two launches for the pension's two param sets)
        k2 = {}
        for name in ("north-star", "pension"):
            pol = policies[name]
            s, pr = _host_rows(HOST_MIXED_ROWS, pol.model.n_features, 5)
            dates = (np.arange(HOST_MIXED_ROWS) * 7) % pol.n_dates
            batcher = _hold(host, name)
            counts.reset()
            with batcher._cv:
                futs = [host.submit(name, int(dates[i]), s[i:i + 1], pr[i:i + 1])
                        for i in range(HOST_MIXED_ROWS)]
            got = [f.result(timeout=120) for f in futs]
            torch.cuda.synchronize()
            k2[name] = counts.only("mixed_head", f"[host] {name}'s mixed-date requests")
            check(k2[name] == (2 if pol.dual_mode != "mse_only" else 1),
                  f"[host] {name}: one dispatch, {k2[name]} K2 launch(es)")
            plain = HedgeEngine(pol, device="cpu").evaluate_mixed_async(dates, s, pr).result()
            for j, col in enumerate(("phi", "psi", "value")):
                mine = np.concatenate([g[j] for g in got])
                np.testing.assert_allclose(mine, plain[j], rtol=1e-5, atol=1e-6, err_msg=col)
        out["k2_launches"] = sum(k2.values())
        # K2 alone at the host batch's shape against its plain version (not counted)
        m = ns.model
        p = {k: v.to(dev) for k, v in ns.backward.params1_by_date.items()}
        d_t = torch.from_numpy((np.arange(HOST_MIXED_ROWS) * 7 % ns.n_dates).astype(np.int32)).to(dev)
        f_t = torch.from_numpy(_host_rows(HOST_MIXED_ROWS, 1, 5)[0]).to(dev)
        packed = megakernel.pack_head_params(m, p)
        kern = megakernel.mixed_head_forward(m, p, d_t, f_t, packed=packed)
        ref = megakernel.mixed_head_plain(m, p, d_t, f_t)
        out["k2_err"] = float((kern - ref).abs().max())
        check(bool(torch.allclose(kern, ref, rtol=1e-5, atol=1e-6)),
              f"[host] K2 at {HOST_MIXED_ROWS} rows within rtol 1e-5 of mixed_head_plain")
        out["k2_ms"] = cuda_ms(lambda: megakernel.mixed_head_forward(m, p, d_t, f_t,
                                                                     packed=packed), reps=200)
        out["k2_plain_ms"] = cuda_ms(lambda: megakernel.mixed_head_plain(m, p, d_t, f_t), reps=20)
        out["k2_bound"] = k2_bound_ms(m, HOST_MIXED_ROWS, ns.n_dates)
        print(f"[host] {HOST_MIXED_ROWS} single-row requests at {ns.n_dates} / {pen.n_dates} "
              f"dates through the mixed-date lane: north star {k2['north-star']} K2 launch, "
              f"pension {k2['pension']}, each within rtol 1e-5 of the plain version on the CPU; "
              f"K2 alone {out['k2_ms']:.4f} ms (max |kernel - plain| {out['k2_err']:.2e}, "
              f"bound {out['k2_bound'][0]:.6f} ms by {out['k2_bound'][1]}, plain "
              f"{out['k2_plain_ms']:.3f} ms)", flush=True)

        # -- (c) shed statuses and (d) a retry, on the guarded tenant
        s, pr = _host_rows(4096, 1, 9)
        budgets = np.where(np.arange(4096) % 5 == 0, -1.0, 60.0)
        want = direct["ns-ref"].evaluate(5, s, pr)
        batcher = _hold(host, "ns-ref")
        sb, pb = _host_rows(N_FULL, 1, 10)
        with batcher._cv:  # both blocks queue: 4,096 + 1,048,576 rows against the watermark
            a = host.submit_block("ns-ref", 5, s, pr, budgets)
            b = host.submit_block("ns-ref", 5, sb, pb)
        ra, rb = a.result(timeout=600), b.result(timeout=600)
        live = ra.status == SERVED
        check(np.array_equal(ra.status, np.where(np.arange(4096) % 5 == 0, SHED_DEADLINE,
                                                 SERVED))
              and np.array_equal(ra.phi[live], want[0][live]),
              "[host] deadline: every fifth row shed, the rest bitwise")
        n_ok = N_FULL - 4096
        want_b = direct["ns-ref"].evaluate(5, sb[:n_ok], pb[:n_ok])
        check(np.array_equal(rb.status, np.r_[np.full(n_ok, SERVED), np.full(4096, SHED_WATERMARK)])
              and np.array_equal(rb.phi[:n_ok], want_b[0]),
              f"[host] watermark: the block's tail past {N_FULL} queued rows shed, the head "
              "bitwise (coalesced with the first block)")
        with faults(FaultPlan(fail={"serve/dispatch": 2})) as inj:
            rr = host.submit_block("ns-ref", 5, s, pr).result(timeout=120)
        check(len(inj.log) == 2 and rr.n_served == 4096 and np.array_equal(rr.phi, want[0]),
              "[host] FaultPlan(fail={'serve/dispatch': 2}): two retries, served bitwise")
        print(f"[host] GuardPolicy(deadline_ms=60000, queue_watermark={N_FULL}, "
              f"max_retries=3): {ra.shed_counts()} of 4096 rows, {rb.shed_counts()} of "
              f"{N_FULL}; the retried block bitwise", flush=True)

        # -- (e) eviction to warm and back: no build, no params copy
        name = "pension"
        host.evaluate("north-star", 0, *_host_rows(1, 1, 0))
        host.evaluate("ns-ref", 0, *_host_rows(1, 1, 0))
        check(host.stats()[name]["tier"] == "warm", f"[host] {name} evicted to warm")
        res = host._tenants[name].resident
        ptr, mixed = res.p1["w0"].data_ptr(), res.mixed
        builds = dict(cuda_build.BUILD_STATS)
        s3, p3 = _host_rows(1, 3, 0)
        t0 = time.perf_counter()
        warm_out = host.evaluate(name, 0, s3, p3)
        out["warm_s"] = time.perf_counter() - t0
        eng = host._tenants[name].engine
        check(eng.resident is res and eng._p1["w0"].data_ptr() == ptr
              and eng._mixed_params() is mixed and mixed is not None
              and cuda_build.BUILD_STATS == builds,
              f"[host] warm re-activation: no build ({builds}), params at the same address")
        check(np.array_equal(warm_out[0], direct[name].evaluate(0, s3, p3)[0]),
              "[host] warm re-activation serves bitwise")
        out["cold_s"] = cold[name]
        print(f"[host] activation (the first 1-row request): cold {cold[name]:.4f} s "
              f"(load_bundle + params to the card), warm {out['warm_s']:.4f} s; "
              f"tiers {host.tiers.counts()}", flush=True)

        # -- (f) the canary, (g) the quality-gated reload, (h) the tier drill
        s, pr = _host_rows(64, 1, 2)
        before = host.evaluate("north-star", 3, s, pr)
        t0 = time.perf_counter()
        check(host.reload_tenant("north-star")["swapped"], "[host] same bundle promotes")
        out["reload_s"] = time.perf_counter() - t0
        with faults(FaultPlan(corrupt_reload=1)):
            try:
                host.reload_tenant("north-star")
                check(False, "[host] corrupt_reload must be rejected")
            except CanaryRejected:
                pass
        check(all(np.array_equal(a_, b_) for a_, b_ in zip(host.evaluate("north-star", 3, s, pr),
                                                          before)),
              "[host] after the reject the incumbent serves its bits")
        spec = ValidationSpec(kind="gbm", n_steps=52, rebalance_every=1, n_paths=2048,
                              replicates=4)
        t0 = time.perf_counter()
        q = host.reload_tenant("north-star", require_same_bits=False, quality_band=0.05,
                               validation=spec)
        out["reload_quality_s"] = time.perf_counter() - t0
        check(q["quality"]["regression"] == 0.0, "[host] the same policy regresses 0 on the "
              f"paired validation set ({q['quality']})")
        drill = promotion_drill(dataclasses.replace(ns, validation=spec), s,
                                quality_band=0.05, device=dev)
        check([d["tier"] for d in drill] == ["bf16", "int8"]
              and all(d["refused_under_bitwise"] and d["outcome"] in ("promoted", "rejected")
                      for d in drill), f"[host] the tier drill ({drill})")
        out["drill"] = drill
        print(f"[host] reload_tenant: bitwise canary {out['reload_s']:.3f} s (promoted; a "
              f"corrupt_reload rejected, the incumbent's bits untouched), quality-gated "
              f"{out['reload_quality_s']:.3f} s (hedge error {q['quality']['incumbent']['mean']:.6f}"
              f" both, {spec.n_paths} paths x {spec.replicates} replicates, {spec.n_steps} "
              f"steps); tier drill: " + "; ".join(
                  f"{d['tier']} refused under bits, {d['outcome']}"
                  + (f" (regression {d['regression']:+.4%})" if "regression" in d else "")
                  for d in drill), flush=True)

        # -- latency and rows/s: host vs bare engine, in turns, in this call, and
        # the host's parts: a lone MicroBatcher (its 200 us coalescing window,
        # then none) and the tenant's drift monitor on the block lane
        s1, p1 = _host_rows(1, 1, 1)
        bare = direct["north-star"]
        sb, pb = _host_rows(N_FULL, 1, 3)
        lat = {"host": [], "batcher": [], "batcher_nowait": [], "engine": []}
        rps = {"host": [], "batcher": [], "engine": []}
        drift = host._tenants["north-star"].drift
        with MicroBatcher(bare) as mb, MicroBatcher(bare, max_wait_us=0.0) as mb0:
            for _ in range(3):
                lat["host"].append(_median_ms(lambda: host.evaluate("north-star", 7, s1, p1)))
                lat["batcher"].append(_median_ms(lambda: mb.evaluate(7, s1, p1)))
                lat["batcher_nowait"].append(_median_ms(lambda: mb0.evaluate(7, s1, p1)))
                lat["engine"].append(_median_ms(lambda: bare.evaluate(7, s1, p1)))
            for _ in range(3):
                for key, fn in (("host", lambda: host.submit_block("north-star", 9, sb, pb)
                                 .result(timeout=120)),
                                ("batcher", lambda: mb.submit_block(9, sb, pb).result(timeout=120)),
                                ("engine", lambda: bare.evaluate(9, sb, pb))):
                    t0 = time.perf_counter()
                    fn()
                    rps[key].append(N_FULL / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        drift.update(sb)
        out["drift_ms"] = (time.perf_counter() - t0) * 1e3
        for key, v in lat.items():
            out[f"lat_{key}_ms"] = sorted(v)[1]
        for key, v in rps.items():
            out[f"rps_{key}"] = sorted(v)[1]
        print(f"[host] 1-row latency host to host (median of 3 x 31, in turns): ServeHost "
              f"{out['lat_host_ms']:.3f} ms, a lone MicroBatcher {out['lat_batcher_ms']:.3f} ms "
              f"(max_wait_us=0: {out['lat_batcher_nowait_ms']:.3f} ms), bare HedgeEngine "
              f"{out['lat_engine_ms']:.3f} ms; {N_FULL}-row block (median of 3): "
              f"ServeHost.submit_block {out['rps_host']:,.0f} rows/s, MicroBatcher.submit_block "
              f"{out['rps_batcher']:,.0f}, engine {out['rps_engine']:,.0f}; the tenant's drift "
              f"monitor folds the block in {out['drift_ms']:.2f} ms | {card_line()}", flush=True)
    finally:
        host.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[host] training the served policies at {HOST_TRAIN_PATHS} paths "
          f"{out['train_s']:.2f} s; the phase {out['phase_s']:.2f} s", flush=True)
    return out


# [gateway]: the block sizes through each lane, the mixed-date batch of
# single-row frames, and the rings sized for a 1,048,576-row block of one
# feature (a 4 MiB request frame, a ~13 MiB reply; a record may take a quarter
# of its ring)
GATEWAY_SIZES = (1, 1024, 65_536, N_FULL)
GATEWAY_MIXED_ROWS = 512
RING_REQ_BYTES, RING_REP_BYTES = 32 << 20, 64 << 20


def _lane_rows_per_s(submit, n: int, states, d: int, want, what: str) -> float:
    """Median of 3 serial round trips of one ``n``-row block, each bitwise ``want``."""
    import numpy as np

    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = submit(d, states)
        rates.append(n / (time.perf_counter() - t0))
        check(res.n_served == n and np.array_equal(res.phi, want[0])
              and np.array_equal(res.psi, want[1]),
              f"[gateway] {what}: {n} rows at date {d} bitwise the tenant's HedgeEngine")
    return sorted(rates)[1]


def _fleet_breakdown(policy, tenants: int = 6, blocks: int = 10, rows: int = 1024) -> dict:
    """Where a fleet hop's time goes: the same pipelined traffic ([gateway]'s
    fleet shape, one replica) through ``ServeHost.submit_block`` direct, one
    replica gateway through a resilient client, and a fleet gateway in front
    of it with the fleet phase's 50 ms health polling and with 1 s polling;
    and the replica gateway with ``max_inflight_replies`` raised from its
    default 8 to the client's window of 32 (past the bound, frames come back
    BUSY and the client backs off). Rows/s of each, median of 3, every block
    bitwise."""
    import numpy as np

    from orp_tpu_torch.serve import HedgeEngine, ResilientGatewayClient, ServeGateway, ServeHost
    from orp_tpu_torch.serve.fleet import FleetHost, ReplicaSpec

    names = [f"tenant-{i:02d}" for i in range(tenants)]
    traffic = [(t, _host_rows(rows, 1, 500 + 10 * i + j)[0])
               for i, t in enumerate(names) for j in range(blocks)]
    direct = HedgeEngine(policy)
    want = [direct.evaluate(0, b) for _, b in traffic]

    def rate(submit, what):
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            futs = [submit(t, b) for t, b in traffic]
            got = [f.result(timeout=120) for f in futs]
            rates.append(len(traffic) * rows / (time.perf_counter() - t0))
            check(all(np.array_equal(g.phi, w[0]) for g, w in zip(got, want)),
                  f"[gateway] breakdown {what}: bitwise")
        return sorted(rates)[1]

    out = {}
    with ServeHost(max_live_engines=tenants) as host:
        for t in names:
            host.add_tenant(t, policy)
            host.evaluate(t, 0, traffic[0][1][:1])
        out["host"] = rate(lambda t, b: host.submit_block(t, 0, b), "host")
        with ServeGateway(host, port=0, max_inflight_replies=32) as gw:
            with ResilientGatewayClient(*gw.address, window=32, timeout_s=120.0) as c:
                out["replica_gateway_inflight32"] = rate(
                    lambda t, b: c.submit_block_async(t, 0, b), "one replica gateway, 32")
        with ServeGateway(host, port=0) as gw:
            with ResilientGatewayClient(*gw.address, window=32, timeout_s=120.0) as c:
                out["replica_gateway"] = rate(lambda t, b: c.submit_block_async(t, 0, b),
                                              "one replica gateway")
                out["busy"] = c.stats["busy"]
            for poll in (0.05, 1.0):
                fh = FleetHost([ReplicaSpec("r0", *gw.address)], health_poll_s=poll,
                               health_fail_after=1)
                try:
                    with ServeGateway(fh, port=0) as fg, \
                            ResilientGatewayClient(*fg.address, window=32,
                                                   timeout_s=120.0) as c:
                        out[f"fleet_poll_{poll}"] = rate(
                            lambda t, b: c.submit_block_async(t, 0, b), f"fleet, poll {poll}")
                finally:
                    fh.close()
    return out


def gateway_phases(dev, counts) -> dict:
    """[gateway]: the network and fleet plane over ``ServeHost`` on the card,
    with the committed north-star policy: the content-addressed store, the TCP
    gateway through the v1 and the resilient v2 clients, the mixed-date batch
    of single-row frames through TCP and through the ring (one K2 launch
    each), the delivery drills, the ring at 1,048,576 rows, the fleet at one
    and two replicas with its kill drill, and the live scrape."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY, obs
    from orp_tpu_torch.guard import FaultPlan, faults
    from orp_tpu_torch.serve import (GatewayClient, HedgeEngine, MetricsServer,
                                     ResilientGatewayClient, ServeGateway, ServeHost,
                                     export_bundle, load_bundle, megakernel, parse_prometheus,
                                     wire)
    from orp_tpu_torch.serve import bench as serve_bench
    from orp_tpu_torch.serve.shm import RingClient, RingPair, RingServer
    from orp_tpu_torch.store import open_store
    from orp_tpu_torch.utils.measure import cuda_ms

    t_phase = time.perf_counter()
    out = {}
    policy = load_bundle(NORTH_STAR_POLICY)
    direct = HedgeEngine(policy)
    nd = policy.n_dates
    root = pathlib.Path(tempfile.mkdtemp(prefix="orp-gateway-"))
    rows = {n: _host_rows(n, 1, 100 + i)[0] for i, n in enumerate(GATEWAY_SIZES)}
    want = {n: direct.evaluate((5 * i + 3) % nd, rows[n]) for i, n in enumerate(GATEWAY_SIZES)}
    dates = {n: (5 * i + 3) % nd for i, n in enumerate(GATEWAY_SIZES)}
    try:
        # -- 1. the store: one tree, two manifests; store:// serves bitwise
        store = open_store(root / "store")
        t0 = time.perf_counter()
        export_bundle(policy, root / "ns", store=store, tenant="ns-a")
        store.publish("ns-b", root / "ns")
        out["publish_s"] = time.perf_counter() - t0
        st = store.stats()
        check(st["tenants"] == 2 and st["manifests"] == 2 and st["blobs"] == 2 + 3,
              f"[gateway] store: two tenants over one tree ({st})")
        t0 = time.perf_counter()
        warm_dir = store.materialize("ns-a")
        out["materialize_s"] = time.perf_counter() - t0
        shutil.rmtree(warm_dir)
        t0 = time.perf_counter()
        via = load_bundle(f"store://{root / 'store'}#ns-a")
        out["first_load_s"] = time.perf_counter() - t0
        check(all(torch.equal(via.backward.params1_by_date[k], policy.backward.params1_by_date[k])
                  for k in policy.backward.params1_by_date),
              "[gateway] store:// params bitwise the directory's")
        n = GATEWAY_SIZES[2]  # 65,536 rows
        with ServeHost(max_live_engines=1) as sh:
            sh.add_tenant("ns-a", f"store://{root / 'store'}#ns-a")
            got = sh.submit_block("ns-a", dates[n], rows[n]).result(timeout=120)
        check(np.array_equal(got.phi, want[n][0]) and np.array_equal(got.psi, want[n][1]),
              f"[gateway] a store:// tenant serves {n} rows bitwise the directory-loaded engine")
        store.remove("ns-b")
        gc = store.gc()
        check(gc["removed"] == 1 and store.stats()["blobs"] == st["blobs"] - 1,
              f"[gateway] gc of the removed tenant frees its manifest only ({gc})")
        print(f"[gateway] store: export_bundle(store=) + a second tenant {out['publish_s']:.4f} s "
              f"({st['blobs']} blobs, {st['blob_bytes']} bytes, dedup {st['dedup_ratio']}), "
              f"materialize {out['materialize_s']:.4f} s, first store:// load "
              f"{out['first_load_s']:.4f} s; a store:// tenant's {n}-row block bitwise; gc "
              f"freed {gc['removed']} blob | {card_line()}", flush=True)

        # -- 2. the TCP gateway: v1 and v2, bitwise, rows/s, 1-row latency
        host = ServeHost(max_live_engines=2)
        host.add_tenant("ns", NORTH_STAR_POLICY)
        gw = ServeGateway(host, port=0)
        pair = None
        try:
            host.evaluate("ns", 0, rows[1])
            rps = {}
            with GatewayClient(*gw.address, timeout_s=300.0) as v1, \
                    ResilientGatewayClient(*gw.address, window=8, timeout_s=300.0) as v2:
                for lane, c in (("v1", v1), ("v2", v2)):
                    for n in GATEWAY_SIZES:
                        rps[(lane, n)] = _lane_rows_per_s(
                            lambda d, x, c=c: c.submit_block("ns", d, x), n, rows[n], dates[n],
                            want[n], f"TCP {lane}")
                s1 = rows[1]
                lat = {"v1": [], "v2": [], "host": [], "host_block": []}
                for _ in range(3):
                    lat["v1"].append(_median_ms(lambda: v1.submit_block("ns", 7, s1)))
                    lat["v2"].append(_median_ms(lambda: v2.submit_block("ns", 7, s1)))
                    lat["host"].append(_median_ms(lambda: host.evaluate("ns", 7, s1)))
                    lat["host_block"].append(_median_ms(
                        lambda: host.submit_block("ns", 7, s1).result(timeout=60)))
                lat["v1_ping"] = [_median_ms(v1.ping) for _ in range(3)]
                lat["v2_ping"] = [_median_ms(lambda: v2.ping(timeout_s=60.0))
                                  for _ in range(3)]
                check(v2.stats["duplicate_replies"] == 0 and v2.stats["reconnects"] == 0,
                      f"[gateway] v2 clean run ({v2.stats})")
            # the ring, sized for a 1M-row block, in the temp directory
            tmp = pathlib.Path(tempfile.gettempdir())
            pair = RingPair.create(req_capacity=RING_REQ_BYTES, rep_capacity=RING_REP_BYTES)
            out["ring_file"] = str(pair.path)
            check(pair.path.parent == tmp and pair.path.stat().st_size
                  == RING_REQ_BYTES + RING_REP_BYTES + 192,
                  f"[gateway] the ring file in {tmp} ({pair.path})")
            with RingServer(host, pair, default_tenant="ns") as rs, \
                    RingClient(pair, window=8, timeout_s=300.0) as rc:
                for n in GATEWAY_SIZES:
                    rps[("ring", n)] = _lane_rows_per_s(
                        lambda d, x: rc.submit_block("ns", d, x), n, rows[n], dates[n],
                        want[n], "ring")
                lat["ring"] = [_median_ms(lambda: rc.submit_block("ns", 7, s1))
                               for _ in range(3)]
                lat["ring_ping"] = [_median_ms(lambda: rc.ping(timeout_s=60.0))
                                    for _ in range(3)]
                check(rc.stats["duplicate_replies"] == 0 and rs.totals()["errors"] == 0,
                      f"[gateway] ring clean run ({rc.stats}, {rs.totals()})")
            pair.unlink()
            # wrap-around: 96 frames of 4,096 rows through 1 MiB rings
            pair = RingPair.create(req_capacity=1 << 20, rep_capacity=1 << 20)
            blocks = [_host_rows(4096, 1, 300 + i)[0] for i in range(96)]
            with RingServer(host, pair, default_tenant="ns"), \
                    RingClient(pair, window=4, timeout_s=120.0) as rc:
                futs = [rc.submit_block_async("ns", i % nd, b) for i, b in enumerate(blocks)]
                got = [f.result(timeout=120) for f in futs]
                check(rc.stats["duplicate_replies"] == 0, "[gateway] wrap-around: no duplicate")
            for i, (b, g) in enumerate(zip(blocks, got)):
                w = direct.evaluate(i % nd, b)
                check(np.array_equal(g.phi, w[0]) and np.array_equal(g.psi, w[1]),
                      f"[gateway] wrap-around frame {i} bitwise")
            pair.unlink()
            pair = None
            for k, v in lat.items():
                out[f"lat_{k}_ms"] = sorted(v)[1]
            # the codec's share of a 1-row round trip: both frames encoded and decoded
            one = host.submit_block("ns", 7, s1).result(timeout=60)
            out["codec_1row_ms"] = _median_ms(lambda: [wire.decode_reply(wire.encode_reply(
                one, seq=wire.decode_request(wire.encode_request("ns", 7, s1, seq=1))["seq"]))
                for _ in range(100)]) / 100
            out["rps"] = {f"{lane}@{n}": v for (lane, n), v in rps.items()}
            print(f"[gateway] blocks of {', '.join(map(str, GATEWAY_SIZES))} rows through TCP v1 "
                  f"(GatewayClient), TCP v2 (ResilientGatewayClient) and the ring "
                  f"({RING_REQ_BYTES >> 20} + {RING_REP_BYTES >> 20} MiB in {tmp}): every "
                  f"served row bitwise the tenant's HedgeEngine; 96 frames of 4,096 rows "
                  f"through 1 MiB rings (wrap-around) bitwise", flush=True)
            print("[gateway] rows/s (median of 3 serial blocks): " + "; ".join(
                f"{lane} " + ", ".join(f"{n}: {rps[(lane, n)]:,.0f}" for n in GATEWAY_SIZES[1:])
                for lane in ("v1", "v2", "ring")) + f" | {card_line()}", flush=True)
            print(f"[gateway] 1-row round trip (median of 3 x 31): TCP v1 "
                  f"{out['lat_v1_ms']:.3f} ms, TCP v2 {out['lat_v2_ms']:.3f} ms, ring "
                  f"{out['lat_ring_ms']:.3f} ms; ServeHost direct: evaluate "
                  f"{out['lat_host_ms']:.3f} ms, submit_block {out['lat_host_block_ms']:.3f} ms; "
                  f"PING/PONG alone: v1 {out['lat_v1_ping_ms']:.3f} ms, v2 "
                  f"{out['lat_v2_ping_ms']:.3f} ms, ring {out['lat_ring_ping_ms']:.3f} ms; both "
                  f"frames' encode + decode {out['codec_1row_ms'] * 1e3:.1f} us "
                  f"| {card_line()}", flush=True)
        finally:
            if pair is not None:
                pair.unlink()
            gw.close()
            host.close()

        # -- 3. the mixed-date batch of single-row frames: one K2 launch, TCP
        # and ring; the batch fills the batcher's max_batch, so it is one dispatch
        m_rows = GATEWAY_MIXED_ROWS
        ms_states = _host_rows(m_rows, 1, 5)[0]
        m_dates = (np.arange(m_rows) * 7) % nd
        plain = HedgeEngine(policy, device="cpu").evaluate_mixed_async(
            m_dates, ms_states).result()
        k2 = {}
        mixed_kw = {"mixed_dates": True, "max_batch": m_rows, "max_wait_us": 20e6}
        with ServeHost(max_live_engines=1, batcher_kwargs=mixed_kw) as mh:
            mh.add_tenant("ns", NORTH_STAR_POLICY)
            _hold(mh, "ns")  # activate with no request: a lone one would wait out the window
            with ServeGateway(mh, port=0, max_inflight_replies=m_rows,
                              reply_cache=m_rows) as mgw:
                res = [None] * m_rows
                per = m_rows // 8

                def producer(k):
                    with ResilientGatewayClient(*mgw.address, window=per,
                                                timeout_s=120.0) as c:
                        idx = range(k * per, (k + 1) * per)
                        futs = [c.submit_block_async("ns", int(m_dates[i]), ms_states[i:i + 1])
                                for i in idx]
                        for i, f in zip(idx, futs):
                            res[i] = f.result(timeout=120)

                counts.reset()
                threads = [threading.Thread(target=producer, args=(k,)) for k in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(180)
                torch.cuda.synchronize()
                k2["tcp"] = counts.only("mixed_head", "[gateway] the TCP mixed-date frames")
            check(all(r is not None and r.n_served == 1 for r in res),
                  "[gateway] every mixed-date frame served")
            check(k2["tcp"] == 1, f"[gateway] TCP: one K2 launch ({k2['tcp']})")
            tcp_phi = np.concatenate([r.phi for r in res])
            np.testing.assert_allclose(tcp_phi, plain[0], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(np.concatenate([r.psi for r in res]), plain[1],
                                       rtol=1e-5, atol=1e-6)
            rpair = RingPair.create(req_capacity=1 << 20, rep_capacity=1 << 20)
            try:
                with RingServer(mh, rpair, default_tenant="ns"), \
                        RingClient(rpair, window=m_rows, timeout_s=120.0) as rc:
                    counts.reset()
                    futs = [rc.submit_block_async("ns", int(m_dates[i]), ms_states[i:i + 1])
                            for i in range(m_rows)]
                    rres = [f.result(timeout=120) for f in futs]
                    torch.cuda.synchronize()
                    k2["ring"] = counts.only("mixed_head", "[gateway] the ring's mixed-date frames")
            finally:
                rpair.unlink()
            check(k2["ring"] == 1, f"[gateway] ring: one K2 launch ({k2['ring']})")
            np.testing.assert_allclose(np.concatenate([r.phi for r in rres]), plain[0],
                                       rtol=1e-5, atol=1e-6)
        out["k2_launches"] = k2["tcp"]
        m = policy.model
        p = {k: v.to(dev) for k, v in policy.backward.params1_by_date.items()}
        d_t = torch.from_numpy(m_dates.astype(np.int32)).to(dev)
        f_t = torch.from_numpy(ms_states).to(dev)
        packed = megakernel.pack_head_params(m, p)
        kern = megakernel.mixed_head_forward(m, p, d_t, f_t, packed=packed)
        ref = megakernel.mixed_head_plain(m, p, d_t, f_t)
        out["k2_err"] = float((kern - ref).abs().max())
        check(bool(torch.allclose(kern, ref, rtol=1e-5, atol=1e-6)),
              f"[gateway] K2 at {m_rows} rows within rtol 1e-5 of mixed_head_plain")
        out["k2_ms"] = cuda_ms(lambda: megakernel.mixed_head_forward(m, p, d_t, f_t,
                                                                     packed=packed), reps=200)
        out["k2_plain_ms"] = cuda_ms(lambda: megakernel.mixed_head_plain(m, p, d_t, f_t), reps=20)
        out["k2_bound"] = k2_bound_ms(m, m_rows, nd)
        print(f"[gateway] {m_rows} single-row frames at {nd} dates from 8 client threads "
              f"(TCP v2) and from one ring client: {k2['tcp']} and {k2['ring']} K2 launch(es), "
              f"each within rtol 1e-5 of the plain version on the CPU; K2 alone "
              f"{out['k2_ms']:.4f} ms (max |kernel - plain| {out['k2_err']:.2e}, bound "
              f"{out['k2_bound'][0]:.6f} ms by {out['k2_bound'][1]}, plain "
              f"{out['k2_plain_ms']:.3f} ms) | {card_line()}", flush=True)

        # -- 4. the delivery drills
        t0 = time.perf_counter()
        drill = serve_bench.gateway_drill(policy, blocks=64, block_rows=1024, kill_at_frame=20,
                                          seed=7, repeats=3, device=dev)
        check(drill["rows_lost"] == 0 and drill["duplicate_serves"] == 0
              and drill["replayed_bits_equal"] and drill["mttr_runs"] == 3,
              f"[gateway] kill at frame 20: zero loss, no duplicate, bits equal ({drill})")
        out["drill"] = drill
        out["drill_s"] = time.perf_counter() - t0
        blocks = [_host_rows(1024, 1, 400 + i)[0] for i in range(12)]
        wants = [direct.evaluate(0, b) for b in blocks]

        def delivered(results, what):
            check(len(results) == len(blocks) and all(
                r.n_served == 1024 and np.array_equal(r.phi, w[0])
                and np.array_equal(r.psi, w[1]) for r, w in zip(results, wants)),
                f"[gateway] {what}: every row served once, bitwise")

        drills = {}
        with ServeHost(max_live_engines=1, batcher_kwargs={"max_wait_us": 30_000.0}) as dh:
            dh.add_tenant("d", NORTH_STAR_POLICY)
            dh.evaluate("d", 0, rows[1])
            with ServeGateway(dh, port=0, frame_deadline_s=0.05) as g:
                for name, plan in (("torn", FaultPlan(torn_send={"client/send": 1})),
                                   ("stall", FaultPlan(stall_send={"client/send": (1, 0.2)}))):
                    with ResilientGatewayClient(*g.address, window=2, timeout_s=120.0) as rc:
                        with faults(plan) as inj:
                            got = [rc.submit_block("d", 0, b) for b in blocks]
                        check(len(inj.log) == 1 and rc.stats["reconnects"] >= 1
                              and rc.stats["duplicate_replies"] == 0,
                              f"[gateway] {name}_send re-delivered ({inj.log}, {rc.stats})")
                        drills[name] = dict(rc.stats)
                    delivered(got, f"{name}_send")
            with ServeGateway(dh, port=0, max_inflight_replies=1) as g:
                with ResilientGatewayClient(*g.address, window=4, timeout_s=120.0) as rc:
                    futs = [rc.submit_block_async("d", 0, b) for b in blocks]
                    got = [f.result(timeout=120) for f in futs]
                    drills["busy"] = dict(rc.stats)
                check(drills["busy"]["busy"] >= 1 and drills["busy"]["duplicate_replies"] == 0,
                      f"[gateway] BUSY tripped, nothing duplicated ({drills['busy']})")
                delivered(got, "BUSY backpressure (no row shed)")
            gw_a, gw_b = ServeGateway(dh, port=0), ServeGateway(dh, port=0)
            try:
                with ResilientGatewayClient(*gw_a.address, window=4, timeout_s=120.0) as rc:
                    futs, closer = [], None
                    for i, b in enumerate(blocks):
                        futs.append(rc.submit_block_async("d", 0, b))
                        if i == 5:
                            closer = threading.Thread(target=gw_a.close,
                                                      kwargs={"successor": gw_b.address})
                            closer.start()
                    got = [f.result(timeout=120) for f in futs]
                    drills["redirect"] = dict(rc.stats)
                closer.join(60)
                ta, tb = gw_a.totals(), gw_b.totals()
            finally:
                gw_a.close()
                gw_b.close()
            check(drills["redirect"]["redirects"] >= 1
                  and drills["redirect"]["duplicate_replies"] == 0
                  and ta["rows"] + tb["rows"] == 1024 * len(blocks) and ta["rows"] > 0
                  and tb["rows"] > 0, f"[gateway] drain-and-redirect A -> B: ledgers {ta['rows']}"
                  f" + {tb['rows']} rows ({drills['redirect']})")
            delivered(got, "drain-and-redirect")
        out["drills"] = drills
        print(f"[gateway] drills: kill at frame {drill['kill_at_frame']} of {drill['blocks']} x "
              f"{drill['block_rows']:,} rows ({drill['repeats']} runs): rows lost "
              f"{drill['rows_lost']}, duplicate serves {drill['duplicate_serves']}, replayed "
              f"bits equal, MTTR {drill['mttr_ms']:.1f} ms (IQR {drill['mttr_ms_iqr']:.1f}); "
              f"torn_send and stall_send (0.2 s against a 0.05 s frame deadline) re-delivered; "
              f"BUSY x {drills['busy']['busy']} with no row shed; drain-and-redirect A -> B "
              f"{ta['rows']} + {tb['rows']} rows | {card_line()}", flush=True)

        # -- 5. the fleet at one and two replicas on the card, then its kill drill
        t0 = time.perf_counter()
        fleet = serve_bench.fleet_phase(policy, replica_counts=(1, 2), gateways=2, tenants=6,
                                        blocks_per_tenant=10, block_rows=1024, repeats=3,
                                        device=dev)
        out["fleet_s"] = time.perf_counter() - t0
        out["fleet"] = fleet
        kd = fleet["kill_drill"]
        check(kd["rows_lost"] == 0 and kd["duplicate_serves"] == 0
              and kd["rows_served"] == kd["rows_sent"],
              f"[gateway] fleet kill drill: zero loss, no duplicate ({kd})")
        lv = {x["replicas"]: x for x in fleet["levels"]}
        print(f"[gateway] fleet ({fleet['gateways']} fleet gateways, {fleet['tenants']} tenants x "
              f"{fleet['blocks_per_tenant']} blocks of {fleet['block_rows']:,} rows, every "
              f"replica a ServeHost on this card): 1 replica {lv[1]['rows_per_s']:,.0f} rows/s, "
              f"p99 {lv[1]['p99_ms']:.2f} ms; 2 replicas {lv[2]['rows_per_s']:,.0f} rows/s, p99 "
              f"{lv[2]['p99_ms']:.2f} ms; routing identical across gateways, every tenant "
              f"bitwise; kill {kd['killed']}: {kd['tenants_remapped']} tenants remapped, rows "
              f"lost 0, duplicates 0, MTTR {kd['mttr_ms']:.1f} ms; coalescing "
              f"{fleet['coalesce']['dispatches_coalesced']} vs "
              f"{fleet['coalesce']['dispatches_uncoalesced']} dispatches bitwise; "
              f"{out['fleet_s']:.1f} s | {card_line()}", flush=True)

        t0 = time.perf_counter()
        out["fleet_breakdown"] = bd = _fleet_breakdown(policy)
        print(f"[gateway] where a fleet hop's time goes (6 tenants x 10 blocks of 1,024 rows, "
              f"pipelined, one replica, median of 3): ServeHost.submit_block "
              f"{bd['host']:,.0f} rows/s, one replica gateway {bd['replica_gateway']:,.0f} "
              f"({bd['busy']} BUSY frames in 3 runs at max_inflight_replies=8, the client's "
              f"window 32; at 32: {bd['replica_gateway_inflight32']:,.0f}), a fleet gateway in "
              f"front (health poll 50 ms) {bd['fleet_poll_0.05']:,.0f}, (1 s) "
              f"{bd['fleet_poll_1.0']:,.0f}; {time.perf_counter() - t0:.1f} s | {card_line()}",
              flush=True)

        # -- 6. the live scrape
        with obs.telemetry(None), ServeHost(max_live_engines=1) as sh:
            sh.add_tenant("ns", NORTH_STAR_POLICY)
            with ServeGateway(sh, port=0) as g, \
                    MetricsServer(g.metrics_text, health_fn=g.health_report) as srv:
                with GatewayClient(*g.address, timeout_s=60.0) as c:
                    c.submit_block("ns", 3, rows[1024])
                    try:
                        c.submit_block("nobody", 3, rows[1])
                        check(False, "[gateway] an unknown tenant must be refused")
                    except Exception:  # noqa: BLE001  # orp: noqa[ORP009] -- the refusal is the check
                        pass
                with urllib.request.urlopen("http://%s:%d/metrics" % srv.address,
                                            timeout=30) as r:
                    series = parse_prometheus(r.read().decode())
        names = ("serve_requests_total", "serve_request_latency_seconds",
                 "serve_queue_age_seconds", "guard_shed", "serve_gateway_rows",
                 "serve_gateway_errors")
        check(all(n in series for n in names)
              and any(lb.get("stage") == "serve" for lb, _ in series["serve_gateway_errors"]),
              f"[gateway] the live scrape carries the serve series ({sorted(series)})")
        print(f"[gateway] MetricsServer /metrics: {len(series)} series, among them "
              + ", ".join(names) + " (stage=serve)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[gateway] the phase {out['phase_s']:.2f} s | {card_line()}", flush=True)
    return out


AOT_EXTRA_BUCKETS = (65_536, N_FULL)
AOT_DATES = (0, 25, 51)
#: [perf]'s measured phase: evaluate calls of 64 rows a repeat (~0.2 s a repeat
#: on the card; at 32 the ~25 ms draws moved 25% between two back-to-back gate
#: runs beside the plane's nvcc children, past the gate's 4-IQR band)
PERF_GATE_EVALS = 256
AOT_WALK_PATHS = 1 << 16


def _aot_child(mode: str, cache_dir, *args) -> subprocess.Popen:
    """``tools/torch_aot_child.py`` in a fresh process with ``ORP_TORCH_CACHE_DIR``
    at ``cache_dir`` (the caller waits and reads its last line)."""
    import os

    env = {**os.environ, "ORP_TORCH_CACHE_DIR": str(cache_dir)}
    env.pop("ORP_TESTS_NO_COMPILE_CACHE", None)
    return subprocess.Popen([sys.executable, str(HERE / "tools" / "torch_aot_child.py"), mode,
                             *map(str, args)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def _stop(proc: subprocess.Popen) -> None:
    """End a child started in a session of its own, and what it started
    (``nvcc`` and its compilers)."""
    import os
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _aot_result(proc: subprocess.Popen, what: str, timeout: float = 600) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        _stop(proc)
    check(proc.returncode == 0, f"{what}: rc {proc.returncode}\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _sha(path) -> str | None:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


def _turns(fa, fb, n: int) -> tuple[float, float]:
    """Medians of ``fa`` and ``fb``'s host-to-host walls (ms), taken in turns."""
    wa, wb = [], []
    for i in range(n):
        for f, w in ((fa, wa), (fb, wb)) if i % 2 == 0 else ((fb, wb), (fa, wa)):
            t0 = time.perf_counter()
            f()
            w.append((time.perf_counter() - t0) * 1e3)
    return sorted(wa)[n // 2], sorted(wb)[n // 2]


def aot_plane_phases(dev, counts, beside=None) -> dict:
    """[aot], [perf], [profile], [degrade] and [serve-bench]: the
    compile-and-perf plane on the card (the phases 31-35 of the module
    docstring). Returns the numbers the kernels line and [times] print.
    ``beside``: a phase run after [serve-bench] while the background
    children (the nvcc-bound cold start, the warm build) finish; its result
    is ``out["beside"]``."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY, obs
    from orp_tpu_torch.aot import export_aot
    from orp_tpu_torch.aot.bundle_exec import AOT_META, DEFAULT_BUCKETS
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.guard import FaultPlan, faults
    from orp_tpu_torch.obs import devprof, perf
    from orp_tpu_torch.obs.sink import ListSink
    from orp_tpu_torch.serve import HedgeEngine, export_bundle, load_bundle, megakernel
    from orp_tpu_torch.serve import bench
    from orp_tpu_torch.utils import cuda_build
    from orp_tpu_torch.utils.measure import cuda_ms

    t_phase = time.perf_counter()
    out: dict = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="orp-aot-"))
    card = card_line()
    background: list = []
    try:
        # -- [aot] ---------------------------------------------------------------
        t0 = time.perf_counter()
        bdir = root / "bundle"
        policy = export_bundle(load_bundle(NORTH_STAR_POLICY), bdir)
        # the cold start (an nvcc-bound child on an empty cache) runs beside the
        # phases below, on one of the host's cores
        background.append(("cold", _aot_child("cold", root / "cache_cold", "--bundle", bdir)))
        buckets = (*DEFAULT_BUCKETS, *AOT_EXTRA_BUCKETS)
        exported = {tier: export_aot(bdir, policy, buckets=buckets, precision=tier)
                    for tier in ("f32", "bf16")}
        export_s = time.perf_counter() - t0
        want_buckets = sorted(HedgeEngine(policy, use_aot=False).bucket_for(b) for b in buckets)
        aot_policy = load_bundle(bdir)
        check(aot_policy.aot_dir == bdir, "the exported bundle carries its AOT set")
        ser = _aot_result(_aot_child("serve", root / "cache_serve", "--bundle", bdir,
                                     "--tiers", "f32,bf16",
                                     "--dates", ",".join(map(str, AOT_DATES))),
                          "the fresh AOT process")
        check(ser["nvcc"] == 0, f"the fresh AOT process ran nvcc {ser['nvcc']} time(s)")
        for tier, t in ser["tiers"].items():
            check(t["aot_buckets"] == want_buckets,
                  f"{tier}: AOT buckets {t['aot_buckets']} != {want_buckets}")
            check(t["requests"] == len(want_buckets) * len(AOT_DATES)
                  and t["aot_hits"] == t["requests"],
                  f"{tier}: {t['aot_hits']} AOT hits for {t['requests']} requests")
            check(t["mismatches"] == [], f"{tier}: AOT replay differs from the eager engine "
                                         f"at (bucket, date) {t['mismatches']}")
        # warm_fused_walk into an empty cache: another nvcc-bound child

        def warm():
            """``warm_fused_walk`` of the north star's fused GN walk into an empty
            cache, in a process of its own."""
            code = ("import json, sys; sys.path.insert(0, %r)\n"
                    "from orp_tpu_torch.aot import warm_fused_walk\n"
                    "from orp_tpu_torch.api import TrainConfig\n"
                    "from orp_tpu_torch.api.pipelines import _backward_cfg\n"
                    "from orp_tpu_torch.models import HedgeMLP\n"
                    "r = warm_fused_walk(HedgeMLP(n_features=1, constrain_self_financing="
                    "False), _backward_cfg(TrainConfig(dual_mode='mse_only', optimizer="
                    "'gauss_newton', fused=True)), n_paths=%d, n_dates=52)\n"
                    "print(json.dumps(r))\n" % (str(HERE), AOT_WALK_PATHS))
            import os

            env = {**os.environ, "ORP_TORCH_CACHE_DIR": str(root / "cache_walk")}
            env.pop("ORP_TESTS_NO_COMPILE_CACHE", None)
            return subprocess.Popen([sys.executable, "-c", code], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    start_new_session=True)

        background.append(("warm", warm()))
        # a tampered manifest: one warning, one counter event, no AOT bucket, the same bits
        tdir = root / "tampered"
        shutil.copytree(bdir, tdir)
        topo = next(k for k in exported["f32"]["topologies"])
        mf = tdir / "aot" / topo / AOT_META
        m = json.loads(mf.read_text())
        m["fingerprint"]["device_kind"] = "NVIDIA H200"
        mf.write_text(json.dumps(m))
        eager = HedgeEngine(policy, use_aot=False)
        rows = {n: _host_rows(n, 1, 300 + n % 97)[0] for n in (1, 1000, N_FULL)}
        sink = ListSink()
        with obs.active(sink=sink), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tampered = HedgeEngine(load_bundle(tdir))
        mism = [e for e in sink.events if e.get("name") == "aot/fingerprint_mismatch"]
        n_warn = sum("unusable" in str(w.message) for w in caught)
        check(n_warn == 1 and len(mism) == 1 and tampered.cache_info()["aot_buckets"] == [],
              f"tampered manifest: {n_warn} warning(s), {len(mism)} event(s), AOT buckets "
              f"{tampered.cache_info()['aot_buckets']}")
        for n, x in rows.items():
            got, want = tampered.evaluate(25, x), eager.evaluate(25, x)
            check(all(np.array_equal(a, b) for a, b in zip(got, want) if a is not None),
                  f"tampered fallback bits at {n} rows")
        # three serve/aot_dispatch faults demote one bucket, the bits unchanged
        aot = HedgeEngine(aot_policy)
        check(aot.cache_info()["aot_buckets"] == want_buckets, "the parent's AOT engine")
        x8 = rows[1]
        want8 = eager.evaluate(7, x8)
        with faults(FaultPlan(fail={"serve/aot_dispatch": 3})), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                got = aot.evaluate(7, x8)
                check(all(np.array_equal(a, b) for a, b in zip(got, want8) if a is not None),
                      "a failed replay serves the eager bits")
        info = aot.cache_info()
        check(info["aot_circuit_open"] == [8] and 8 not in info["aot_buckets"]
              and sum("circuit opened" in str(w.message) for w in caught) == 1,
              f"three aot_dispatch faults demote bucket 8 ({info})")
        got = aot.evaluate(7, x8)
        check(all(np.array_equal(a, b) for a, b in zip(got, want8) if a is not None),
              "the demoted bucket serves the eager bits")
        # an AOT tenant through ServeHost, evicted to warm by another and
        # re-activated: no nvcc run, no graph capture (its resident params keep
        # their graphs), AOT hits, the eager bits
        from orp_tpu_torch.serve.host import ServeHost

        x1k = rows[1000]
        want1k = eager.evaluate(25, x1k)
        with ServeHost(max_live_engines=1) as host:
            for name in ("a", "b"):
                host.add_tenant(name, str(bdir))
            host.evaluate("a", 25, x1k)
            host.evaluate("b", 25, x1k)  # evicts "a" to warm
            check(host.stats()["a"]["live"] is False, "tenant a evicted to warm")
            b0 = dict(cuda_build.BUILD_STATS)
            t1 = time.perf_counter()
            got = host.evaluate("a", 25, x1k)
            warm_ms = (time.perf_counter() - t1) * 1e3
            builds = {k: cuda_build.BUILD_STATS[k] - b0[k] for k in ("nvcc", "captures")}
            info = host._tenants["a"].engine.cache_info()
        check(builds == {"nvcc": 0, "captures": 0} and info["aot_hits"] == 1
              and info["aot_buckets"] == want_buckets,
              f"the warm re-activation of an AOT tenant: {builds}, {info}")
        check(all(np.array_equal(a, b) for a, b in zip(got, want1k) if a is not None),
              "the re-activated AOT tenant serves the eager bits")
        out["aot_warm_ms"] = warm_ms
        # graph replay against the eager engine, in turns
        fresh = HedgeEngine(aot_policy)
        xr, xb = rows[1], rows[N_FULL]
        lat_aot, lat_eager = _turns(lambda: fresh.evaluate(3, xr), lambda: eager.evaluate(3, xr),
                                    31)
        big_aot, big_eager = _turns(lambda: fresh.evaluate(3, xb), lambda: eager.evaluate(3, xb),
                                    5)
        check(all(np.array_equal(a, b) for a, b in zip(fresh.evaluate(3, xb),
                                                        eager.evaluate(3, xb))
                  if a is not None), "1M-row replay bitwise the eager engine")
        out.update(export_s=export_s, aot_wall_s=ser["wall_s"], lat_aot_ms=lat_aot,
                   lat_eager_ms=lat_eager, rps_aot=N_FULL / (big_aot / 1e3),
                   rps_eager=N_FULL / (big_eager / 1e3), aot_captures=ser["captures"],
                   export_buckets=len(want_buckets))
        print(f"[aot] export_aot of {len(want_buckets)} buckets ({want_buckets[0]} to "
              f"{want_buckets[-1]} rows) at f32 and bf16 {export_s:.2f} s; a fresh process on "
              f"an empty cache: 0 nvcc runs, {ser['captures']} graphs captured, "
              f"{sum(t['aot_hits'] for t in ser['tiers'].values())} AOT hits of as many "
              f"requests, every bucket at dates {AOT_DATES} at f32 and bf16 bitwise the eager "
              f"engine; engine + first mixed and bucketed requests {ser['wall_s']:.2f} s; a "
              f"tampered device_kind: 1 warning, 1 aot/fingerprint_mismatch, eager bits; 3 "
              f"serve/aot_dispatch faults demote bucket 8, bits unchanged; a ServeHost AOT "
              f"tenant's warm re-activation + 1000-row request {warm_ms:.3f} ms, 0 nvcc runs, "
              f"0 graph captures, bitwise | {card}", flush=True)
        print(f"[aot] graph replay vs eager, in turns: 1-row latency {lat_aot:.3f} ms vs "
              f"{lat_eager:.3f} ms (median of 31); {N_FULL}-row request "
              f"{out['rps_aot']:,.0f} vs {out['rps_eager']:,.0f} rows/s (median of 5) | {card}",
              flush=True)

        # -- [perf] ----------------------------------------------------------------
        t0 = time.perf_counter()
        guarded = [HERE / "PERF_LEDGER.jsonl", HERE / "BENCH_serve.json"]
        before = [_sha(p) for p in guarded]
        led = root / "ledger.jsonl"
        gates = [perf.gate_cli(ledger=led, bundle=policy, repeats=5, evals=PERF_GATE_EVALS,
                               rows=64) for _ in range(2)]
        check(gates[0]["verdict"] == "no_history" and gates[1]["verdict"] == "ok"
              and all(g["appended"] for g in gates), f"gate: {[g['reason'] for g in gates]}")
        recs, _ = perf.read_ledger(led)
        meds = sorted(r["median"] for r in recs)
        scale = max(max(r["iqr"] for r in recs), meds[-1] - meds[0])
        need_s = 4.0 * max(perf.GATE_K * scale, perf.GATE_REL_FLOOR * meds[-1])
        delay_s = max(0.001, need_s / PERF_GATE_EVALS)
        with faults(FaultPlan(delay={"serve/dispatch": (100_000, delay_s)})):
            slow = perf.gate_cli(ledger=led, bundle=policy, repeats=5, evals=PERF_GATE_EVALS,
                                 rows=64)
        check(slow["verdict"] == "regression" and not slow["appended"],
              f"a serve/dispatch delay of {delay_s * 1e3:.2f} ms trips: {slow['reason']}")
        check([_sha(p) for p in guarded] == before,
              "the repo root's PERF_LEDGER.jsonl and BENCH_serve.json unchanged")
        model = policy.model
        gen = torch.Generator(device=dev).manual_seed(5)
        dates = torch.randint(0, policy.n_dates, (N_FULL,), device=dev, generator=gen,
                              dtype=torch.int32)
        feats = 1.0 + 0.1 * torch.randn(N_FULL, 1, device=dev, generator=gen)
        p1 = {k: v.to(dev) for k, v in policy.backward.params1_by_date.items()}
        packed = megakernel.pack_head_params(model, p1)
        k2_ms = cuda_ms(lambda: megakernel.mixed_head_forward(model, p1, dates, feats,
                                                              packed=packed), reps=50)
        k2_cost = aot.program_cost(N_FULL)
        rl_k2 = perf.roofline(k2_cost["flops"], k2_cost["bytes_accessed"] + 4 * N_FULL,
                              k2_ms / 1e3)
        with devprof.profiling() as prof:
            for i in range(40):
                eager.evaluate(i % policy.n_dates, rows[1000])
            med = prof.bucket_stats()["1024"]["device_s_median"]
        cost = eager.program_cost(1000)
        rl_head = perf.roofline(cost["flops"], cost["bytes_accessed"], med)
        for what, rl in (("K2 1M-row block", rl_k2), ("engine bucket 1024", rl_head)):
            check(rl["peak_source"] == "table" and rl["frac_peak_flops"] <= 1.0
                  and rl["frac_peak_bytes"] <= 1.0, f"{what} roofline {rl}")
        out.update(gate_medians=[g["record"]["median"] for g in gates],
                   slow_median=slow["record"]["median"], k2_roofline=rl_k2,
                   head_roofline=rl_head)
        print(f"[perf] gate_cli twice: {gates[0]['verdict']} then {gates[1]['verdict']} "
              f"(medians {gates[0]['record']['median']:.6f} / {gates[1]['record']['median']:.6f}"
              f" s for {PERF_GATE_EVALS} x 64 rows); a {delay_s * 1e3:.3f} ms serve/dispatch "
              f"delay: "
              f"{slow['verdict']} ({slow['record']['median']:.6f} s); ledger in a temporary "
              f"directory, the root's PERF_LEDGER.jsonl and BENCH_serve.json unchanged; "
              f"roofline K2 1M rows {k2_ms:.4f} ms: {rl_k2['frac_peak_flops']:.3e} of the f32 "
              f"peak, {rl_k2['frac_peak_bytes']:.3e} of HBM; engine bucket 1024 "
              f"{med * 1e3:.4f} ms device: {rl_head['frac_peak_flops']:.3e} / "
              f"{rl_head['frac_peak_bytes']:.3e}; {time.perf_counter() - t0:.2f} s | {card}",
              flush=True)

        # -- [profile] -------------------------------------------------------------
        t0 = time.perf_counter()
        counts.reset()
        prof_ns = devprof.profile_north_star(20)
        out["profile_k1"] = counts.only("fused_gbm", "profile_north_star(20)")
        check(out["profile_k1"] == 1, f"the sim stage launches K1 once ({out['profile_k1']})")
        for name, st in prof_ns["stages"].items():
            rl = st.get("roofline")
            # on the execute wall: a FLOP count too high must fail here, not move
            # the stage onto a longer basis
            check(rl is None or (rl["peak_source"] == "table" and rl["frac_peak_flops"] <= 1.0
                                 and rl["basis"] == "execute_wall"),
                  f"stage {name} roofline {rl}")
            frac = "" if rl is None else (f", {rl['frac_peak_flops']:.4e} of peak on "
                                          f"{rl['basis']}")
            print(f"[profile] north star 2^20: {name:9s} wall {st['wall_s']:.3f} s, compile "
                  f"{st['compile_s']:.3f} s, execute {st['execute_wall_s']:.3f} s, host "
                  f"{st['host_s']:.3f} s, device wait {st['device_wait_s']:.3f} s{frac}",
                  flush=True)
        prof_serve = devprof.profile_serve(str(bdir), n_requests=200)
        rl = prof_serve["roofline"]
        check(prof_serve["buckets"] and rl is not None and "error" not in rl
              and rl["peak_source"] == "table" and rl["frac_peak_flops"] <= 1.0,
              f"profile_serve roofline {rl}")
        check(prof_serve["aot_buckets"] == want_buckets, "profile_serve served from the graphs")
        out.update(profile=prof_ns, profile_serve=prof_serve)
        print(f"[profile] profile_serve of the AOT bundle (200 requests of 1/7/64/1000 rows): "
              + ", ".join(f"bucket {k}: {v['count']} x {v['device_s_median'] * 1e3:.4f} ms "
                          f"device, {v['queue_s_median'] * 1e3:.4f} ms queued"
                          for k, v in sorted(prof_serve["buckets"].items(), key=lambda kv:
                                             int(kv[0])))
              + f"; device utilization {prof_serve['device_utilization']:.4f}; bucket "
              f"{rl['bucket']} {rl['frac_peak_flops']:.3e} of the f32 peak; "
              f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)

        # -- [degrade] ---------------------------------------------------------------
        t0 = time.perf_counter()
        drill = bench._degrade_drill(aot_policy, degrade_at=5, n_requests=32, survivors=None,
                                     mesh=None, seed=0)
        check(drill["failed_during_window"] == 0 and drill["replayed"] >= 1
              and drill["post_recovery_bitwise_equal"] and drill["rebuild_xla_compiles"] == 0
              and drill["aot_buckets"] == want_buckets, f"degrade drill {drill}")
        out["degrade"] = drill
        print(f"[degrade] device loss at request 5 of 32 on one card, from the AOT bundle: "
              f"MTTR {drill['mttr_ms']:.3f} ms (drain, rebuild with 0 nvcc runs and "
              f"{drill['rebuild_graph_captures']} graph captures, replay), "
              f"{drill['replayed']} replayed, 0 failed, the recovered engine bitwise; "
              f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)

        # -- [serve-bench] ---------------------------------------------------------
        t0 = time.perf_counter()
        small = export_bundle(european_hedge(
            EuropeanConfig(), SimConfig(n_paths=512, T=1.0, dt=1 / 8, rebalance_every=2),
            TrainConfig(dual_mode="mse_only", epochs_first=20, epochs_warm=10)),
            root / "small")
        counts.reset()
        rec = bench.serve_bench(small, prewarm=True, sweep_concurrency=(1, 4, 16),
                                degrade_at=10, degrade_requests=64, ingest=True,
                                precision=True, density=True, density_tenants=100, repeats=3)
        got = counts.read()
        check(got["mixed_head"] >= 1 and got["mixed_head_bf16"] >= 1
              and all(v == 0 for k, v in got.items()
                      if k not in ("mixed_head", "mixed_head_bf16")),
              f"serve_bench's megakernel phase launches K2 and no other kernel ({got})")
        mk = next(lv for lv in rec["megakernel"]["tiers"] if lv["tier"] == "f32")
        check(rec["degrade"]["failed_during_window"] == 0
              and rec["degrade"]["post_recovery_bitwise_equal"], "serve_bench's degrade drill")
        check(rec["nvcc_runs_after_warmup"] == 0 and rec["graph_captures_after_warmup"] == 0
              and rec["cache_misses_after_warmup"] == 0, "the warm-up contract")
        path = root / "bench" / "serve_bench.json"
        path.parent.mkdir()
        bench.write_bench_record(rec, path)
        rows_ = bench.ledger_records(rec)
        check(rows_ and all(perf.validate_perf_record(r) == [] for r in rows_),
              "ledger_records validate")
        check([_sha(p) for p in guarded] == before, "no root record written")
        # K2 alone at the megakernel phase's shape, against its plain version
        sm, sp = small.model, {k: v.to(dev) for k, v in small.backward.params1_by_date.items()}
        gen = torch.Generator(device=dev).manual_seed(7)
        sd = torch.randint(0, small.n_dates, (mk["rows"],), device=dev, generator=gen,
                           dtype=torch.int32)
        sf = 1.0 + 0.1 * torch.randn(mk["rows"], sm.n_features, device=dev, generator=gen)
        k2_got = megakernel.mixed_head_forward(sm, sp, sd, sf,
                                               packed=megakernel.pack_head_params(sm, sp))
        k2_want = megakernel.mixed_head_plain(sm, sp, sd, sf)
        torch.testing.assert_close(k2_got, k2_want, rtol=1e-5, atol=1e-6)
        out.update(bench=rec, bench_k2=got["mixed_head"], bench_k2_err=max_err(k2_got, k2_want),
                   bench_k2_times=k2_times(dev, small, mk["rows"], 7, small=mk["rows"]))
        for lv in rec["sweep"]:
            print(f"[serve-bench] concurrency {lv['concurrency']:2d}: {lv['requests_per_s']:,.1f}"
                  f" req/s (IQR {lv['requests_per_s_iqr']:,.1f}), p99 {lv['p99_ms']:.3f} ms, "
                  f"{lv['dispatches_per_request']:.4f} dispatches a request | {card}",
                  flush=True)
        print(f"[serve-bench] engine {rec['value']:,.1f} req/s, p99 {rec['p99_ms']:.3f} ms; "
              f"degrade MTTR {rec['mttr_ms']:.3f} ms; ingest {rec['ingest_rows_per_s']:,.0f} "
              f"rows/s, overheads trace {rec['trace_overhead_pct']:.2f}% drift "
              f"{rec['drift_overhead_pct']:.2f}% profile {rec['profile_overhead_pct']:.2f}%; "
              f"precision rows/s "
              + ", ".join(f"{k} {v:,.0f}" for k, v in rec["precision_rows_per_s"].items())
              + f"; megakernel speedup "
              f"{rec['megakernel_speedup']} (K2 launches {got['mixed_head']} f32+int8, "
              f"{got['mixed_head_bf16']} bf16); ragged saves {rec['pad_waste_saved_rows']} "
              f"rows; density {rec['density_tenants']} tenants, dedup "
              f"{rec['density_dedup_ratio']}, cold p99 {rec['density_cold_p99_ms']} ms; "
              f"{len(rows_)} ledger rows valid; {time.perf_counter() - t0:.2f} s | {card}",
              flush=True)
        if beside is not None:
            out["beside"] = beside()
        # the background children, joined last: the cold start, then the warmed walk
        cold = _aot_result(background[0][1], "the cold-start process", timeout=900)
        warm = _aot_result(background[1][1], "warm_fused_walk's process", timeout=900)
        walk = _aot_result(_aot_child("walk", root / "cache_walk", "--paths", AOT_WALK_PATHS),
                           "the warmed fused north star")
        background.clear()
        check(warm["nvcc_runs"] >= 1 and walk["nvcc"] == 0,
              f"warm_fused_walk built {warm['nvcc_runs']}, the fresh walk ran nvcc "
              f"{walk['nvcc']} time(s)")
        check(cold["nvcc"] >= 1, "the cold engine built its library")
        out.update(cold_s=cold["wall_s"], cold_nvcc_s=cold["nvcc_s"], warm=warm, walk=walk)
        print(f"[aot] cold start, empty cache and no AOT set (engine + first mixed-date and "
              f"bucketed requests): {cold['wall_s']:.2f} s ({cold['nvcc']} nvcc run(s), "
              f"{cold['nvcc_s']:.2f} s) vs {ser['wall_s']:.2f} s from the AOT bundle (0 nvcc); "
              f"warm_fused_walk into an empty cache {warm['lower_wall_s']:.2f} s of nvcc + "
              f"{warm['compile_wall_s']:.3f} s of captures ({warm['captures']}), then a fresh "
              f"fused north star at {AOT_WALK_PATHS} paths {walk['wall_s']:.2f} s with 0 nvcc "
              f"runs (v0_acv {walk['v0_acv']:.4f}) | {card}", flush=True)
    finally:
        for _, proc in background:
            _stop(proc)
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    with_beside = (f" (with the phase run beside its builds, {out['beside']['phase_s']:.2f} s)"
                   if isinstance(out.get("beside"), dict) and "phase_s" in out["beside"] else "")
    print(f"[aot-plane] the phases {out['phase_s']:.2f} s{with_beside} | {card}", flush=True)
    return out


PILOT_CALM = dict(a=4.0, b=0.15, c=0.2, mu=0.08, sigma0=0.15)  # serve/bench._pilot_phase's
PILOT_SHIFT = dict(a=4.0, b=0.45, c=0.3, mu=0.08, sigma0=0.4)  # regimes: b 0.15 -> 0.45
PILOT_BUCKETS = (8, 4096)     # the candidates' AOT sets: a 4,096-row block's bucket and 1 row's
PILOT_BLOCK_ROWS = 4096       # the submitter's per-date blocks
PILOT_MIXED_ROWS = 64         # and its mixed-date single rows (K2), each iteration
PILOT_PATHS = N_FULL
PILOT_PACE_S = 0.02           # the submitter's pause between iterations (the GIL's share)
PILOT_REPLICATES = 2          # the quality gate's RQMC replicates (the bundle's spec has 8)


def _pilot_traffic(host, name: str, n_dates: int, stop, log: list, errors: list) -> None:
    """The submitter: per-date blocks and mixed-date single rows, each
    iteration's results read before the next (bounded backpressure)."""
    import numpy as np

    i = 0
    try:
        while not stop.is_set():
            d = i % n_dates
            s, p = _host_rows(PILOT_BLOCK_ROWS, 1, 1000 + i % 7)
            block = host.submit_block(name, d, s, p)
            ms, mp = _host_rows(PILOT_MIXED_ROWS, 1, 2000 + i % 7)
            dates = (np.arange(PILOT_MIXED_ROWS) * 7 + i) % n_dates
            singles = [host.submit(name, int(dates[j]), ms[j:j + 1], mp[j:j + 1])
                       for j in range(PILOT_MIXED_ROWS)]
            log.append(("block", d, s, p, block.result(timeout=600)))
            log.append(("mixed", dates, ms, mp, [f.result(timeout=600) for f in singles]))
            i += 1
            stop.wait(PILOT_PACE_S)
    except Exception as e:  # orp: noqa[ORP009] -- re-raised on the phase's thread after the join
        errors.append(e)


def _pilot_stages(records, cycle: int) -> dict:
    """Seconds from each journaled state of ``cycle`` to the next (the
    journal's own ``ts_unix`` stamps)."""
    recs = [r for r in records if r.get("kind") == "transition" and r.get("cycle") == cycle]
    return {a["state"]: round(b["ts_unix"] - a["ts_unix"], 3) for a, b in zip(recs, recs[1:])}


def _pilot_served(log: list, engines: dict) -> dict:
    """Each served row bitwise one of the tenant's engines (the incumbent
    before the swap, the candidate after), per row; rows submitted vs served."""
    import numpy as np

    out = {"submitted": 0, "served": 0, "rows": {k: 0 for k in engines}, "order": []}
    for kind, d, s, p, res in log:
        if kind == "block":
            got = (res.phi, res.psi, res.value)
            n = res.n_served
            wants = {k: e.evaluate(d, s, p) for k, e in engines.items()}
        else:
            got = tuple(np.concatenate([r[j] for r in res]) for j in range(3))
            n = len(res)
            wants = {k: e.evaluate_mixed_async(d, s, p).result() for k, e in engines.items()}
        out["submitted"] += len(s)
        out["served"] += n
        owner = np.full(len(s), "", dtype=object)
        for k, w in wants.items():
            same = np.ones(len(s), bool)
            for g, x in zip(got, w):
                same &= (np.asarray(g).reshape(len(s), -1) == np.asarray(x).reshape(len(s), -1)
                         ).all(axis=1)
            owner[(owner == "") & same] = k
        check(bool((owner != "").all()), f"[pilot] every served {kind} row bitwise one of the "
              f"tenant's engines ({int((owner == '').sum())} of {len(s)} rows match neither)")
        for k in engines:
            out["rows"][k] += int((owner == k).sum())
        out["order"].append("candidate" if (owner == "candidate").any() else "incumbent")
    seen = "".join("c" if o == "candidate" else "i" for o in out["order"])
    check("ci" not in seen, f"[pilot] no incumbent bits after the first candidate bits ({seen})")
    return out


def pilot_phases(dev, counts, incumbent_dir) -> dict:
    """[pilot]: the closed loop (``orp_tpu_torch/pilot``) on the card, four parts:

    (a) the reference's drill, ``serve_bench(pilot=True)`` at its own size
        (512 paths, ``dt=1/8``, ``rebalance_every=2``, ``calib_window=160``):
        verdicts reject, promote, promote; 0 rows lost; the kill-resumed
        policy bitwise; the reject left the incumbent; the chain verifies;
    (b) a full-width cycle on the north-star policy of phase 9 (1,048,576
        paths x 364 steps, 52 dates, GN 30 + 51 x 10, exported with its
        calm-regime calibration baked and an AOT set of ``PILOT_BUCKETS``):
        the shifted market fires a calibration trigger, the warm-started
        checkpointed retrain launches K1 once, the candidate (exported with
        its own AOT set) is promoted through ``reload_tenant(quality_band=
        0.25)``, the gate replaying the incumbent's validation set at
        ``PILOT_REPLICATES`` replicates, while a submitter sends per-date
        blocks and mixed-date single rows (K2) — 0 rows lost, every row
        bitwise the engine that served it;
        then a manual cycle killed after step 1 and resumed by a fresh
        controller, its promoted params bitwise an uninterrupted run's.
        ``CompileAudit`` budgets the retrains (``watch_backward_walk``) and
        each promotion's serving engine (``watch_serve_engine``: one capture
        a bucket, none once it serves); the eager fallbacks of bucket
        captures (``aot/bundle_exec.FALLBACKS``) are counted and printed;
    (c) ``doctor_report`` on the promoted bundle, the pilot's journal, a
        temporary perf ledger and the quality probe: ``ok``, ``perf_peaks``
        covered by the H100 row; a torn journal middle fails
        ``pilot_journal`` in flag-speak;
    (d) K1 and K2 at this path's shapes against their plain versions.

    On the CPU (a rehearsal) no AOT set is exported: CUDA graphs need the card."""
    import dataclasses
    import shutil
    import tempfile
    import threading
    import warnings

    import numpy as np
    import torch

    from orp_tpu_torch import guard
    from orp_tpu_torch.aot import bundle_exec, export_aot
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.lint import CompileAudit, watch_backward_walk, watch_serve_engine
    from orp_tpu_torch.obs import perf
    from orp_tpu_torch.obs.manifest import chain_verify, read_chain
    from orp_tpu_torch.pilot import (PilotConfig, PilotController, TriggerHub, bake_calibration,
                                     calibrate_window, journal_append, read_journal,
                                     warm_params)
    from orp_tpu_torch.pilot.controller import _window_from_meta
    from orp_tpu_torch.qmc import fused_gbm
    from orp_tpu_torch.serve import HedgeEngine, ServeHost, load_bundle, megakernel
    from orp_tpu_torch.serve.bench import _pilot_market, serve_bench
    from orp_tpu_torch.serve.health import doctor_report
    from orp_tpu_torch.utils.measure import cuda_ms

    t_phase = time.perf_counter()
    out = {}
    aot = dev.type == "cuda"
    fb0 = dict(bundle_exec.FALLBACKS)
    root = pathlib.Path(tempfile.mkdtemp(prefix="orp-pilot-"))
    card = card_line()

    # -- (a) the reference's drill -------------------------------------------
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the drill's reject warns by design
        rec = serve_bench(load_bundle(incumbent_dir), n_requests=8, batch_sizes=(1,),
                          batcher_requests=4, sweep_concurrency=(), pilot=True, repeats=1,
                          device=dev)
    pl = rec["pilot"]
    out["drill_s"] = time.perf_counter() - t0
    verdicts = pl["chain"]["verdicts"]
    check(verdicts == ["reject", "promote", "promote"] and pl["rows_lost"] == 0
          and pl["resume"]["bits_equal"] and pl["reject_left_incumbent"] and pl["chain"]["ok"],
          f"[pilot] (a) the drill: verdicts {verdicts}, rows_lost {pl['rows_lost']}, resume "
          f"bitwise {pl['resume']['bits_equal']}, reject left the incumbent "
          f"{pl['reject_left_incumbent']}, chain ok {pl['chain']['ok']}")
    print(f"[pilot] (a) serve_bench(pilot=True) at {pl['n_paths']} paths x {pl['n_dates']} "
          f"dates: verdicts {verdicts}; rows {pl['rows_served']:,} of {pl['rows_submitted']:,} "
          f"served through the swap (0 lost); resume bitwise; calibrated b {pl['baseline_b']} -> "
          f"{pl['shifted_b']}; time to promote {pl['time_to_promote_s']:.3f} s; drift trips "
          f"{pl['drift_trips']}, debounced {pl['debounced']}; the drill {out['drill_s']:.2f} s "
          f"| {card}", flush=True)

    # -- (b) a full-width cycle on the north star ----------------------------
    inc = root / "incumbent"
    shutil.copytree(incumbent_dir, inc)
    inc_policy = load_bundle(inc)
    n_dates = inc_policy.n_dates
    if aot:
        export_aot(inc, inc_policy, buckets=PILOT_BUCKETS)
    calm = _pilot_market(240, seed=0, **PILOT_CALM)
    calm_win = calibrate_window(calm[-160:], vol_window=40, n_boot=32, seed=0)
    bake_calibration(inc, calm_win)
    shifted = _pilot_market(176, seed=1, **PILOT_SHIFT)
    prices_csv = root / "prices.csv"
    prices_csv.write_text("\n".join(repr(float(x)) for x in shifted) + "\n")
    sim = SimConfig(n_paths=PILOT_PATHS, T=1.0, dt=1 / N_STEPS, rebalance_every=STORE,
                    engine="pallas")
    euro = EuropeanConfig(constrain_self_financing=False)
    base = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    walk_audit = watch_backward_walk(CompileAudit())
    walk_deltas = []

    def train_fn(window, warm, ckpt_dir):
        with walk_audit:
            res = european_hedge(dataclasses.replace(euro, sigma=float(window.fit.sigma0)), sim,
                                 dataclasses.replace(base, checkpoint_dir=ckpt_dir),
                                 warm_start=warm, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        walk_deltas.append(walk_audit.deltas())
        return res

    clk = [0.0]  # the hub's cooldown clock: the phase never sleeps
    hub = TriggerHub("north-star", cooldown=guard.Cooldown(cooldown_s=60.0, backoff=2.0,
                                                           clock=lambda: clk[0]))
    cfg = PilotConfig(tenant="north-star", workdir=str(root / "pilot"), quality_band=0.25,
                      vol_window=40, calib_window=160, n_boot=32, boot_seed=0,
                      cooldown_s=60.0, aot=aot, aot_buckets=PILOT_BUCKETS,
                      prices_path=str(prices_csv), events_dir=str(root))
    host = ServeHost(promotion_chain=root / "promotions.jsonl",
                     engine_kwargs={"device": dev},
                     batcher_kwargs={"mixed_dates": True, "coalesce_blocks": True})
    serve_audit = watch_serve_engine(CompileAudit(), budget=len(PILOT_BUCKETS) if aot else 0)
    reload_deltas = []
    orig_reload = host.reload_tenant
    stop, log, errors = threading.Event(), [], []
    traffic = threading.Thread(target=_pilot_traffic,
                               args=(host, "north-star", n_dates, stop, log, errors), daemon=True)

    def audited_reload(*a, **k):  # each promotion's engine: one capture a bucket
        if not traffic.is_alive() and not stop.is_set():
            traffic.start()  # the first promotion runs under the submitter's traffic
            while len(log) < 4 and traffic.is_alive():  # served by the incumbent first
                time.sleep(0.005)
        with serve_audit:
            v = orig_reload(*a, **k)
        reload_deltas.append(serve_audit.deltas()["serve_bucket"])
        return v

    host.reload_tenant = audited_reload
    try:
        host.add_tenant("north-star", inc)
        host.evaluate("north-star", 0, *_host_rows(8, 1, 0))  # activated before the cycle
        # the gate's validation set: the incumbent's pinned spec at fewer
        # replicates (a cut of depth: each replicate is a 364-step scan of 2,048
        # paths, and a promotion replays the set on both engines)
        spec = dataclasses.replace(inc_policy.validation, replicates=PILOT_REPLICATES)
        ctl = PilotController(host, cfg, train_fn, hub=hub, validation=spec)
        v0 = host.stats()["north-star"]["version"]
        evs = [e for e in ctl.poll(calibration_prices=shifted) if e.source == "calibration"]
        check(bool(evs) and hub.accept(evs[0]),  # orp: noqa[ORP014] -- the debounce door, not a socket
              "[pilot] (b) the shifted market fires a calibration trigger through the hub")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts.reset()
        t0 = time.perf_counter()
        try:
            out_b = ctl.run_cycle(evs[0], shifted)
            out["cycle_s"] = time.perf_counter() - t0
            n_after = len(log) + 4
            while len(log) < n_after and traffic.is_alive():  # traffic on the promoted engine
                time.sleep(0.005)
        finally:
            stop.set()
            if traffic.is_alive():
                traffic.join(timeout=600)
        check(not traffic.is_alive() and not errors and len(log) >= 8,
              f"[pilot] (b) the submitter ran clean through the swap ({len(log)} results, "
              f"{errors})")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got = counts.read()
        out["k1_launches"], out["k2_launches"] = got["fused_gbm"], got["mixed_head"]
        check(got["fused_gbm"] == 1 and got["mixed_head"] >= 1
              and all(v == 0 for k, v in got.items() if k not in ("fused_gbm", "mixed_head")),
              f"[pilot] (b) the cycle: K1 once (the retrain), K2 on the mixed-date lane, no "
              f"other kernel ({got})")
        check(out_b["outcome"] == "promoted" and host.stats()["north-star"]["version"] == v0 + 1,
              f"[pilot] (b) the calibration cycle promoted ({out_b['outcome']})")
        candidate = pathlib.Path(out_b["candidate"])
        engines = {"incumbent": HedgeEngine(load_bundle(inc), device=dev),
                   "candidate": HedgeEngine(load_bundle(candidate), device=dev)}
        served = _pilot_served(log, engines)
        out["rows_lost"] = served["submitted"] - served["served"]
        check(out["rows_lost"] == 0 and served["rows"]["incumbent"] > 0
              and served["rows"]["candidate"] > 0,
              f"[pilot] (b) rows_lost 0 through the swap ({served['served']:,} of "
              f"{served['submitted']:,}; {served['rows']['incumbent']:,} rows on the incumbent, "
              f"{served['rows']['candidate']:,} on the candidate, each bitwise its engine)")
        shifted_b = calibrate_window(shifted[-160:], vol_window=40, n_boot=32,
                                     seed=0).fit.params.b
        print(f"[pilot] (b) calibration cycle at {PILOT_PATHS:,} paths x {N_STEPS} steps: b "
              f"{calm_win.fit.params.b:.4f} -> {shifted_b:.4f}, promoted version "
              f"{host.stats()['north-star']['version']}; time to promote "
              f"{out_b['elapsed_s']:.3f} s (the cycle {out['cycle_s']:.3f} s); K1 "
              f"{out['k1_launches']}, K2 {out['k2_launches']} launch(es); rows "
              f"{served['served']:,} of {served['submitted']:,} served, bitwise | {card}",
              flush=True)
        out["time_to_promote_s"] = out_b["elapsed_s"]

        # the manual cycle: killed after step 1, resumed by a fresh controller
        journal_append(ctl.journal_path, {"kind": "trigger_request", "source": "manual",
                                          "tenant": "north-star", "reason": "smoke: manual"})
        clk[0] += 10_000.0
        man = [e for e in ctl.poll() if e.source == "manual"]
        check(bool(man) and hub.accept(man[0]),  # orp: noqa[ORP014] -- the debounce door, not a socket
              "[pilot] (b) the journaled manual request surfaces as a trigger")
        killed = False
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the kill warns by design
            try:
                with guard.faults(guard.FaultPlan(kill_after_step=1)):
                    ctl.run_cycle(man[0], shifted)
            except guard.WalkKilled:
                killed = True
        check(killed, "[pilot] (b) the manual cycle's retrain was killed after step 1")
        t0 = time.perf_counter()
        out_c = PilotController(host, cfg, train_fn, hub=hub, validation=spec).resume()
        out["resume_s"] = time.perf_counter() - t0
        recs, problems = read_journal(ctl.journal_path)
        train_rec = [r for r in recs if r.get("kind") == "transition"
                     and r.get("cycle") == out_c["cycle"] and r.get("state") == "training"][-1]
        ref = train_fn(_window_from_meta(train_rec["calibration"]),
                       warm_params(load_bundle(train_rec["incumbent"])), None)
        promoted = load_bundle(out_c["candidate"])
        want, have = ref.backward.params1_by_date, promoted.backward.params1_by_date
        bits = sorted(want) == sorted(have) and all(
            torch.equal(want[k].cpu(), have[k].cpu()) for k in want)
        check(out_c["outcome"] == "promoted" and bits and not problems,
              f"[pilot] (b) resumed cycle {out_c['cycle']}: {out_c['outcome']}, the promoted "
              f"params bitwise an uninterrupted run's ({bits})")
        cv = chain_verify(root / "promotions.jsonl")
        verdicts = [r.get("action") for r in read_chain(root / "promotions.jsonl")]
        check(cv["ok"] and verdicts == ["promote", "promote"],
              f"[pilot] (b) the chain verifies: {verdicts}")
        check(all(d["fit_epoch"] == 0 and d["gn_iteration"] <= 2 and d["nvcc"] <= 1
                  for d in walk_deltas) and len(walk_deltas) >= 3,
              f"[pilot] (b) CompileAudit: the walks' captures and builds within budget "
              f"({walk_deltas})")
        check(all(x <= serve_audit.report()["budgets"]["serve_bucket"] for x in reload_deltas),
              f"[pilot] (b) CompileAudit: each promotion's engine at most one capture a bucket "
              f"({reload_deltas})")
        out["stages"] = {c: _pilot_stages(recs, c) for c in (out_b["cycle"], out_c["cycle"])}
        out["capture_fallbacks"] = bundle_exec.FALLBACKS["capture"] - fb0["capture"]
        out["set_fallbacks"] = bundle_exec.FALLBACKS["set"] - fb0["set"]
        print(f"[pilot] (b) manual cycle killed after step 1, resumed by a fresh controller "
              f"in {out['resume_s']:.3f} s: promoted, bitwise an uninterrupted run; chain "
              f"{verdicts}; journaled stage seconds {out['stages']}; CompileAudit walks "
              f"{walk_deltas}, promotions' bucket captures "
              f"{reload_deltas}; capture fallbacks {out['capture_fallbacks']} (set refusals "
              f"{out['set_fallbacks']}) | {card}", flush=True)

        # -- (c) doctor_report on the card ------------------------------------
        led = root / "ledger.jsonl"
        perf.ledger_append(led, perf.make_record("pilot", "cycle", [out["cycle_s"]]))
        t0 = time.perf_counter()
        rep = doctor_report(out_c["candidate"], perf=str(led), quality=out_c["candidate"],
                            pilot=ctl.journal_path, device=dev)
        out["doctor_s"] = time.perf_counter() - t0
        for c in rep["checks"]:
            print(f"[pilot] (c) doctor {c['check']}: {'ok' if c['ok'] else 'FAIL'} — "
                  f"{c['detail']}", flush=True)
        by = {c["check"]: c for c in rep["checks"]}
        check(rep["ok"] and "PEAK_TABLE covers" in by["perf_peaks"]["detail"],
              "[pilot] (c) doctor_report ok on the card, perf_peaks covered by the H100 row")
        torn = root / "torn.jsonl"
        torn.write_text("{broken\n" + pathlib.Path(ctl.journal_path).read_text())
        row = {c["check"]: c for c in doctor_report(pilot=torn, device=dev)["checks"]}[
            "pilot_journal"]
        check(not row["ok"] and "move the corrupt file aside" in row.get("fix", ""),
              f"[pilot] (c) a torn journal middle fails pilot_journal in flag-speak: "
              f"{row['detail']} / {row.get('fix')}")
        print(f"[pilot] (c) doctor_report {out['doctor_s']:.2f} s; torn middle: "
              f"{row.get('fix')} | {card}", flush=True)

        # -- (d) K1 and K2 at this path's shapes against their plain versions
        sigma = float(_window_from_meta(train_rec["calibration"]).fit.sigma0)
        kw = dict(s0=100.0, drift=0.08, sigma=sigma, dt=1.0 / N_STEPS, seed=OOS_SEED,
                  store_every=STORE, device=dev)
        k1 = fused_gbm.gbm_log_fused(PILOT_PATHS, N_STEPS, **kw)
        a, b = _events(dev)
        k1_plain = fused_gbm.gbm_log_plain(PILOT_PATHS, N_STEPS, **kw)
        out["k1_plain_ms"] = _elapsed(dev, a, b)
        out["k1_err"] = max_err(k1, k1_plain)
        check(bool(torch.allclose(k1, k1_plain, rtol=3e-5, atol=0.0)),
              f"[pilot] (d) K1 at sigma {sigma:.4f} within rtol 3e-5 of gbm_log_plain")
        del k1, k1_plain
        out["k1_ms"] = cuda_ms(lambda: fused_gbm.gbm_log_fused(PILOT_PATHS, N_STEPS, **kw),
                               reps=10)
        out["k1_bound"] = k1_bound_ms(PILOT_PATHS, N_STEPS, STORE)
        m = promoted.model
        p = {k: v.to(dev) for k, v in promoted.backward.params1_by_date.items()}
        d_t = torch.from_numpy((np.arange(PILOT_MIXED_ROWS) * 7 % n_dates).astype(np.int32)).to(dev)
        f_t = torch.from_numpy(_host_rows(PILOT_MIXED_ROWS, 1, 2000)[0]).to(dev)
        packed = megakernel.pack_head_params(m, p)
        kern = megakernel.mixed_head_forward(m, p, d_t, f_t, packed=packed)
        plain = megakernel.mixed_head_plain(m, p, d_t, f_t)
        out["k2_err"] = max_err(kern, plain)
        check(bool(torch.allclose(kern, plain, rtol=1e-5, atol=1e-6)),
              f"[pilot] (d) K2 on the promoted params at {PILOT_MIXED_ROWS} rows within rtol "
              "1e-5 of mixed_head_plain")
        out["k2_ms"] = cuda_ms(lambda: megakernel.mixed_head_forward(m, p, d_t, f_t,
                                                                     packed=packed), reps=200)
        out["k2_plain_ms"] = cuda_ms(lambda: megakernel.mixed_head_plain(m, p, d_t, f_t),
                                     reps=20)
        out["k2_bound"] = k2_bound_ms(m, PILOT_MIXED_ROWS, n_dates)
        print(f"[pilot] (d) K1 {out['k1_ms']:.4f} ms (max |kernel - plain| "
              f"{out['k1_err']:.2e}, plain {out['k1_plain_ms']:.2f} ms, bound "
              f"{out['k1_bound'][0]:.4f} ms by {out['k1_bound'][1]}); K2 {out['k2_ms']:.4f} ms "
              f"(max |kernel - plain| {out['k2_err']:.2e}, plain {out['k2_plain_ms']:.3f} ms, "
              f"bound {out['k2_bound'][0]:.6f} ms by {out['k2_bound'][1]}) | {card}", flush=True)
    finally:
        host.close()
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[pilot] the phase {out['phase_s']:.2f} s (the drill {out['drill_s']:.2f} s, the "
          f"full-width cycle {out['cycle_s']:.2f} s, the resume {out['resume_s']:.2f} s, "
          f"doctor {out['doctor_s']:.2f} s); capture fallbacks {out['capture_fallbacks']} "
          f"| {card}", flush=True)
    return out


CLI_FRAME_SIZES = (1, 4096, N_FULL)
CLI_MIXED_ROWS = 512
CLI_BUDGET_S = 30.0
CLI_ROOT_ARGS: list[str] = []  # root options before every command ([] = the card)


def _cli(argv: list[str]) -> list[str]:
    """``orp_tpu_torch.cli.main(argv)`` in this process; its standard output's lines."""
    import contextlib
    import io

    from orp_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*CLI_ROOT_ARGS, *argv])
    check(not rc, f"cli {argv[0]}: rc {rc}")
    return buf.getvalue().splitlines()


def cli_phases(dev, counts, euro_line: dict, euro_params: dict) -> dict:
    """[cli]: the command line (``orp_tpu_torch/cli.py``) on the card: ``euro``
    with phase 9's configs (bitwise its report, K1 twice), ``serve-gateway`` as
    a child process (replies bitwise this process's engine, ``top``,
    ``doctor``, the SIGTERM drain, ``trace``), ``export`` and ``serve-bench
    --quick --precision`` in process (K2 held against its plain version).
    ``euro_line`` is phase 9's report as the CLI's result line, ``euro_params``
    its per-date params (on the host)."""
    import os
    import signal
    import tempfile

    import numpy as np
    import torch

    from orp_tpu_torch import cli, obs
    from orp_tpu_torch.serve import HedgeEngine, ResilientGatewayClient, load_bundle, megakernel
    from orp_tpu_torch.utils import bs_call

    t_phase = time.perf_counter()
    out = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="orp-cli-"))
    bundle, tel, tel_gw = root / "bundle", root / "t", root / "t-gw"

    # -- 1. euro in process: phase 9's configs, bitwise its report
    argv = ["euro", "--paths", str(N_FULL), "--steps", str(N_STEPS), "--rebalance-every",
            str(STORE), "--unconstrained", "--engine", "pallas", "--optimizer", "gauss_newton",
            "--dual-mode", "mse_only", "--oos-seed", str(OOS_SEED), "--json", "--export-dir",
            str(bundle), "--telemetry", str(tel)]
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    lines = [json.loads(x) for x in _cli(argv)]
    torch.cuda.synchronize()
    out["euro_s"] = time.perf_counter() - t0
    got = counts.read()
    check(got["fused_gbm"] == 2 and all(v == 0 for k, v in got.items() if k != "fused_gbm"),
          f"[cli] euro launches K1 twice (training, oos_) and no other kernel ({got})")
    out["k1_launches"] = got["fused_gbm"]
    check(len(lines) == 2 and set(lines[1]) == {"oos_" + k for k in lines[0]},
          f"[cli] euro prints the in-sample and the oos_ line ({[sorted(x) for x in lines]})")
    check(lines[0] == euro_line, f"[cli] euro's line bitwise phase 9's report "
          f"({lines[0]} vs {euro_line})")
    bs, _ = bs_call(100.0, 100.0, 0.08, 0.15, 1.0)
    bp = (lines[0]["v0_acv"] - bs) / bs * 1e4
    oos_bp = (lines[1]["oos_v0_acv"] - bs) / bs * 1e4
    check(abs(bp) < 1.0 and abs(oos_bp) < 1.0,
          f"[cli] |v0_acv - BS| {bp:+.4f}bp, oos {oos_bp:+.4f}bp < 1bp")
    policy = load_bundle(bundle)
    exported = policy.backward.params1_by_date
    check(set(exported) == set(euro_params)
          and all(torch.equal(exported[k].cpu(), v) for k, v in euro_params.items()),
          "[cli] the exported per-date params bitwise phase 9's")
    rec = json.loads(_cli(["report", "--events", str(tel), "--json"])[-1])
    check(rec.get("n_dates") == 52 and len(rec.get("rungs", ())) == 52,
          f"[cli] report --events: 52 dates ({rec.get('n_dates')})")
    print(f"[cli] euro {N_FULL} x {N_STEPS} (--engine pallas --optimizer gauss_newton "
          f"--oos-seed {OOS_SEED} --export-dir --telemetry): the line bitwise [euro]'s, v0_acv "
          f"{bp:+.4f}bp, oos {oos_bp:+.4f}bp; K1 {got['fused_gbm']}; exported params bitwise; "
          f"report 52 dates; {out['euro_s']:.2f} s", flush=True)

    # -- 2. serve-gateway as a child process (started now: it loads beside step 3)
    ready = root / "gw.addr"
    env = {**os.environ, "PYTHONPATH": str(HERE)}
    t_spawn = time.time()  # the ready file's mtime is on this clock
    child = subprocess.Popen(
        [sys.executable, "-m", "orp_tpu_torch.cli", *CLI_ROOT_ARGS, "serve-gateway",
         "--bundle", str(bundle),
         "--port", "0", "--ready-file", str(ready), "--telemetry", str(tel_gw), "--json"],
        cwd=str(HERE), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    atexit.register(_stop, child)

    # -- 3. export + serve-bench --quick --precision in process (K2)
    small = root / "small"
    t0 = time.perf_counter()
    _cli(["export", "--pipeline", "euro", "--out", str(small), "--paths", "512", "--steps", "8",
          "--rebalance-every", "2", "--epochs-first", "20", "--epochs-warm", "10", "--json"])
    counts.reset()
    bench_out = root / "bench.json"
    brec = json.loads(_cli(["serve-bench", "--bundle", str(small), "--quick", "--precision",
                            "--out", str(bench_out), "--json"])[-1])
    got = counts.read()
    check(got["mixed_head"] >= 1 and all(v == 0 for k, v in got.items()
                                         if k not in ("mixed_head", "mixed_head_bf16")),
          f"[cli] serve-bench --precision launches K2 and no other kernel ({got})")
    check(bench_out.exists() and json.loads(bench_out.read_text())["megakernel"]
          == brec["megakernel"], "[cli] serve-bench wrote its record to --out")
    out["k2_launches"] = got["mixed_head"]
    mk = next(lv for lv in brec["megakernel"]["tiers"] if lv["tier"] == "f32")
    sp = load_bundle(small)
    sm = sp.model
    params = {k: v.to(dev) for k, v in sp.backward.params1_by_date.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    sd = torch.randint(0, sp.n_dates, (mk["rows"],), device=dev, generator=gen,
                       dtype=torch.int32)
    sf = 1.0 + 0.1 * torch.randn(mk["rows"], sm.n_features, device=dev, generator=gen)
    k2_got = megakernel.mixed_head_forward(sm, params, sd, sf,
                                           packed=megakernel.pack_head_params(sm, params))
    k2_want = megakernel.mixed_head_plain(sm, params, sd, sf)
    torch.testing.assert_close(k2_got, k2_want, rtol=1e-5, atol=1e-6)
    out["k2_err"] = max_err(k2_got, k2_want)
    out["k2_times"] = k2_times(dev, sp, mk["rows"], 11, small=mk["rows"])
    out["bench_s"] = time.perf_counter() - t0
    print(f"[cli] export (512 paths, Adam 20/10) + serve-bench --quick --precision: "
          f"megakernel speedup {brec['megakernel_speedup']}, K2 launches {got['mixed_head']} "
          f"f32+int8, {got['mixed_head_bf16']} bf16; K2 at {mk['rows']} rows "
          f"{out['k2_times']['f32']:.4f} ms (plain {out['k2_times']['f32_plain']:.3f} ms), "
          f"max|kernel - plain| {out['k2_err']:.2e}; {out['bench_s']:.2f} s", flush=True)

    # -- 2 (continued): the gateway's replies against this process's engine
    deadline = time.perf_counter() + 180
    while not ready.exists() and child.poll() is None and time.perf_counter() < deadline:
        time.sleep(0.01)
    if not ready.exists():
        _stop(child)
        check(False, f"[cli] serve-gateway never wrote its ready file (rc {child.returncode})"
              f"\n{child.stderr.read()[-3000:]}")
    out["gateway_ready_s"] = ready.stat().st_mtime - t_spawn
    addr, port = ready.read_text().split()
    target = f"{addr}:{port}"
    engine = HedgeEngine(policy, device=dev)
    nd = policy.n_dates
    sent = served = 0
    trace_id = obs.new_trace()
    with ResilientGatewayClient(addr, int(port), window=8, timeout_s=300.0) as c:
        for i, n in enumerate(CLI_FRAME_SIZES):
            states = _host_rows(n, 1, 300 + i)[0]
            d = (7 * i + 5) % nd
            want = engine.evaluate(d, states)
            r = c.submit_block("default", d, states,
                               trace=trace_id if n == 4096 else None)
            check(bool((r.status == 0).all()) and np.array_equal(r.phi, want[0])
                  and np.array_equal(r.psi, want[1]),
                  f"[cli] a {n}-row frame through serve-gateway bitwise the engine")
            sent, served = sent + n, served + int((r.status == 0).sum())
        rng = np.random.default_rng(17)
        dates = rng.integers(0, nd, CLI_MIXED_ROWS)
        states = _host_rows(CLI_MIXED_ROWS, 1, 400)[0]
        mixed_ok = True
        for j in range(CLI_MIXED_ROWS):
            row = states[j:j + 1]
            want = engine.evaluate(int(dates[j]), row)
            r = c.submit_block("default", int(dates[j]), row)
            mixed_ok &= bool(r.status[0] == 0 and r.phi[0] == want[0][0]
                             and r.psi[0] == want[1][0])
            sent, served = sent + 1, served + int(r.status[0] == 0)
        check(mixed_ok, f"[cli] {CLI_MIXED_ROWS} single rows at mixed dates bitwise the engine")
    snap = [json.loads(x) for x in _cli(["top", "--gateway", target, "--interval", "0.2",
                                         "--json"])]
    check(len(snap) == 1 and isinstance(snap[0], dict), f"[cli] top: one snapshot ({snap})")
    doc = json.loads(_cli(["doctor", "--bundle", str(bundle), "--gateway", target,
                           "--json"])[-1])
    check(doc["ok"], f"[cli] doctor --bundle --gateway ok ({doc})")
    child.send_signal(signal.SIGTERM)
    try:
        gw_out, gw_err = child.communicate(timeout=60)
    finally:
        _stop(child)
    check(child.returncode == 0, f"[cli] serve-gateway exits 0 on SIGTERM (rc "
          f"{child.returncode})\n{gw_err[-3000:]}")
    check(not ready.exists(), "[cli] the drain removed the ready file")
    check(sent == served, f"[cli] 0 rows lost ({served} of {sent} served)")
    tr = json.loads(_cli(["trace", obs.trace_hex(trace_id[0]), "--events", str(tel_gw),
                          "--json"])[-1])
    chain = [name.split("/")[-1] for name in tr.get("segments", {})]
    check(chain[:5] == ["decode", "queue", "dispatch", "resolve", "encode"],
          f"[cli] trace: the stamped frame's chain decode, queue, dispatch, resolve, encode "
          f"({chain})")
    out["rows_served"] = served
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[cli] serve-gateway child: ready {out['gateway_ready_s']:.2f} s after spawn; frames "
          f"of {', '.join(map(str, CLI_FRAME_SIZES))} rows and {CLI_MIXED_ROWS} single rows at "
          f"mixed dates bitwise the engine; top one snapshot; doctor ok; SIGTERM: rc 0, ready "
          f"file gone, {served:,} of {sent:,} rows served (0 lost); trace {' > '.join(chain)}",
          flush=True)
    # the budget is read, not gated: a slow host must not fail the run on a wall clock
    verdict = "within" if out["phase_s"] <= CLI_BUDGET_S else "OVER"
    print(f"[cli] the phase {out['phase_s']:.2f} s, {verdict} its {CLI_BUDGET_S:.0f} s budget | "
          f"{card_line()}", flush=True)
    return out


def _events(dev):
    """A started CUDA-event pair (None on the CPU, for a host-clock rehearsal)."""
    import torch

    if dev.type != "cuda":
        return None, time.perf_counter()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    return a, b


def _elapsed(dev, a, b) -> float:
    import torch

    if dev.type != "cuda":
        return (time.perf_counter() - b) * 1e3
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


#: [mesh] (b)'s depth: the gloo ranks' walk at GN 3 + 51 x 1 (first date, warm
#: dates) and their exact-thinning run at 50 of [exact]'s 1,000 steps
MESH_GLOO_ITERS = (3, 1)
MESH_GLOO_PENSION_STEPS = 50


def mesh_tool():
    """``tools/torch_mesh_ranks.py``, the launcher of one process a rank."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
                                                  HERE / "tools" / "torch_mesh_ranks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: [mesh] (b)'s degradation: a loss reporting 3 survivors of 4 at request 5 of
#: 32, a 1,048,576-row block before and after (one dispatch each)
MESH_DEGRADE = {"requests": 32, "loss_at": 5, "survivors": 3, "block_rows": 1 << 20,
                "max_batch": 1 << 20, "seed": 0}


def export_mesh_sets(bundle, sizes):
    """The committed north-star policy as a bundle under ``bundle`` with AOT
    sets for 4, 2 and 1 rank(s) at the buckets of ``sizes`` (one process; the
    mesh sets are manifests, the single-device set builds and times its
    graphs); returns the bundle and the export's seconds."""
    import shutil

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.aot import export_aot
    from orp_tpu_torch.serve import export_bundle, load_bundle

    shutil.rmtree(bundle, ignore_errors=True)
    t0 = time.perf_counter()
    policy = export_bundle(load_bundle(NORTH_STAR_POLICY), bundle)
    export_aot(bundle, policy, buckets=sizes, meshes=(4, 2, None))
    return bundle, time.perf_counter() - t0


def mesh_aot_degrade_checks(res, bundle, sizes, say) -> dict:
    """[mesh] (b)'s checks of the ``aot`` and ``degrade`` jobs (each rank's
    results ``res``): the n4 set loaded with 0 ``nvcc`` runs, 0 capture
    fallbacks and one capture per bucket, every size bitwise the unsharded
    and the eager mesh engines; the loss rebuilt on 2 ranks from the n2 set
    with 0 ``nvcc`` and one capture per bucket, ranks 2 and 3 stood down,
    every answer bitwise, 0 failed, the reference's counters. Returns the
    MTTR and the seconds the two jobs added."""
    import json as _json

    index = _json.loads((bundle / "aot" / "aot.json").read_text())

    def buckets(n):
        [key] = [k for k, row in index["topologies"].items() if row["n_devices"] == n]
        manifest = _json.loads((bundle / "aot" / key / "aot.json").read_text())
        return sorted(int(b) for b in manifest["buckets"])

    n4, n2 = buckets(4), buckets(2)
    for r in res:
        a = r["aot"]
        say(a["topology"].endswith("-n4") and a["nvcc"] == 0 and a["captures"] == len(n4)
            and a["fallbacks"] == {"capture": 0, "set": 0}
            and a["cache_info"]["aot_buckets"] == n4,
            f"[mesh] (b) rank {r['rank']}: the n4 set loaded with 0 nvcc runs, 0 capture "
            f"fallbacks, {a['captures']} shard graphs ({a['load_s']:.3f} s)")
        say(all(a["equal"].values()) and all(a["equal_eager_mesh"].values())
            and a["cache_info"]["aot_hits"] == len(sizes),
            f"[mesh] (b) rank {r['rank']}: {len(sizes)} sizes through the n4 graphs, bitwise "
            f"the unsharded and the eager mesh engines")
    [d] = res[0]["degrade"]
    st = d["stats"]
    [rc] = st["recoveries"]
    say(d["injected"] == ["serve/dispatch"] and d["failed"] == 0 and all(d["bitwise"])
        and all(b["bitwise"] and b["n_served"] == MESH_DEGRADE["block_rows"]
                for b in d["blocks"].values()),
        f"[mesh] (b) degrade: {MESH_DEGRADE['requests']} requests and "
        f"{MESH_DEGRADE['block_rows']}-row blocks before and after, 0 failed, every answer "
        f"bitwise the single-device engine ({rc['replayed']} replayed)")
    say(st["mesh_devices"] == 2 and (rc["from_devices"], rc["to_devices"]) == (4, 2)
        and rc["replay_unresolved"] == 0 and rc["rebuild_xla_compiles"] == 0
        and rc["rebuild_graph_captures"] == len(n2) and rc["aot_buckets"] == n2
        and d["counters"] == {"guard/device_loss{survivors=3}": 1,
                              "guard/topology_rebuild{from_devices=4,to_devices=2}": 1},
        f"[mesh] (b) degrade: 4 -> 2 ranks from the n2 set, 0 nvcc, "
        f"{rc['rebuild_graph_captures']} captures, MTTR {rc['mttr_ms']} ms")
    parts = [r["degrade"][0] for r in res[1:]]
    say([p["role"] for p in parts] == ["follower", "stood_down", "stood_down"]
        and parts[0]["rebuilds"][0]["nvcc"] == 0
        and parts[0]["rebuilds"][0]["captures"] == len(n2),
        "[mesh] (b) degrade: rank 1 rebuilt beside rank 0 from the n2 set; ranks 2 and 3 "
        "stood down")
    added = res[0]["aot"]["wall_s"] + d["wall_s"]
    print(f"[mesh] (b) degrade on four gloo ranks sharing the card: MTTR {rc['mttr_ms']} ms "
          f"(drain, rebuild from the n2 set with {rc['rebuild_graph_captures']} captures, "
          f"replay); the aot and degrade jobs added {added:.3f} s (aot "
          f"{res[0]['aot']['wall_s']:.3f} s, degrade {d['wall_s']:.3f} s)", flush=True)
    return {"mesh_mttr_ms": rc["mttr_ms"], "mesh_aot_degrade_s": added,
            "mesh_rebuild_captures": rc["rebuild_graph_captures"]}


def mesh_phases(dev, exact_n) -> dict:
    """[mesh]: the paths mesh at the north star's width (1,048,576 paths x 364
    steps, 52 dates, the scan engine, GN 30 + 51 x 10), each mesh run in
    processes of its own (``tools/torch_mesh_ranks.launch``, a hard timeout; a
    rank that fails fails the phase):

    (a) an NCCL group over every visible card: ``european_hedge(mesh=)`` as the
        host loop and fused (the fused date loop under ``no_host_sync``, NCCL's
        ``all_reduce`` inside the captured LM iteration), held to the same call
        without a mesh in this process, bitwise where a 1-rank group gives the
        single-device arithmetic and else inside ``rtol=1e-5`` on ``v0_cv``;
        the sharded engine on the committed north-star policy at buckets 1 to
        1,048,576, bitwise the unsharded one;
    (b) four ``gloo`` ranks sharing the card, 262,144 paths each: the host-loop
        walk at GN ``MESH_GLOO_ITERS`` (3 + 51 x 1: a cut of depth, the four
        processes share one card), ``v0_cv`` within ``rtol=1e-5`` and the
        network ``v0`` within 10% of the same walk without a mesh; the sharded
        engine bitwise per bucket; ``fused=True`` refused under ``gloo`` and
        ``engine="pallas"`` refused with a mesh, in the reference's words;
        exact thinning at 262,144 x ``MESH_GLOO_PENSION_STEPS`` (50) steps a
        rank (the start of [exact]'s grid), the four blocks concatenated
        bitwise the first 3 knots of [exact]'s one-process run; the mesh's AOT
        sets and its degradation (:func:`mesh_aot_degrade_checks`).

    The mesh path runs no kernel (the JAX package's runs none): each rank
    reports its kernels' launch counters, all 0."""
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge

    ranks = mesh_tool()
    torch.cuda.empty_cache()  # the ranks' processes share the card with this one

    def say(ok: bool, what: str) -> None:  # one printed line per check
        check(ok, what)
        print(f"{what}: ok", flush=True)

    sim = dict(n_paths=N_FULL, T=1.0, dt=1 / N_STEPS, rebalance_every=STORE, engine="scan")
    train = dict(dual_mode="mse_only", optimizer="gauss_newton", gn_iters_first=30,
                 gn_iters_warm=10)
    refs = {}
    for fused in (False, True):
        refs[fused], wall = timed(lambda: european_hedge(  # noqa: B023
            EuropeanConfig(), SimConfig(**sim), TrainConfig(**train, fused=fused)))
        print(f"[mesh] no mesh, {'fused' if fused else 'host loop'}: v0_cv "
              f"{refs[fused].report.v0_cv!r}, v0_acv {refs[fused].report.v0_acv!r}, "
              f"{wall:.3f} s", flush=True)
    walk = {"sim": sim, "train": train}
    # (b)'s walk: the same paths, dates and engine at GN 3 + 51 x 1 (a cut of
    # depth: four processes share the card), held to the same walk without a
    # mesh in this process
    gloo_train = dict(train, gn_iters_first=MESH_GLOO_ITERS[0],
                      gn_iters_warm=MESH_GLOO_ITERS[1])
    gloo_ref, wall = timed(lambda: european_hedge(EuropeanConfig(), SimConfig(**sim),
                                                  TrainConfig(**gloo_train)))
    print(f"[mesh] no mesh, host loop at GN {MESH_GLOO_ITERS[0]} + 51 x {MESH_GLOO_ITERS[1]}: "
          f"v0_cv {gloo_ref.report.v0_cv!r}, {wall:.3f} s", flush=True)
    sizes = [1, 7, 33] + [1 << k for k in range(3, 21)]
    engine = {"bundle": str(NORTH_STAR_POLICY), "sizes": sizes}
    out = {}
    work = HERE / "build" / "mesh"
    work.mkdir(parents=True, exist_ok=True)

    # -- (a) NCCL over every visible card ----------------------------------------
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = ranks.launch(world, {"walks": [walk, dict(walk, train=dict(train, fused=True))],
                               "engine": engine, "sync_check": True}, work / "nccl",
                       device="cuda", backend="nccl", timeout=300)
    out["nccl_s"] = time.perf_counter() - t0
    say(all(v == 0 for r in res for v in r["kernel_launches"].values()),
        "[mesh] (a) the mesh path launches no kernel on any rank")
    print(f"[mesh] (a) an NCCL group over every visible card: {world} rank(s), "
          f"{out['nccl_s']:.1f} s", flush=True)
    for i, fused in enumerate((False, True)):
        what = "fused (NCCL all_reduce captured)" if fused else "host loop"
        ref = refs[fused].report
        for r in res:
            w = r["walks"][i]
            say(w["values"].shape[0] == N_FULL // world, f"[mesh] (a) rank {r['rank']} "
                f"holds {N_FULL // world} rows")
            d_cv = w["v0_cv"] - ref.v0_cv
            bitwise = d_cv == 0 and w["v0_acv"] == ref.v0_acv
            say(bitwise or abs(d_cv) <= 1e-5 * abs(ref.v0_cv),
                f"[mesh] (a) {what} rank {r['rank']}: v0_cv {w['v0_cv']!r} vs {ref.v0_cv!r} "
                f"(diff {d_cv:.3e}), v0_acv {w['v0_acv']!r} vs {ref.v0_acv!r}: "
                f"{'bitwise' if bitwise else 'rtol 1e-5'}")
        walls = res[0]["walks"][i]["seconds"]
        out[f"nccl_{'fused' if fused else 'host'}_s"] = walls[-1]
        print(f"[mesh] (a) {what}: {walls[0]:.3f} s, the rank's first walk (no mesh "
              f"{'fused' if fused else 'host loop'} above)", flush=True)
    for r in res:
        eng = r["engine"]
        say(eng["cache_info"]["mesh_devices"] == world and all(eng["equal"].values()),
            f"[mesh] (a) rank {r['rank']}: the sharded engine bitwise the unsharded one at "
            f"{len(sizes)} sizes, buckets {eng['buckets'][1]} to {eng['buckets'][1 << 20]}")

    # -- (b) four gloo ranks sharing the card ------------------------------------
    # the start of [exact]'s grid (the same dt): exact thinning is addressed
    # by (seed, step, path), so its knots are [exact]'s first ones
    spec = {"n_paths": N_FULL, "T": 10.0 * MESH_GLOO_PENSION_STEPS / PENSION_STEPS,
            "n_steps": MESH_GLOO_PENSION_STEPS,
            "kw": dict(PENSION, store_every=PENSION_STORE, binomial_mode="exact", seed=1234)}
    t0 = time.perf_counter()
    aot_bundle, out["aot_export_s"] = export_mesh_sets(work / "aot_bundle", sizes)
    aot_jobs = {"aot": {"bundle": str(aot_bundle), "sizes": sizes},
                "degrade": {"bundle": str(aot_bundle), "scenarios": [MESH_DEGRADE]}}
    res = ranks.launch(4, {"walks": [dict(walk, train=gloo_train)], "engine": engine,
                           "refusals": walk, "pension": spec, **aot_jobs},
                       work / "gloo", device="cuda", backend="gloo", timeout=600)
    out["gloo_s"] = time.perf_counter() - t0
    out.update(mesh_aot_degrade_checks(res, aot_bundle, sizes, say))
    say(all(v == 0 for r in res for v in r["kernel_launches"].values()),
        "[mesh] (b) the mesh path launches no kernel on any rank")
    ref = gloo_ref
    for r in res:
        w = r["walks"][0]
        say(w["values"].shape[0] == N_FULL // 4, f"[mesh] (b) rank {r['rank']} holds "
            f"{N_FULL // 4} rows on cuda:0")
        say(abs(w["v0_cv"] - ref.report.v0_cv) <= 1e-5 * abs(ref.report.v0_cv)
            and abs(w["v0"] / ref.v0 - 1) < 0.10,
            f"[mesh] (b) rank {r['rank']}: v0_cv {w['v0_cv']!r} vs {ref.report.v0_cv!r} "
            f"(diff {w['v0_cv'] - ref.report.v0_cv:.3e}, rtol 1e-5), v0 {w['v0']:.6f} vs "
            f"{ref.v0:.6f} ({w['v0'] / ref.v0 - 1:+.4%}, 10%)")
        eng = r["engine"]
        say(eng["cache_info"]["mesh_devices"] == 4 and all(eng["equal"].values()),
            f"[mesh] (b) rank {r['rank']}: the sharded engine bitwise per bucket "
            f"({len(sizes)} sizes)")
        say(r["refusals"]["fused"] is not None and "'gloo'" in r["refusals"]["fused"],
            f"[mesh] (b) fused=True refused under gloo: {r['refusals']['fused']!r}")
        say(r["refusals"]["pallas"] == "european_hedge: engine='pallas' is single-chip; use "
            "engine='scan' with a mesh", f"[mesh] (b) {r['refusals']['pallas']!r}")
    blocks = torch.cat([r["pension"]["N"] for r in res])
    say(torch.equal(blocks, exact_n[:, :blocks.shape[1]]),
        f"[mesh] (b) exact thinning: four ranks' N blocks of {N_FULL // 4} x "
        f"{spec['n_steps']} steps, concatenated, bitwise the first {blocks.shape[1]} knots of "
        f"[exact]'s one-process {PENSION_STEPS}-step run ({tuple(blocks.shape)})")
    out["gloo_walk_s"] = max(r["walks"][0]["seconds"][-1] for r in res)
    out["gloo_pension_s"] = max(r["pension"]["seconds"] for r in res)
    print(f"[mesh] (b) four gloo ranks on cuda:0: {out['gloo_s']:.1f} s in all (the AOT sets' "
          f"export {out['aot_export_s']:.3f} s in this process); the walk "
          f"{out['gloo_walk_s']:.3f} s, exact thinning {out['gloo_pension_s']:.1f} s a rank "
          f"(four processes sharing the card)", flush=True)
    return out


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
    import tempfile

    import numpy as np

    from orp_tpu_torch import HESTON_WALK, NORTH_STAR_POLICY
    from orp_tpu_torch.api import (EuropeanConfig, HestonConfig, SimConfig, TrainConfig,
                                   european_hedge, european_oos, heston_hedge, heston_oos)
    from orp_tpu_torch.cli import result_line
    from orp_tpu_torch.qmc import fused_gbm, fused_mf
    from orp_tpu_torch.serve import (HedgeEngine, export_bundle, load_bundle, megakernel,
                                     save_bundle)
    from orp_tpu_torch.serve.bundle import model_meta
    from orp_tpu_torch.serve.precision import BF16_RULE, bf16_agreement
    from orp_tpu_torch.train import backward, gn
    from orp_tpu_torch.utils import bs_call, cuda_build, heston_call
    from orp_tpu_torch.utils.measure import cuda_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    counts = Counts(fused_gbm=fused_gbm.gbm_log_fused, mixed_head=megakernel.mixed_head_forward,
                    mixed_head_bf16=(megakernel.mixed_head_forward, "launches_bf16"),
                    heston_qe=fused_mf.heston_qe_fused, heston_euler=fused_mf.heston_log_fused,
                    pension=fused_mf.pension_fused)
    launches = {}

    # -- 2. build ------------------------------------------------------------
    # both sources start now; K2's (the long one) builds in a child while the
    # path kernels are checked, and is waited for before K2's first check
    t_build = time.perf_counter()
    k2_build = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r)\n"
         "from orp_tpu_torch.utils import cuda_build\n"
         "print(cuda_build.build_all(('mixed_head',))['mixed_head'])" % str(HERE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    atexit.register(_stop, k2_build)
    reports = cuda_build.build_all(("fused_mf",))
    print(f"[build] fused_mf in {time.perf_counter() - t_build:.2f} s (mixed_head building beside "
          "the path kernels' checks)", flush=True)
    for name, log in reports.items():
        for line in ptxas_lines(log):
            print(f"[build] {name}: {line}")

    # -- 3. kernel vs plain on the card --------------------------------------
    gbm_kw = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / N_STEPS, seed=OOS_SEED,
                  store_every=STORE, device=dev)
    k1_err = 0.0
    plain_ms = {}  # each plain version's main-path shape, timed in its check (one run)
    # 33 paths: one lane in a second warp; 2,097,185: a partial last warp and
    # index bits above 2^21 (the kernel's warp part and lane part)
    for n in (33, 65_536, N_FULL, N_K1_WIDE):
        got = fused_gbm.gbm_log_fused(n, N_STEPS, **gbm_kw)
        torch.cuda.synchronize()
        a, b = _events(dev)
        want = fused_gbm.gbm_log_plain(n, N_STEPS, **gbm_kw)
        if n == N_FULL:
            plain_ms["fused_gbm"] = _elapsed(dev, a, b)
        torch.cuda.synchronize()
        check(got.shape == (n, N_STEPS // STORE + 1), f"K1 shape {tuple(got.shape)}")
        torch.testing.assert_close(got, want, rtol=3e-5, atol=0.0)
        k1_err = max(k1_err, max_err(got, want))
        print(f"[K1] {n} x {N_STEPS} store {STORE}: max|kernel - plain| = "
              f"{max_err(got, want):.3e} (rtol 3e-5)", flush=True)
    # a dense grid: 365 knots, where the reference chains _gbm_kernel_chunk calls
    dense_kw = dict(gbm_kw, store_every=1)
    got = fused_gbm.gbm_log_fused(65_536, N_STEPS, **dense_kw)
    torch.cuda.synchronize()
    want = fused_gbm.gbm_log_plain(65_536, N_STEPS, **dense_kw)
    check(got.shape == (65_536, N_STEPS + 1), f"K1 dense shape {tuple(got.shape)}")
    torch.testing.assert_close(got, want, rtol=3e-5, atol=0.0)
    print(f"[K1] 65536 x {N_STEPS} store 1 ({N_STEPS + 1} knots, one launch): max|kernel - "
          f"plain| = {max_err(got, want):.3e} (rtol 3e-5)", flush=True)
    del got, want

    heston_kw = dict(HESTON, dt=1.0 / N_STEPS, seed=OOS_SEED, store_every=STORE, device=dev)
    k3_err = {"qe": 0.0, "euler": 0.0}
    for scheme, fused, plain in (("qe", fused_mf.heston_qe_fused, fused_mf.heston_qe_plain),
                                 ("euler", fused_mf.heston_log_fused,
                                  fused_mf.heston_log_plain)):
        v_tol = dict(rtol=2e-3, atol=1e-6) if scheme == "qe" else dict(rtol=3e-5, atol=3e-6)
        for n in (65_536, N_FULL):
            got = fused(n, N_STEPS, **heston_kw)
            torch.cuda.synchronize()
            a, b = _events(dev)
            want = plain(n, N_STEPS, **heston_kw)
            if n == N_FULL:
                plain_ms["heston_" + scheme] = _elapsed(dev, a, b)
            torch.cuda.synchronize()
            for k in ("S", "v"):
                check(got[k].shape == (n, N_STEPS // STORE + 1), f"K3 {scheme} {k} shape")
            torch.testing.assert_close(got["S"], want["S"], rtol=3e-5,
                                       atol=3e-6 if scheme == "euler" else 0.0)
            torch.testing.assert_close(got["v"], want["v"], **v_tol)
            errs = {k: max_err(got[k], want[k]) for k in ("S", "v")}
            k3_err[scheme] = max(k3_err[scheme], *errs.values())
            print(f"[K3 {scheme}] {n} x {N_STEPS} store {STORE}: max|kernel - plain| S "
                  f"{errs['S']:.3e}, v {errs['v']:.3e} (S rtol 3e-5; v {v_tol})", flush=True)
        del got, want
    k3c = k3c_checks(dev)

    policy = load_bundle(NORTH_STAR_POLICY)
    model, n_dates = policy.model, policy.n_dates

    # -- 5. replay (main path: K1) --------------------------------------------
    stored = json.loads((NORTH_STAR_POLICY / "reference.json").read_text())
    euro = EuropeanConfig(constrain_self_financing=False)
    oos_train = TrainConfig(dual_mode="mse_only")
    small = european_oos(policy, euro, SimConfig(n_paths=4096, T=1.0, dt=1 / 364,
                                                 rebalance_every=7, seed_fund=OOS_SEED,
                                                 engine="pallas"), oos_train)
    for k in ("v0", "phi0", "v0_plain", "v0_cv", "cv_std", "acv_std"):
        np.testing.assert_allclose(getattr(small.report, k), stored[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(small.report.var_overall, stored["var_overall"], rtol=1e-4)
    small_bp = abs(small.report.v0_acv - stored["v0_acv"]) / stored["v0_acv"] * 1e4
    check(small_bp <= 0.05, f"4096-path v0_acv within 0.05bp of JAX ({small_bp:.4f}bp)")
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    res = european_oos(policy, euro, SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364,
                                               rebalance_every=7, seed_fund=OOS_SEED,
                                               engine="pallas"), oos_train)
    torch.cuda.synchronize()
    oos_s = time.perf_counter() - t1
    replay_k1 = counts.only("fused_gbm", "the 1M-path european_oos")
    rep = res.report
    bs, _ = bs_call(100.0, 100.0, 0.08, 0.15, 1.0)
    bp_err = (rep.v0_acv - bs) / bs * 1e4
    check(all(math.isfinite(x) for x in report_fields(rep)), "replay report fields finite")
    check(res.backward.values.shape == (N_FULL, n_dates + 1), "replayed ledger shape")
    check(abs(bp_err) < 1.0, f"|bp_err| {bp_err:.4f} < 1bp")
    print(f"[replay] 4096 paths match the stored JAX report (|dv0_acv| {small_bp:.4f}bp); "
          f"{N_FULL} paths x {N_STEPS} steps: v0_acv {rep.v0_acv:.6f} vs BS {bs:.6f} "
          f"bp_err {bp_err:+.4f}, cv_std {rep.cv_std:.4f}, acv_std {rep.acv_std:.4f}, "
          f"v0_network {rep.v0:.4f}; wall {oos_s:.2f} s; K1 launches {replay_k1}", flush=True)
    del res

    # -- 6. the fixture walk: 4,096 paths from the stored JAX initial params --
    hcfg = HestonConfig()
    gn_train = TrainConfig(dual_mode="mse_only", optimizer="gauss_newton")
    h_ref = json.loads((HESTON_WALK / "reference.json").read_text())
    with np.load(HESTON_WALK / "init.npz") as z:
        h_init = {k: z[k] for k in z.files}

    def heston_sim(n: int, seed: int = 1235) -> SimConfig:
        return SimConfig(n_paths=n, T=1.0, dt=1 / 364, rebalance_every=STORE, seed_fund=seed,
                         engine="pallas")

    t1 = time.perf_counter()
    fx = heston_hedge(hcfg, heston_sim(N_FIXTURE), gn_train, warm_start=(h_init, None))
    torch.cuda.synchronize()
    fx_s = time.perf_counter() - t1
    gaps = {k: (getattr(fx.report, k) - h_ref[k]) / h_ref[k] * 1e4 for k in FIXTURE_BAND_BP}
    for k, lim in FIXTURE_BAND_BP.items():
        check(abs(gaps[k]) <= lim, f"fixture walk {k} within {lim}bp of JAX ({gaps[k]:+.3f}bp)")
    v0_rel = fx.report.v0 / h_ref["v0"] - 1
    check(abs(v0_rel) <= FIXTURE_V0_RTOL, f"fixture walk v0 within rtol {FIXTURE_V0_RTOL} "
          f"of JAX ({v0_rel:+.4%})")
    first_rel = fx.report.train_loss[-1] / h_ref["train_loss"][-1] - 1
    check(all(math.isfinite(x) for x in report_fields(fx.report)), "fixture report finite")
    print(f"[fixture] heston_hedge {N_FIXTURE} paths from the stored JAX init: v0_cv "
          f"{gaps['v0_cv']:+.3f}bp, v0_acv {gaps['v0_acv']:+.3f}bp, v0 {v0_rel:+.4%} vs JAX "
          f"(bands {FIXTURE_BAND_BP}, v0 {FIXTURE_V0_RTOL:.0%}); first fitted date's loss "
          f"{first_rel:+.2e} vs JAX; wall {fx_s:.2f} s", flush=True)
    del fx
    # the stored JAX walk's own per-date params replayed on the card's in-sample
    # K3b paths: no training, so no chaos, and the report must land where JAX's did
    jax_walk = load_bundle(HESTON_WALK)
    rp = heston_oos(jax_walk, hcfg, heston_sim(N_FIXTURE, jax_walk.sim_seed), gn_train,
                    allow_in_sample=True).report
    rp_bp = {k: (getattr(rp, k) - h_ref[k]) / h_ref[k] * 1e4 for k in ("v0_cv", "v0_acv")}
    for k, gap in rp_bp.items():
        check(abs(gap) <= 0.5, f"replayed JAX walk {k} within 0.5bp of JAX ({gap:+.4f}bp)")
    rp_v0 = rp.v0 / h_ref["v0"] - 1
    check(abs(rp_v0) <= 1e-3, f"replayed JAX walk v0 within rtol 1e-3 of JAX ({rp_v0:+.2e})")
    check(all(math.isfinite(x) for x in report_fields(rp)), "replayed report finite")
    print(f"[fixture] the stored JAX walk's params replayed on the card's {N_FIXTURE} "
          f"in-sample paths: v0_cv {rp_bp['v0_cv']:+.4f}bp, v0_acv {rp_bp['v0_acv']:+.4f}bp, "
          f"v0 {rp_v0:+.2e} vs the stored JAX report (limits 0.5bp, 0.5bp, 1e-3)", flush=True)
    # the same walk in float64 on the card and on the CPU, on the same paths (the
    # card's K3b run, widened): f64 leaves no borderline accept/reject, so both run
    # the same LM iterations and the prices agree far inside 0.5bp (the CPU port
    # is held to the JAX package in f64 the same way, tests/test_torch_walk.py)
    fx_paths = fused_mf.heston_qe_fused(N_FIXTURE, N_STEPS, **dict(heston_kw, seed=1235))
    t1 = time.perf_counter()
    f64 = {d.type: f64_heston_walk(fx_paths, hcfg, h_init, d)
           for d in (dev, torch.device("cpu"))}
    f64_s = time.perf_counter() - t1
    card64, cpu64 = f64["cuda"], f64["cpu"]
    f64_bp = {k: (getattr(card64.report, k) - getattr(cpu64.report, k))
              / getattr(cpu64.report, k) * 1e4 for k in ("v0_cv", "v0_acv")}
    for k, gap in f64_bp.items():
        check(abs(gap) <= 0.5, f"f64 walk {k}: card within 0.5bp of the CPU ({gap:+.2e}bp)")
    f64_v0 = card64.report.v0 / cpu64.report.v0 - 1
    check(abs(f64_v0) <= 1e-3, f"f64 walk v0: card within rtol 1e-3 of the CPU ({f64_v0:+.2e})")
    check(np.array_equal(card64.backward.epochs_ran, cpu64.backward.epochs_ran),
          "f64 walk: the same accepted LM iterations on every date")
    loss_rel = float(np.max(np.abs(card64.backward.train_loss / cpu64.backward.train_loss - 1)))
    check(loss_rel <= 1e-7, f"f64 walk: per-date losses within rtol 1e-7 ({loss_rel:.2e})")
    print(f"[fixture] the same walk in float64 on the card and on the CPU, same paths: "
          f"v0_cv {f64_bp['v0_cv']:+.2e}bp, v0_acv {f64_bp['v0_acv']:+.2e}bp, v0 "
          f"{f64_v0:+.2e} (limits 0.5bp, 0.5bp, 1e-3); accepted iterations equal on all "
          f"{n_dates} dates ({int(cpu64.backward.epochs_ran.sum())}); per-date losses "
          f"{loss_rel:.2e} apart (rtol 1e-7); {f64_s:.2f} s", flush=True)
    del f64, card64, cpu64

    # -- 7. main path A: heston_hedge + heston_oos at 1M (K3b) -----------------
    price = heston_call(hcfg.s0, hcfg.strike, hcfg.r, 1.0, v0=hcfg.v0, kappa=hcfg.kappa,
                        theta=hcfg.theta, xi=hcfg.xi, rho=hcfg.rho)
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    trained = heston_hedge(hcfg, heston_sim(N_FULL), gn_train)
    torch.cuda.synchronize()
    hedge_s = time.perf_counter() - t1
    launches["heston_qe"] = counts.only("heston_qe", "the 1M-path heston_hedge")
    bw = trained.backward
    check(bw.values.shape == (N_FULL, n_dates + 1) and bw.phi.shape == (N_FULL, n_dates),
          "heston ledger shapes (n, 53) / (n, 52)")
    check(bool(torch.isfinite(bw.values).all()), "heston ledgers finite")
    in_sample = check_heston_price(trained.report, price, N_FULL, "heston_hedge")
    print(f"[heston] heston_hedge {N_FULL} paths x {N_STEPS} steps (QE-M, GN mse_only): "
          f"{in_sample} vs heston_call {price:.6f}; v0_network {trained.report.v0:.4f}; "
          f"wall {hedge_s:.2f} s; K3b launches {launches['heston_qe']}", flush=True)
    print(f"[heston] accepted GN iterations per date (0..51): {bw.epochs_ran.tolist()}")
    print(f"[heston] final loss per date (0..51): "
          f"{[float(f'{x:.4e}') for x in bw.train_loss]}", flush=True)
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    oos = heston_oos(trained, hcfg, heston_sim(N_FULL, OOS_SEED), gn_train)
    torch.cuda.synchronize()
    heston_oos_s = time.perf_counter() - t1
    oos_k3b = counts.only("heston_qe", "the 1M-path heston_oos")
    check(oos.backward.values.shape == (N_FULL, n_dates + 1), "heston_oos ledger shape")
    out_sample = check_heston_price(oos.report, price, N_FULL, "heston_oos")
    print(f"[heston] heston_oos {N_FULL} fresh paths (seed {OOS_SEED}): {out_sample}; "
          f"wall {heston_oos_s:.2f} s; K3b launches {oos_k3b}", flush=True)
    del oos

    # -- 8. the Euler scheme: heston_oos on Euler paths (K3a) -----------------
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    eul = heston_oos(trained, HestonConfig(scheme="euler"), heston_sim(N_FULL, EULER_SEED),
                     gn_train)
    torch.cuda.synchronize()
    euler_s = time.perf_counter() - t1
    launches["heston_euler"] = counts.only("heston_euler", "the 1M-path Euler heston_oos")
    euler_out = check_heston_price(eul.report, price, N_FULL, "heston_oos (euler)")
    print(f"[euler] heston_oos {N_FULL} fresh Euler paths (seed {EULER_SEED}): {euler_out}; "
          f"wall {euler_s:.2f} s; K3a launches {launches['heston_euler']}", flush=True)
    del eul

    # -- 9. main path B: european_hedge at 1M with the GN walk (K1) -----------
    torch.cuda.synchronize()
    counts.reset()
    t1 = time.perf_counter()
    eh = european_hedge(euro, SimConfig(n_paths=N_FULL, T=1.0, dt=1 / 364, rebalance_every=7,
                                        engine="pallas"), gn_train)
    torch.cuda.synchronize()
    euro_s = time.perf_counter() - t1
    launches["fused_gbm"] = counts.only("fused_gbm", "the 1M-path european_hedge")
    pilot_incumbent = pathlib.Path(tempfile.mkdtemp(prefix="orp-north-star-")) / "bundle"
    export_bundle(eh, pilot_incumbent)  # [pilot]'s incumbent, served and retrained at the end
    erep = eh.report
    # what [cli]'s `euro` must print and export, bitwise
    euro_line = result_line(erep)
    euro_params = {k: v.detach().cpu().clone() for k, v in eh.backward.params1_by_date.items()}
    euro_bp = (erep.v0_acv - bs) / bs * 1e4
    check(all(math.isfinite(x) for x in report_fields(erep)), "european_hedge report finite")
    check(eh.backward.values.shape == (N_FULL, n_dates + 1), "european_hedge ledger shape")
    check(abs(euro_bp) < 1.0, f"european_hedge |v0_acv - BS| {euro_bp:+.4f}bp < 1bp")
    print(f"[euro] european_hedge {N_FULL} paths x {N_STEPS} steps (GN mse_only): v0_acv "
          f"{erep.v0_acv:.6f} vs BS {bs:.6f} bp_err {euro_bp:+.4f}, v0_cv {erep.v0_cv:.6f}, "
          f"cv_std {erep.cv_std:.4f}, acv_std {erep.acv_std:.4f}, v0_network {erep.v0:.4f}; "
          f"accepted GN iterations {int(eh.backward.epochs_ran.sum())} over 52 dates; "
          f"wall {euro_s:.2f} s; K1 launches {launches['fused_gbm']}", flush=True)

    # -- 3 (K2) and 4, after the path kernels' main paths: K2's library, built
    # beside everything above
    log, err = k2_build.communicate(timeout=900)
    check(k2_build.returncode == 0, f"mixed_head build: rc {k2_build.returncode}\n{err[-3000:]}")
    reports = cuda_build.build_all()
    check(all(r == "cached" for r in reports.values()), f"every library built ({reports})")
    print(f"[build] mixed_head waited for at {time.perf_counter() - t_build:.2f} s into the run",
          flush=True)
    for line in ptxas_lines(log):
        print(f"[build] mixed_head: {line}")

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
    # K2's bf16 kernel at the same shapes, against mixed_head_plain in bf16
    model_bf = model.with_dtype(torch.bfloat16)
    p1_bf = {k: v.to(torch.bfloat16) for k, v in p1.items()}
    feats_bf = feats.to(torch.bfloat16)
    packed_bf = megakernel.pack_head_params(model_bf, p1_bf)
    got = megakernel.mixed_head_forward(model_bf, p1_bf, dates, feats_bf, packed=packed_bf)
    torch.cuda.synchronize()
    want = megakernel.mixed_head_plain(model_bf, p1_bf, dates, feats_bf)
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16 and got.shape == want.shape, "K2 bf16 output")
    k2b_agree = bf16_agreement(got, want)
    check(k2b_agree["ok"], f"K2 bf16 kernel vs plain: {k2b_agree} ({BF16_RULE})")
    check(torch.equal(got, megakernel.mixed_head_bf16_order(model_bf, p1_bf, dates, feats_bf)),
          "K2 bf16 bitwise its documented summation order")
    k2b_err = max_err(got, want)
    print(f"[K2 bf16] {N_FULL} rows x {n_dates} dates: {k2b_agree['equal_share']:.6%} of "
          f"elements bitwise equal to mixed_head_plain in bf16, {k2b_agree['n_differ']} "
          f"differ (f32-accumulation order), max {k2b_agree['max_ulps']:.0f} bf16 spacings, "
          f"max|kernel - plain| = {k2b_err:.3e} (rule {BF16_RULE}); bitwise its documented "
          "order", flush=True)
    bad = megakernel.mixed_head_forward(model_bf, p1_bf, torch.tensor(
        [0, n_dates, -1], device=dev, dtype=torch.int32), feats_bf[:3], packed=packed_bf)
    check(bool(torch.isfinite(bad[0]).all()) and bool(torch.isnan(bad[1:]).all()),
          "K2 bf16 writes NaN rows for out-of-range dates")
    del got, want

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
    counts.reset()
    t1 = time.perf_counter()
    phi, psi, v = engine.evaluate_mixed_async(big_dates, big_states, big_prices).result()
    serve_s = [time.perf_counter() - t1]
    launches["mixed_head"] = counts.only("mixed_head", "the 1M-row serve request")
    check(phi.shape == (N_FULL,) and bool(np.isfinite(phi).all() and np.isfinite(v).all()),
          "1M-row serve block finite")
    for _ in range(2):
        t1 = time.perf_counter()
        engine.evaluate_mixed_async(big_dates, big_states, big_prices).result()
        serve_s.append(time.perf_counter() - t1)
    rows_s = N_FULL / sorted(serve_s)[1]
    print(f"[serve] blocks 1/7/4096/1048576 + evaluate(date {d0}): 4096-row block "
          f"matches the stored JAX outputs (rtol 1e-5, atol 1e-6); 1M-row block "
          f"{rows_s:,.0f} rows/s host-to-host (median of 3); request latency host-to-"
          f"host (median of 31): 1 row {lat_ms[1]:.3f} ms, 4096 rows {lat_ms[4096]:.3f} ms; "
          f"K2 launches in the 1M-row request {launches['mixed_head']}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del engine

    # -- 10. serve the card-trained Heston policy (K2) ------------------------
    hp = {k: v.detach().cpu().numpy() for k, v in bw.params1_by_date.items()}
    bundle_dir = HERE / "build" / "chip_smoke" / "heston_policy"
    meta = {"model": model_meta(trained.model), "times": trained.times.tolist(),
            "adjustment_factor": trained.adjustment_factor, "dual_mode": trained.dual_mode,
            "holdings_combine": trained.holdings_combine,
            "cost_of_capital": trained.cost_of_capital, "sim_seed": trained.sim_seed}
    save_bundle(bundle_dir, meta, hp, None, {"train_loss": bw.train_loss,
                                             "train_mae": bw.train_mae,
                                             "train_mape": bw.train_mape,
                                             "epochs_ran": bw.epochs_ran})
    hpolicy = load_bundle(bundle_dir)
    hengine = HedgeEngine(hpolicy)
    rng = np.random.default_rng(13)
    n_rows = 4096
    hd = np.concatenate([np.arange(n_dates), rng.integers(0, n_dates, n_rows - n_dates)])
    t_d = np.asarray(trained.times)[hd]
    hs = np.exp(0.15 * np.sqrt(t_d) * rng.standard_normal(n_rows) + 0.06 * t_d)
    hv = 0.0225 * rng.gamma(4.0, 0.25, n_rows)
    hstates = np.stack([hs, hv], 1).astype(np.float32)
    hprices = np.stack([hs, np.exp(0.08 * t_d) / 100.0], 1).astype(np.float32)
    counts.reset()
    phi, psi, v = hengine.evaluate_mixed_async(hd.astype(np.int32), hstates, hprices).result()
    serve_k2 = counts.only("mixed_head", "the trained Heston policy's serve block")
    hp_dev = {k: t.to(dev) for k, t in hpolicy.backward.params1_by_date.items()}
    plain = megakernel.mixed_head_plain(
        hpolicy.model, hp_dev, torch.from_numpy(hd.astype(np.int32)).to(dev),
        torch.from_numpy(hstates).to(dev)).cpu().numpy()
    np.testing.assert_allclose(phi, plain[:, 0], rtol=1e-5, atol=1e-6, err_msg="phi")
    np.testing.assert_allclose(psi, plain[:, 1], rtol=1e-5, atol=1e-6, err_msg="psi")
    np.testing.assert_allclose(v, (plain * hprices).sum(1), rtol=1e-5, atol=1e-6, err_msg="v")
    check(len(np.unique(hd)) == n_dates, "the serve block covers all 52 dates")
    print(f"[serve-heston] card-trained policy -> save_bundle -> load_bundle -> HedgeEngine: "
          f"{n_rows} rows over {n_dates} dates match mixed_head_plain (rtol 1e-5, atol "
          f"1e-6); K2 launches {serve_k2}", flush=True)

    pension = pension_phases(dev, counts, launches)

    # -- 14. [tiers]: serve both policies at f32, bf16 and int8 -----------------
    t1 = time.perf_counter()
    tiers = {"north-star": tier_phase(dev, counts, policy, big_dates, big_states, big_prices,
                                      "north-star"),
             "pension": tier_phase(dev, counts, pension["policy"], *pension["rows"],
                                   "pension")}
    launches["mixed_head_bf16"] = tiers["north-star"]["bf16"]["launches"]
    k2t = {"north-star": k2_times(dev, policy, N_FULL, 7),
           "pension": k2_times(dev, pension["policy"], N_FULL, 17)}
    for what, t in k2t.items():
        print(f"[tiers] {what} K2 at {N_FULL} rows: bf16 kernel {t['bf16']:.4f} ms (bound "
              f"{t['bf16_bound'][0]:.5f} by {t['bf16_bound'][1]}, plain {t['bf16_plain']:.2f}"
              f" ms), f32 kernel {t['f32']:.4f} ms (bound {t['f32_bound'][0]:.5f} by "
              f"{t['f32_bound'][1]}, plain {t['f32_plain']:.2f} ms); at 4096 rows: bf16 "
              f"{t['bf16_small']:.4f} ms (bound {t['bf16_small_bound'][0]:.6f}), f32 "
              f"{t['f32_small']:.4f} ms (bound {t['f32_small_bound'][0]:.6f})", flush=True)
    print(f"[tiers] {time.perf_counter() - t1:.2f} s", flush=True)

    adam = adam_phases(dev, counts, bs)
    fused = fused_phases(dev, counts, eh, euro_s, pension["hedge"], pension["hedge_s"], bs)
    telemetry = obs_phases(dev, counts, eh, euro_s, fused.pop("euro_fused"), fused["euro_fused_s"],
                           policy, (big_dates, big_states, big_prices), lat_ms[1])
    resilience = resilience_phases(dev, counts, eh, euro_s, bs)
    del eh
    pension.pop("hedge")
    basket = basket_phases(dev, counts)
    launches["mixed_head_basket"] = basket["assets"]["k2"]
    launches["mixed_head_bf16_basket"] = basket["tiers"]["bf16"]["launches"]
    greeks = greeks_phases(dev)
    exotics = exotics_phases(dev, counts, fused["bench_fused_s"])
    mesh = mesh_phases(dev, adam.pop("exact_n"))
    hosted = host_phases(dev, counts)
    launches["mixed_head_host"] = hosted["k2_launches"]
    gated = gateway_phases(dev, counts)
    launches["mixed_head_gateway"] = gated["k2_launches"]
    # [pilot] runs beside the compile-and-perf plane's background builds
    plane = aot_plane_phases(dev, counts,
                             beside=lambda: pilot_phases(dev, counts, pilot_incumbent))
    launches["fused_gbm_profile"] = plane["profile_k1"]
    launches["mixed_head_bench"] = plane["bench_k2"]
    piloted = plane.pop("beside")
    launches["fused_gbm_pilot"] = piloted["k1_launches"]
    launches["mixed_head_pilot"] = piloted["k2_launches"]
    commanded = cli_phases(dev, counts, euro_line, euro_params)
    launches["fused_gbm_cli"] = commanded["k1_launches"]
    launches["mixed_head_cli"] = commanded["k2_launches"]

    # -- 19. times at the main paths' shapes ----------------------------------
    k1 = lambda: fused_gbm.gbm_log_fused(N_FULL, N_STEPS, **gbm_kw)  # noqa: E731
    qe = lambda: fused_mf.heston_qe_fused(N_FULL, N_STEPS, **heston_kw)  # noqa: E731
    eu = lambda: fused_mf.heston_log_fused(N_FULL, N_STEPS, **heston_kw)  # noqa: E731
    ms = {}
    ms["fused_gbm_plain"] = plain_ms["fused_gbm"]
    ms["fused_gbm"] = cuda_ms(k1, reps=10)
    # K2 at the north star's shape: timed in [tiers] (k2_times), on section 3's inputs
    ms["mixed_head"] = k2t["north-star"]["f32"]
    ms["mixed_head_plain"] = k2t["north-star"]["f32_plain"]
    ms["heston_qe_plain"] = plain_ms["heston_qe"]
    ms["heston_qe"] = cuda_ms(qe, reps=10)
    ms["heston_euler_plain"] = plain_ms["heston_euler"]
    ms["heston_euler"] = cuda_ms(eu, reps=10)
    ms["heston_qe_2"] = cuda_ms(qe, reps=10)
    ms["fused_gbm_2"] = cuda_ms(k1, reps=10)
    ms["fused_gbm_dense"] = cuda_ms(
        lambda: fused_gbm.gbm_log_fused(N_FULL, N_STEPS, **dense_kw), reps=10)
    ms["fused_gbm_dense_plain"] = cuda_ms(
        lambda: fused_gbm.gbm_log_plain(N_FULL, N_STEPS, **dense_kw), reps=1, rounds=1)
    pen_kw = dict(PENSION, dt=10.0 / PENSION_STEPS, store_every=PENSION_STORE, device=dev)
    pen = lambda: fused_mf.pension_fused(N_FULL, PENSION_STEPS,  # noqa: E731
                                         binomial_mode="inversion", **pen_kw)
    pen_sv = lambda: fused_mf.pension_fused(  # noqa: E731
        N_FULL, PENSION_STEPS, binomial_mode="inversion", **dict(pen_kw, **PENSION_SV))
    ms["pension"] = cuda_ms(pen, reps=5)
    ms["pension_plain"] = k3c["plain_ms"]
    ms["pension_sv"] = cuda_ms(pen_sv, reps=5)
    sv_n = pen_sv()["N"]
    sv_trips = float((sv_n[:, 0].double() - sv_n[:, -1].double()).sum())  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    ms["pension_2"] = cuda_ms(pen, reps=5)
    bounds = {"fused_gbm": k1_bound_ms(N_FULL, N_STEPS, STORE),
              "mixed_head": k2t["north-star"]["f32_bound"],
              "heston_qe": k3_bound_ms(N_FULL, N_STEPS, STORE, "qe"),
              "heston_euler": k3_bound_ms(N_FULL, N_STEPS, STORE, "euler"),
              "pension": k3c_bound_ms(N_FULL, PENSION_STEPS, PENSION_STORE, False, True,
                                      k3c["trips"])}
    for name, (b_ms, by) in bounds.items():
        again = f" / {ms[name + '_2']:.4f}" if name + "_2" in ms else ""
        print(f"[times] {name} {ms[name]:.4f}{again} ms (bound {b_ms:.4f} ms by {by}, plain "
              f"{ms[name + '_plain']:.2f} ms)", flush=True)
    for what, t in k2t.items():
        for dt in ("f32", "bf16"):
            print(f"[times] mixed_head {dt} at the {what} shape: {N_FULL} rows {t[dt]:.4f} ms "
                  f"(bound {t[dt + '_bound'][0]:.5f} ms by {t[dt + '_bound'][1]}, plain "
                  f"{t[dt + '_plain']:.2f} ms); 4096 rows {t[dt + '_small']:.4f} ms (bound "
                  f"{t[dt + '_small_bound'][0]:.6f} ms by {t[dt + '_small_bound'][1]})",
                  flush=True)
    dense_bound = k1_bound_ms(N_FULL, N_STEPS, 1)
    print(f"[times] fused_gbm on the dense grid (store 1, {N_STEPS + 1} knots) "
          f"{ms['fused_gbm_dense']:.4f} ms (bound {dense_bound[0]:.4f} ms by {dense_bound[1]}, "
          f"plain {ms['fused_gbm_dense_plain']:.2f} ms)", flush=True)
    sv_bound = k3c_bound_ms(N_FULL, PENSION_STEPS, PENSION_STORE, True, True, sv_trips)
    print(f"[times] pension (SV fund, inversion) {ms['pension_sv']:.4f} ms (bound "
          f"{sv_bound[0]:.4f} ms by {sv_bound[1]})", flush=True)
    print(f"[times] pension walls at {N_FULL} paths: pension_hedge {pension['hedge_s']:.2f} s "
          f"(40 dates, 60 + 39 x 30 iterations a leg); separate at {N_SEPARATE} "
          f"{pension['separate_s']:.2f} s; SV at {N_SV} {pension['sv_s']:.2f} s; one LM "
          f"iteration at 1M rows, P = 122: MSE {pension['iter_mse_ms']:.3f} ms, IRLS pinball "
          f"{pension['iter_pinball_ms']:.3f} ms (median of 7 rounds of 5); peak device memory "
          f"{pension['peak_gb']:.1f} GB", flush=True)

    # the GN walk alone at 1M (date-ascending features from one more K3b run)
    traj = fused_mf.heston_qe_fused(N_FULL, N_STEPS, **dict(heston_kw, seed=1235))
    s_n = traj["S"] / hcfg.s0
    h_feats = torch.stack([s_n, traj["v"]], dim=-1)
    b_n = torch.exp(hcfg.r * torch.linspace(0.0, 1.0, n_dates + 1, device=dev)) / hcfg.s0
    payoff_n = torch.clamp(traj["S"][:, -1] - hcfg.strike, min=0.0) / hcfg.s0
    walk_cfg = backward.BackwardConfig(dual_mode="mse_only", optimizer="gauss_newton")
    walk_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        backward.backward_induction(trained.model, h_feats, s_n, b_n, payoff_n, walk_cfg,
                                    bias_init=(float(payoff_n.mean()), 0.0))
        torch.cuda.synchronize()
        walk_s.append(time.perf_counter() - t1)
    # one LM iteration at date 0's regression, from its trained params
    prices_all = backward._stack_prices(s_n, b_n)
    problem = gn._GNProblem(trained.model, h_feats[:, 0], prices_all[:, 1],
                            bw.values[:, 1], gn.GNConfig())
    theta = trained.model.flatten({k: v[0] for k, v in bw.params1_by_date.items()})
    problem.start(theta)
    iter_ms = cuda_ms(problem.iterate, reps=5, rounds=7)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[times] GN walk at {N_FULL} paths x 52 dates (Heston, 30 + 51 x 10 iterations): "
          f"{walk_s[0]:.3f} / {walk_s[1]:.3f} s host wall; one LM iteration at 1M rows, "
          f"P = {trained.model.n_params()}: {iter_ms:.3f} ms (median of 7 rounds of 5); "
          f"peak device memory {peak_gb:.1f} GB", flush=True)
    print(f"[times] Adam walk at {N_FULL} paths x 52 dates (north star, each epoch a CUDA "
          f"graph): {adam['adam_s']:.2f} s for {adam['steps']} Adam steps, "
          f"{adam['adam_s'] * 1e3 / adam['steps']:.4f} ms a step; reference workloads: Euro "
          f"flagship {adam['euro_s']:.2f} s, Multi#25-26 {adam['Multi#25-26']:.2f} s, hybrid "
          f"{adam['hybrid']:.2f} s; exact thinning at {N_FULL} x {PENSION_STEPS} "
          f"{adam['exact_s']:.2f} s", flush=True)

    print(f"[times] the walk's resilience plane at {N_FULL} paths: north star fused "
          f"{fused['euro_fused_s']:.3f} s vs host loop {euro_s:.3f} s; benchmark GN "
          f"configuration fused {fused['bench_fused_s']:.3f} s; pension fused "
          f"{fused['pension_fused_s']:.3f} s vs {pension['hedge_s']:.3f} s; checkpointed "
          f"{resilience['ckpt_s']:.3f} s, resumed after step 25 {resilience['resume_s']:.3f} s; "
          f"guarded {resilience['guard_clean_s']:.3f} s; the example's Adam walk fused "
          f"{fused['adam_fused_s']:.3f} s vs host loop {fused['adam_host_s']:.3f} s", flush=True)

    print(f"[times] telemetry at {N_FULL} paths: north star under obs.telemetry, host loop "
          f"{telemetry['host_s']:.3f} s (train/walk span {telemetry['walk_span_s']:.3f} s) vs "
          f"{euro_s:.3f} s without, fused {telemetry['fused_s']:.3f} s (span "
          f"{telemetry['fused_walk_span_s']:.3f} s) vs {fused['euro_fused_s']:.3f} s without; "
          f"1-row serve latency {telemetry['lat_off_ms']:.3f} ms off, {telemetry['lat_on_ms']:.3f}"
          f" ms on ([serve] {lat_ms[1]:.3f} ms)", flush=True)
    print(f"[times] the basket at {N_FULL} paths x {BASKET_STEPS} steps (scan path): "
          + "; ".join(f"{name} {basket[name]['wall']:.3f} s ({basket[name]['iters']} "
                      f"{'epochs' if 'adam' in name else 'accepted GN iterations'}), oos "
                      f"{basket[name]['oos_wall']:.3f} s"
                      for name in ("basket", "assets", "assets-adam"))
          + f"; greeks at {N_FULL} paths: European call {greeks['euro_call_s']:.3f} s, put "
          f"{greeks['euro_put_s']:.3f} s, digital {greeks['digital_s']:.3f} s, Heston (364 "
          f"steps) {greeks['heston_s']:.3f} s, basket {greeks['basket_s']:.3f} s", flush=True)
    print(f"[times] option analytics at {N_FULL} paths: "
          + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in exotics.items() if k.endswith("_s")),
          flush=True)
    print(f"[times] the paths mesh at {N_FULL} paths: NCCL launch {mesh['nccl_s']:.1f} s (host "
          f"loop {mesh['nccl_host_s']:.3f} s, fused {mesh['nccl_fused_s']:.3f} s); four gloo "
          f"ranks on one card {mesh['gloo_s']:.1f} s (walk {mesh['gloo_walk_s']:.3f} s, exact "
          f"thinning {mesh['gloo_pension_s']:.1f} s a rank)", flush=True)
    k2b = basket["k2"]["assets"]
    kernels = {"kernels": [
        {"name": "fused_gbm", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<GbmLog>)",
         "replaces": "orp_tpu/qmc/pallas_sobol.py:199", "launches": launches["fused_gbm"],
         "max_abs_err": k1_err, "ms": ms["fused_gbm"], "plain_ms": ms["fused_gbm_plain"],
         "bound_ms": bounds["fused_gbm"][0], "bound_by": bounds["fused_gbm"][1],
         "library_ms": None},
        {"name": "mixed_head", "route": "cuda", "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head"],
         "max_abs_err": k2_err, "ms": ms["mixed_head"], "plain_ms": ms["mixed_head_plain"],
         "bound_ms": bounds["mixed_head"][0], "bound_by": bounds["mixed_head"][1],
         "library_ms": None},
        # the same Pallas kernel as launched in bf16 by _eval_core_mixed(precision="bf16")
        {"name": "mixed_head_bf16", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu (orp_mixed_head_bf16_launch)",
         "replaces": "orp_tpu/serve/megakernel.py:85 (bf16)",
         "launches": launches["mixed_head_bf16"], "max_abs_err": k2b_err,
         "ms": k2t["north-star"]["bf16"], "plain_ms": k2t["north-star"]["bf16_plain"],
         "bound_ms": k2t["north-star"]["bf16_bound"][0],
         "bound_by": k2t["north-star"]["bf16_bound"][1], "library_ms": None},
        # both Heston entries are steps of one templated driver, mf_kernel<Step>, the
        # port of the generic driver _run_mf (orp_tpu/qmc/pallas_mf.py:106)
        {"name": "heston_qe", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<HestonQE>; driver _run_mf :106)",
         "replaces": "orp_tpu/qmc/pallas_mf.py:202", "launches": launches["heston_qe"],
         "max_abs_err": k3_err["qe"], "ms": ms["heston_qe"], "plain_ms": ms["heston_qe_plain"],
         "bound_ms": bounds["heston_qe"][0], "bound_by": bounds["heston_qe"][1],
         "library_ms": None},
        {"name": "heston_euler", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<HestonEuler>; driver _run_mf "
                   ":106)",
         "replaces": "orp_tpu/qmc/pallas_mf.py:155", "launches": launches["heston_euler"],
         "max_abs_err": k3_err["euler"], "ms": ms["heston_euler"],
         "plain_ms": ms["heston_euler_plain"], "bound_ms": bounds["heston_euler"][0],
         "bound_by": bounds["heston_euler"][1], "library_ms": None},
        {"name": "pension", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<Pension<kSV, kInversion>>; "
                   "driver _run_mf :106)",
         "replaces": "orp_tpu/qmc/pallas_mf.py:294", "launches": launches["pension"],
         "max_abs_err": k3c["err"], "ms": ms["pension"], "plain_ms": ms["pension_plain"],
         "bound_ms": bounds["pension"][0], "bound_by": bounds["pension"][1],
         "library_ms": None},
        # K2's Runtime<8> instance at the basket's vector head (5 features, 6 outputs),
        # launched by the basket policy's 1M-row serve block ([basket])
        {"name": "mixed_head_basket", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu (Runtime<8>)",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_basket"],
         "max_abs_err": basket["assets"]["k2_err"], "ms": k2b["f32"],
         "plain_ms": k2b["f32_plain"], "bound_ms": k2b["f32_bound"][0],
         "bound_by": k2b["f32_bound"][1], "library_ms": None},
        {"name": "mixed_head_bf16_basket", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu (orp_mixed_head_bf16_launch, Runtime<8>)",
         "replaces": "orp_tpu/serve/megakernel.py:85 (bf16)",
         "launches": launches["mixed_head_bf16_basket"],
         "max_abs_err": basket["assets"]["k2b_err"], "ms": k2b["bf16"],
         "plain_ms": k2b["bf16_plain"], "bound_ms": k2b["bf16_bound"][0],
         "bound_by": k2b["bf16_bound"][1], "library_ms": None},
        # K2 on the single-host serve path: the mixed-date lane's single-row
        # requests of the north star and the pension, one dispatch each ([host])
        {"name": "mixed_head_host", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_host"],
         "max_abs_err": hosted["k2_err"], "ms": hosted["k2_ms"],
         "plain_ms": hosted["k2_plain_ms"], "bound_ms": hosted["k2_bound"][0],
         "bound_by": hosted["k2_bound"][1], "library_ms": None},
        # K2 behind the socket: the mixed-date batch of single-row frames through
        # the TCP gateway, one dispatch ([gateway])
        {"name": "mixed_head_gateway", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_gateway"],
         "max_abs_err": gated["k2_err"], "ms": gated["k2_ms"],
         "plain_ms": gated["k2_plain_ms"], "bound_ms": gated["k2_bound"][0],
         "bound_by": gated["k2_bound"][1], "library_ms": None},
        # K1 in the compile-and-perf plane: profile_north_star(20)'s sim stage, the
        # same 1M x 364 store-7 launch as fused_gbm's (timed there)
        {"name": "fused_gbm_profile", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<GbmLog>)",
         "replaces": "orp_tpu/qmc/pallas_sobol.py:199", "launches": launches["fused_gbm_profile"],
         "max_abs_err": k1_err, "ms": ms["fused_gbm"], "plain_ms": ms["fused_gbm_plain"],
         "bound_ms": bounds["fused_gbm"][0], "bound_by": bounds["fused_gbm"][1],
         "library_ms": None},
        # K2 in serve_bench's megakernel phase (its f32 and int8 tiers), at that
        # phase's rows and the card-trained policy's shape ([serve-bench])
        {"name": "mixed_head_bench", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_bench"],
         "max_abs_err": plane["bench_k2_err"], "ms": plane["bench_k2_times"]["f32"],
         "plain_ms": plane["bench_k2_times"]["f32_plain"],
         "bound_ms": plane["bench_k2_times"]["f32_bound"][0],
         "bound_by": plane["bench_k2_times"]["f32_bound"][1], "library_ms": None},
        # K1 and K2 on the closed loop ([pilot]): the full-width calibration
        # cycle's warm-started retrain, and the mixed-date single rows served
        # through its swap; each held against its plain version at this path's
        # shapes (the retrain's sigma, the promoted params)
        {"name": "fused_gbm_pilot", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<GbmLog>)",
         "replaces": "orp_tpu/qmc/pallas_sobol.py:199", "launches": launches["fused_gbm_pilot"],
         "max_abs_err": piloted["k1_err"], "ms": piloted["k1_ms"],
         "plain_ms": piloted["k1_plain_ms"], "bound_ms": piloted["k1_bound"][0],
         "bound_by": piloted["k1_bound"][1], "library_ms": None},
        {"name": "mixed_head_pilot", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_pilot"],
         "max_abs_err": piloted["k2_err"], "ms": piloted["k2_ms"],
         "plain_ms": piloted["k2_plain_ms"], "bound_ms": piloted["k2_bound"][0],
         "bound_by": piloted["k2_bound"][1], "library_ms": None},
        # K1 and K2 through the command line ([cli]): `euro --engine pallas`'s
        # training and oos_ runs (the same 1M x 364 store-7 launch as
        # fused_gbm's, timed there), and `serve-bench --precision`'s megakernel
        # phase at its rows of the exported precision-test policy
        {"name": "fused_gbm_cli", "route": "cuda",
         "source": "orp_tpu_torch/csrc/fused_mf.cu (mf_kernel<GbmLog>)",
         "replaces": "orp_tpu/qmc/pallas_sobol.py:199", "launches": launches["fused_gbm_cli"],
         "max_abs_err": k1_err, "ms": ms["fused_gbm"], "plain_ms": ms["fused_gbm_plain"],
         "bound_ms": bounds["fused_gbm"][0], "bound_by": bounds["fused_gbm"][1],
         "library_ms": None},
        {"name": "mixed_head_cli", "route": "cuda",
         "source": "orp_tpu_torch/csrc/mixed_head.cu",
         "replaces": "orp_tpu/serve/megakernel.py:85", "launches": launches["mixed_head_cli"],
         "max_abs_err": commanded["k2_err"], "ms": commanded["k2_times"]["f32"],
         "plain_ms": commanded["k2_times"]["f32_plain"],
         "bound_ms": commanded["k2_times"]["f32_bound"][0],
         "bound_by": commanded["k2_times"]["f32_bound"][1], "library_ms": None},
    ]}
    print(f"[times] the single-host serve path: 1-row latency ServeHost "
          f"{hosted['lat_host_ms']:.3f} ms vs HedgeEngine {hosted['lat_engine_ms']:.3f} ms; "
          f"{N_FULL}-row submit_block {hosted['rps_host']:,.0f} rows/s vs engine "
          f"{hosted['rps_engine']:,.0f}; reload_tenant {hosted['reload_s']:.3f} s bitwise, "
          f"{hosted['reload_quality_s']:.3f} s quality-gated; activation cold "
          f"{hosted['cold_s']:.4f} s, warm {hosted['warm_s']:.4f} s; [host] "
          f"{hosted['phase_s']:.1f} s", flush=True)
    print(f"[times] the network plane: 1-row round trip TCP v1 {gated['lat_v1_ms']:.3f} ms, "
          f"v2 {gated['lat_v2_ms']:.3f} ms, ring {gated['lat_ring_ms']:.3f} ms vs ServeHost "
          f"{gated['lat_host_ms']:.3f} ms; {N_FULL}-row blocks v1 {gated['rps'][f'v1@{N_FULL}']:,.0f}"
          f", v2 {gated['rps'][f'v2@{N_FULL}']:,.0f}, ring {gated['rps'][f'ring@{N_FULL}']:,.0f} "
          f"rows/s; kill drill MTTR {gated['drill']['mttr_ms']:.1f} ms; [gateway] "
          f"{gated['phase_s']:.1f} s", flush=True)
    print(f"[times] the compile-and-perf plane: cold start {plane['cold_s']:.2f} s (nvcc "
          f"{plane['cold_nvcc_s']:.2f} s) vs {plane['aot_wall_s']:.2f} s from the AOT bundle; "
          f"1-row latency replay {plane['lat_aot_ms']:.3f} ms vs eager "
          f"{plane['lat_eager_ms']:.3f} ms; {N_FULL} rows replay {plane['rps_aot']:,.0f} vs "
          f"eager {plane['rps_eager']:,.0f} rows/s; degrade MTTR "
          f"{plane['degrade']['mttr_ms']:.3f} ms; [aot]..[serve-bench] {plane['phase_s']:.1f} s",
          flush=True)
    print(f"[times] the closed loop: drill {piloted['drill_s']:.2f} s, the full-width "
          f"calibration cycle {piloted['cycle_s']:.2f} s (time to promote "
          f"{piloted['time_to_promote_s']:.3f} s, 0 rows lost), resume "
          f"{piloted['resume_s']:.2f} s, doctor_report {piloted['doctor_s']:.2f} s; capture "
          f"fallbacks {piloted['capture_fallbacks']}; [pilot] {piloted['phase_s']:.1f} s",
          flush=True)
    print(f"[times] the command line: euro {commanded['euro_s']:.2f} s, export + serve-bench "
          f"{commanded['bench_s']:.2f} s, serve-gateway child ready "
          f"{commanded['gateway_ready_s']:.2f} s after spawn; [cli] {commanded['phase_s']:.2f} s",
          flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
