#!/usr/bin/env python3
"""SHA-256 digests of the path kernels' and the mixed-date head's outputs on
the card, with their build report and, on request, their times and SASS
census.

    python3 tools/torch_kernel_digest.py [--tree DIR] [--time] [--sass]

Runs the kernels at ``chip_smoke.py``'s main-path shapes and seeds, each once
at 1,048,576 paths: K1 (``gbm_log_fused``) over 364 steps stored every 7 and,
as ``fused_gbm_dense``, stored every step (365 knots), both with the smoke's
out-of-sample seed; K3a (``heston_log_fused``) and K3b (``heston_qe_fused``)
over 364 steps stored every 7 (seed 4321); K3c (``pension_fused``) over 1,000
steps stored every 25 (seed 1234) in its four variants (constant-vol or SV
fund, ``normal`` or ``inversion`` thinning); and K2
(``serve/megakernel.mixed_head_forward``) on 1,048,576 rows of the committed
north-star policy over its 52 dates (the smoke's generator seed 7), on the
first 4,096 of those rows (``mixed_head_*_4096``), and at the pension serve
shape (``mixed_head_*_pension``: ``HedgeMLP(n_features=3)``, 122 params, 40
dates, 1,048,576 rows, params and rows from generator seed 17), each in f32
and, where the tree has the bf16 kernel, in bf16. It prints one line per
run: the SHA-256 of the wrapper's outputs (each key's name and its float32
bytes, keys sorted), then one JSON object. A redesign that must keep every
output bitwise is checked by running this before and after it on one card:
the digests must be equal. A digest also depends on nvcc and libdevice, so
it is compared within one toolkit, never pinned in code.

- ``--tree DIR`` imports ``orp_tpu_torch`` from another checkout (a parent
  commit unpacked with ``git archive``) and builds its kernels there; the
  build report is filtered with this checkout's ``chip_smoke.ptxas_lines``.
  Comparing two trees on one card is one call of this tool per tree, in turns
  (parent, change, change, parent).
- ``--time`` adds CUDA-event medians (5 rounds) of each run
  (``orp_tpu_torch/utils/measure.cuda_ms`` of this checkout).
- ``--sass`` adds each kernel's static SASS instruction count and its most
  frequent opcodes (``cuobjdump -sass``, beside ``nvcc``), for every library
  the tree builds.

Needs a CUDA card: it raises without one.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runs(smoke, dev) -> dict:
    """``{name: zero-argument call}`` of the kernel runs at the smoke's shapes."""
    import torch

    from orp_tpu_torch import NORTH_STAR_POLICY
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.qmc import fused_gbm, fused_mf
    from orp_tpu_torch.serve import load_bundle, megakernel

    heston = dict(smoke.HESTON, dt=1.0 / smoke.N_STEPS, seed=smoke.OOS_SEED,
                  store_every=smoke.STORE, device=dev)
    pension = dict(dt=10.0 / smoke.PENSION_STEPS, seed=1234, store_every=smoke.PENSION_STORE,
                   device=dev)
    gbm = dict(s0=100.0, drift=0.08, sigma=0.15, dt=1.0 / smoke.N_STEPS, seed=smoke.OOS_SEED,
               store_every=smoke.STORE, device=dev)
    n = smoke.N_FULL
    out = {"fused_gbm": lambda: {"S": fused_gbm.gbm_log_fused(n, smoke.N_STEPS, **gbm)},
           "fused_gbm_dense": lambda: {"S": fused_gbm.gbm_log_fused(
               n, smoke.N_STEPS, **dict(gbm, store_every=1))},
           "heston_euler": lambda: fused_mf.heston_log_fused(n, smoke.N_STEPS, **heston),
           "heston_qe": lambda: fused_mf.heston_qe_fused(n, smoke.N_STEPS, **heston)}
    for sv in (False, True):
        for mode in ("inversion", "normal"):
            kw = dict(smoke.PENSION_SV if sv else smoke.PENSION, binomial_mode=mode, **pension)
            out[f"pension_{'sv' if sv else 'const'}_{mode}"] = (
                lambda kw=kw: fused_mf.pension_fused(n, smoke.PENSION_STEPS, **kw))
    policy = load_bundle(NORTH_STAR_POLICY)
    gen = torch.Generator(device=dev).manual_seed(7)
    dates = torch.randint(0, policy.n_dates, (n,), device=dev, generator=gen, dtype=torch.int32)
    feats = (1.0 + 0.1 * torch.randn(n, 1, device=dev, generator=gen)).contiguous()
    # the pension serve shape: 3 features, 40 dates, seeded params and rows
    pension_model, pension_dates = HedgeMLP(n_features=3), 40
    gen = torch.Generator(device=dev).manual_seed(17)
    pension_p = {}
    sizes = pension_model.layer_sizes
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        pension_p[f"w{i}"] = 0.5 * torch.randn(pension_dates, a, b, device=dev, generator=gen)
        pension_p[f"b{i}"] = 0.1 * torch.randn(pension_dates, b, device=dev, generator=gen)
    heads = {"": (policy.model, policy.backward.params1_by_date, dates, feats),
             "_4096": (policy.model, policy.backward.params1_by_date, dates[:4096],
                       feats[:4096]),
             "_pension": (pension_model, pension_p,
                          torch.randint(0, pension_dates, (n,), device=dev, generator=gen,
                                        dtype=torch.int32),
                          1.0 + 0.1 * torch.randn(n, 3, device=dev, generator=gen))}
    dtypes = {"f32": torch.float32}
    if hasattr(megakernel.mixed_head_forward, "launches_bf16"):
        dtypes["bf16"] = torch.bfloat16
    for name, dt in dtypes.items():
        for shape, (model, params, d, x) in heads.items():
            m = model.with_dtype(dt)
            p = {k: v.to(dev, dt) for k, v in params.items()}
            packed = megakernel.pack_head_params(m, p)
            f = x.to(dt).contiguous()
            out[f"mixed_head_{name}{shape}"] = (
                lambda m=m, p=p, d=d, f=f, packed=packed:
                {"out": megakernel.mixed_head_forward(m, p, d, f, packed=packed)})
    return out


def digest(outs: dict) -> tuple[str, dict[str, str]]:
    """SHA-256 over every output (name, then float32 bytes), and one per output."""
    import torch

    whole, each = hashlib.sha256(), {}
    for k in sorted(outs):
        data = outs[k].contiguous().to(torch.float32).cpu().numpy().tobytes()
        whole.update(k.encode())
        whole.update(data)
        each[k] = hashlib.sha256(data).hexdigest()
    return whole.hexdigest(), each


def sass_census(lib_path: pathlib.Path, nvcc: str) -> dict:
    """Static SASS instruction count and the 12 most frequent opcodes per kernel."""
    tool = pathlib.Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m and m.group(1) != "NOP":
            found[name][m.group(1).split(".")[0]] += 1
    return {k: {"instructions": sum(c.values()), "top": dict(c.most_common(12))}
            for k, c in found.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout to import orp_tpu_torch from")
    ap.add_argument("--time", action="store_true", help="also time each kernel (CUDA events)")
    ap.add_argument("--sass", action="store_true", help="also count each kernel's SASS")
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch_kernel_digest needs a CUDA card; none is available")
    smoke = _module(ROOT / "chip_smoke.py", "_smoke_constants")
    measure = _module(ROOT / "orp_tpu_torch" / "utils" / "measure.py", "_measure")
    from orp_tpu_torch.utils import cuda_build

    check = pathlib.Path(cuda_build.__file__).resolve()
    if not check.is_relative_to(tree):
        raise RuntimeError(f"orp_tpu_torch came from {check}, not from {tree}")
    dev = torch.device("cuda")
    reports = cuda_build.build_all()
    build = {n: smoke.ptxas_lines(log) for n, log in reports.items()}
    for n, lines in build.items():
        for line in lines:
            print(f"[build] {n}: {line}", flush=True)
    result = {"tree": str(tree), "card": smoke.card_line(), "digests": {}, "outputs": {},
              "build": build}
    calls = runs(smoke, dev)
    for name, call in calls.items():
        outs = call()
        torch.cuda.synchronize()
        whole, each = digest(outs)
        result["digests"][name], result["outputs"][name] = whole, each
        print(f"[digest] {name}: {whole}", flush=True)
        del outs
    if args.time:
        reps = {"pension": 5, "mixed_head": 200}
        result["ms"] = {}
        for name, call in calls.items():
            n = next((v for k, v in reps.items() if name.startswith(k)), 10)
            result["ms"][name] = measure.cuda_ms(call, reps=n)
            print(f"[time] {name}: {result['ms'][name]:.4f} ms (median of 5 rounds of {n})",
                  flush=True)
    if args.sass:
        result["sass"] = {}
        for lib in reports:
            result["sass"].update(sass_census(cuda_build.lib_path(lib), cuda_build.nvcc_path()))
        for name, c in result["sass"].items():
            print(f"[sass] {name}: {c['instructions']} instructions; {c['top']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
