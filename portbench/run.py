"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and, with
``--trace 1``, ``breakdown``; then ``compared``, each number the check
compared beside its limit, which also end standard error. Exits non-zero,
printing no result, without a CUDA card (or fewer than the cell asks for), or
when a module of JAX or the JAX package is loaded once the window has closed.

The program's kernel-build cache and Triton's cache are kept at fixed paths
inside the checkout, under ``portbench/.cache/``, so only the first run of a
cell in a checkout builds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory in the checkout."""
    os.environ["ORP_TORCH_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    # the checkout's root, not this directory, is where imports resolve
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if pathlib.Path(p or ".").resolve() != BENCH]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    from portbench import harness

    result = harness.run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
