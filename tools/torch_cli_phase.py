#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s [cli] phase alone on one card (the command line,
``orp_tpu_torch/cli.py``): build the kernels, train the north-star policy as
the smoke's phase 9 does (1,048,576 paths x 364 steps, GN 30 + 51 x 10), then
``chip_smoke.cli_phases``; print its lines, the card's name and power limit,
and its record as JSON.

    python3 tools/torch_cli_phase.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_phase: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge
    from orp_tpu_torch.cli import result_line
    from orp_tpu_torch.qmc import fused_gbm, fused_mf
    from orp_tpu_torch.serve import megakernel
    from orp_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    counts = chip_smoke.Counts(
        fused_gbm=fused_gbm.gbm_log_fused, mixed_head=megakernel.mixed_head_forward,
        mixed_head_bf16=(megakernel.mixed_head_forward, "launches_bf16"),
        heston_qe=fused_mf.heston_qe_fused, heston_euler=fused_mf.heston_log_fused,
        pension=fused_mf.pension_fused)
    t0 = time.perf_counter()
    eh = european_hedge(EuropeanConfig(constrain_self_financing=False),
                        SimConfig(n_paths=chip_smoke.N_FULL, T=1.0, dt=1 / chip_smoke.N_STEPS,
                                  rebalance_every=chip_smoke.STORE, engine="pallas"),
                        TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"))
    line = result_line(eh.report)
    params = {k: v.detach().cpu().clone() for k, v in eh.backward.params1_by_date.items()}
    del eh
    print(f"[cli] the north star trained in {time.perf_counter() - t0:.2f} s", flush=True)
    out = chip_smoke.cli_phases(torch.device("cuda"), counts, line, params)
    print(chip_smoke.card_line())
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
