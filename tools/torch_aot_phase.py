#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s compile-and-perf plane ([aot], [perf], [profile],
[degrade], [serve-bench]) alone on one card: build the kernels, then
``chip_smoke.aot_plane_phases``; print its lines, the card's name and power
limit, and a summary of its record as JSON.

    python3 tools/torch_aot_phase.py
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_aot_phase: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from orp_tpu_torch.qmc import fused_gbm, fused_mf
    from orp_tpu_torch.serve import megakernel
    from orp_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    counts = chip_smoke.Counts(
        fused_gbm=fused_gbm.gbm_log_fused, mixed_head=megakernel.mixed_head_forward,
        mixed_head_bf16=(megakernel.mixed_head_forward, "launches_bf16"),
        heston_qe=fused_mf.heston_qe_fused, heston_euler=fused_mf.heston_log_fused,
        pension=fused_mf.pension_fused)
    out = chip_smoke.aot_plane_phases(torch.device("cuda"), counts)
    print(chip_smoke.card_line())
    print(json.dumps({k: v for k, v in out.items() if k not in ("bench", "profile",
                                                               "profile_serve")},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
