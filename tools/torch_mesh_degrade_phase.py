#!/usr/bin/env python3
"""Run ``chip_smoke.py`` [mesh] (b)'s AOT sets and degradation alone on one
card: the committed north-star policy exported with sets for 4, 2 and 1
rank(s) (``chip_smoke.export_mesh_sets``), then four ``gloo`` ranks sharing
the card (``tools/torch_mesh_ranks.py`` jobs ``aot``, ``degrade`` and
``device_mesh_probe``) checked by ``chip_smoke.mesh_aot_degrade_checks``;
print its lines, the torch and CUDA versions, the card's name and power
limit, and the record as JSON.

    python3 tools/torch_mesh_degrade_phase.py
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
        print("torch_mesh_degrade_phase: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    def say(ok: bool, what: str) -> None:
        chip_smoke.check(ok, what)
        print(f"{what}: ok", flush=True)

    work = ROOT / "build" / "mesh"
    sizes = [1, 7, 33] + [1 << k for k in range(3, 21)]
    t0 = time.perf_counter()
    bundle, export_s = chip_smoke.export_mesh_sets(work / "aot_bundle", sizes)
    print(f"[mesh] (b) sets n4, n2, n1 exported in {export_s:.3f} s", flush=True)
    res = chip_smoke.mesh_tool().launch(
        4, {"device_mesh_probe": True,
            "aot": {"bundle": str(bundle), "sizes": sizes},
            "degrade": {"bundle": str(bundle), "scenarios": [chip_smoke.MESH_DEGRADE]}},
        work / "gloo_aot", device="cuda", backend="gloo", timeout=600)
    out = chip_smoke.mesh_aot_degrade_checks(res, bundle, sizes, say)
    out["launch_s"] = time.perf_counter() - t0
    out["export_s"] = export_s
    out["device_mesh_probe"] = [r["device_mesh_probe"] for r in res]
    print(f"[mesh] DeviceMesh over ranks 0 and 1 on each of 4 ranks: "
          f"{out['device_mesh_probe']}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(chip_smoke.card_line())
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
