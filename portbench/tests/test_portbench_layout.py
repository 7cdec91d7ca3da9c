"""The benchmark's files hold together: every cell's configuration, traffic,
limits and entry exist, every per-layer metric moves one end-to-end metric
that each of its cells reports, and a cell added as new files is found with
no edit to a file that exists."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil

import pytest

from portbench import harness

BENCH = pathlib.Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist_and_load(name):
    cell = harness.Cell(SPEC, name)
    assert cell.entry.exists()
    assert cell.traffic["job"] in ("train", "revalue")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("path", sorted((BENCH / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_traffic_file_loads_and_is_used(path):
    traffic = json.loads(path.read_text())
    assert traffic["n_paths"] > traffic["sample_rows"] >= 2 and traffic["profile_jobs"] >= 1
    assert any(w["traffic"] == path.stem for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_each_of_its_cells_reports(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moves = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert "workloads" not in moves or cell in moves["workloads"]
    assert (BENCH / "metrics" / f"{metric['name']}.py").exists()


def test_a_cell_added_as_new_files_is_found(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (copy / "workloads" / "train-gn-dummy.json").write_text(json.dumps(
        {"job": "train", "n_paths": 4096, "sample_rows": 16, "profile_jobs": 1}))
    (copy / "limits" / "euro-train-dummy.json").write_text(json.dumps({"ledger_gap": 1e-3}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "euro-train-dummy", "config": "euro_call_north_star",
                              "traffic": "train-gn-dummy", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "euro-train-gn" in m.get("workloads", ()):
            m["workloads"].append("euro-train-dummy")
    copied = importlib.util.spec_from_file_location("harness_copy", copy / "harness.py")
    mod = importlib.util.module_from_spec(copied)
    copied.loader.exec_module(mod)
    mod.ROOT = tmp_path
    cell = mod.Cell(spec, "euro-train-dummy")
    assert cell.traffic["n_paths"] == 4096
    assert cell.entry == copy / "entries" / "european_train.py"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "train_s"}
    assert "walk_s.train" in {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("names, found", [
    (["jax.numpy", "numpy"], ["jax"]),
    (["orp_tpu.api", "torch"], ["orp_tpu"]),
    (["orp_tpu_torch.api", "orp_tpu_torch", "jaxtyping"], []),
    (["flax.linen", "jaxlib.xla_client"], ["flax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_job_seeds_and_rows_come_from_the_run_seed():
    big = 2 ** 31 + 977
    assert harness.job_seed(big, 3) == harness.job_seed(big, 3) != harness.job_seed(big, 4)
    s = harness.job_seed(big, 1)
    assert harness.job_seed(big, 1, avoid={s}) != s
    rows = harness.sample_rows(big, 1000, 32)
    assert rows.tolist() == harness.sample_rows(big, 1000, 32).tolist()
    assert rows[0] == 0 and rows[-1] == 999 and len(set(rows.tolist())) == 32
