"""On the card: the control, the plain reference put in the program's place and
computed in TF32, fails the check of every cell at a size a test run holds
(65,536 paths; the full-size readings are ``calibrate.py``'s)."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from portbench import calibrate, check, harness

ROOT = pathlib.Path(harness.__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"n_paths": 1 << 16, "sample_rows": 256}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 exists only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_the_tf32_control_is_not_correct(name, card):
    cell = harness.Cell(SPEC, name, SMALL)
    policy = harness.load_module(cell.entry).Job(cell.cfg, cell.traffic, card).reference_policy()
    seed = 2 ** 31 + 811
    rows = harness.sample_rows(seed, SMALL["n_paths"], SMALL["sample_rows"])
    kept = [calibrate._reference_record(cell, harness.job_seed(seed, i), rows, policy, card)
            for i in (1, 2)]
    numbers, _ = check.readings(cell.cfg, cell.traffic, kept, rows, policy, card)
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers
