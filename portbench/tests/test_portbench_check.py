"""The check that decides ``correct``, driven through whole runs on the CPU at
a tiny size (the program's plain versions stand in for its kernels; the
harness's look for a card is skipped):

- a sound run of each cell reads ``correct``;
- with the timed path broken underneath, the same run reads not correct,
  once for each fault the cell can have: a training step that returns its
  state unchanged, each fit on half of the rows with the means over that
  half, and an answer altered where it is produced (a path kernel's output).
  The exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import json
import pathlib
import time

import pytest
import torch

from orp_tpu_torch.api import pipelines
from orp_tpu_torch.train import gn as program_gn
from portbench import calibrate, harness

ROOT = pathlib.Path(harness.__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"n_paths": 256, "sample_rows": 32, "profile_jobs": 1}
SEED = 2 ** 31 + 4099


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(name: str) -> dict:
    return harness.run_cell(SPEC, name, seed=SEED, seconds=0.0, trace=False, device="cpu",
                            t0=time.perf_counter(), overrides=TINY)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def _unchanged(monkeypatch):
    monkeypatch.setattr(program_gn._GNProblem, "iterate", lambda self: None)


def _half_batch(monkeypatch):
    def local_gram(self, theta):
        h = self.n // 2
        v, J = self.model.value_jacobian(self.model.unflatten(theta), self.features[:h],
                                         self.prices[:h])
        r = v - self.y[:h]
        Jw = J
        if self.w is not None:
            Jw = J * (torch.where(r < 0, *self.w) / torch.clamp(r.abs(), min=self.floor))[:, None]
        return Jw.T @ J / h, Jw.T @ r / h

    def loss(self, theta):
        h = self.n // 2
        pred = self.model.value(self.model.unflatten(theta), self.features[:h], self.prices[:h])
        return self.loss_fn(pred, self.y[:h])

    monkeypatch.setattr(program_gn._GNProblem, "_local_gram", local_gram)
    monkeypatch.setattr(program_gn._GNProblem, "loss", loss)


def _altered_knot(monkeypatch):
    """Path 0's knots moved by 5% where the kernel writes them: the fault
    ``calibrate.py`` plants, with the kernels restored after the test."""
    for name in ("gbm_log_fused", "pension_fused"):
        monkeypatch.setattr(pipelines, name, getattr(pipelines, name))
    calibrate._alter_knots()


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered_knot}
CASES = [(w["name"], f) for w in SPEC["workloads"] for f in FAULTS
         if f == "altered" or "train" in w["name"]]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(name)
    assert not r["correct"], r["compared"]
