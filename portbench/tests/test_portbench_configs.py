"""Every size a configuration file states is one that runs: the fields the
program takes from its own defaults (the ``gn`` block, the network) must
equal them, or the run fails at set-up; the reference takes the same fields
from the file, or refuses a network it does not compute."""

from __future__ import annotations

import copy
import json
import pathlib

import pytest

from portbench import harness, program_configs
from portbench.reference import gn, mlp

ROOT = pathlib.Path(harness.__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: harness.load_json(ROOT / c["file"]) for c in SPEC["configs"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_file_is_what_both_sides_run(name):
    cfg = CONFIGS[name]
    program_configs.check_fixed(cfg)
    mlp.check_model(cfg["model"])
    g = cfg["gn"]
    mse = gn.leg(cfg, 7, "mse")
    assert (mse.n_iters, mse.init_lambda, mse.lambda_up, mse.lambda_down, mse.min_rel_improve,
            mse.ridge, mse.loss) == (7, g["init_lambda"], g["lambda_up"], g["lambda_down"],
                                     g["min_rel_improve"], g["ridge"], "mse")
    if cfg["train"]["dual_mode"] == "shared":
        q = gn.leg(cfg, 7, "q")
        assert (q.init_lambda, q.weight_floor, q.q, q.loss) == (
            g["quantile_init_lambda"], g["weight_floor"], cfg["train"]["quantile"], "pinball")


CHANGES = [("gn", "init_lambda", 1e-3), ("gn", "ridge", 1e-6), ("gn", "lambda_up", 2.0),
           ("model", "negative_slope", 0.2), ("model", "hidden", [16, 16]),
           ("model", "init_scale", 0.5), ("model", "n_params", 1)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("group, key, value", CHANGES)
def test_a_field_that_would_not_run_is_refused(name, group, key, value):
    cfg = copy.deepcopy(CONFIGS[name])
    cfg[group][key] = value
    with pytest.raises(ValueError, match=key):
        program_configs.check_fixed(cfg)
    if group == "model" and key != "init_scale":  # the reference draws at the file's scale
        with pytest.raises(ValueError, match=key):
            mlp.check_model(cfg["model"])
