"""What every job entry shares: the record a job leaves for the check, and the
committed policies, which the reference reads from their files itself."""

from __future__ import annotations

import pathlib

import numpy as np
import torch

BENCH = pathlib.Path(__file__).resolve().parent
LEDGERS = (("values", "values"), ("phi", "phi"), ("psi", "psi"), ("var", "var_residuals"))


def policy_dir(cfg: dict) -> pathlib.Path:
    return BENCH.parent / cfg["policy"]


def reference_policy(cfg: dict) -> dict:
    """The committed policy's per-date params ``{name: (D, ...)}``, read from
    its ``policy.npz`` by the reference, not through the program."""
    with np.load(policy_dir(cfg) / "policy.npz") as z:
        return {k.split("/", 1)[1]: torch.from_numpy(np.array(z[k], dtype=np.float32))
                for k in z.files if k.startswith("params1/")}


class Job:
    """A job entry's common part: ``run(seed)`` drives the program (the
    subclass), ``keep`` records what the check compares, ``full`` the last
    training job's whole value ledger."""

    train = False
    avoid_seeds: tuple = ()

    def keep(self, res, seed: int, rows: torch.Tensor) -> dict:
        bw, rep = res.backward, res.report
        rec = {"seed": seed,
               "rows": {k: getattr(bw, a).index_select(0, rows) for k, a in LEDGERS},
               "report": {"v0": float(rep.v0), "phi0": float(rep.phi0), "psi0": float(rep.psi0)}}
        if rep.v0_acv is not None:
            rec["report"]["v0_acv"] = float(rep.v0_acv)
        if self.train:
            rec["params"] = dict(bw.params1_by_date)
        return rec

    def full(self, res) -> dict:
        return {"values": res.backward.values}

    def reference_policy(self):
        return None
