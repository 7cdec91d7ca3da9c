#!/usr/bin/env python3
"""Warp-level divergence census of the multi-factor path kernels' plain versions.

    python3 tools/torch_warp_census.py [--device cpu | cuda] [--paths 4096]
                                       [--pension-steps 1000] [--heston-steps 364]

The fused kernels (``orp_tpu_torch/csrc/fused_mf.cu``) run one thread per path
with the 32 lanes of a warp on 32 consecutive path indices; a warp executes
every branch that any of its lanes takes, and a loop as often as its slowest
lane. This tool runs the plain versions (``sde.kernels.scan_sde`` with the
pension and QE-M steps, the arithmetic that ``qmc/fused_mf.py``'s
``pension_plain`` / ``heston_qe_plain`` run) on the given device, groups the
paths in warps of 32 consecutive indices and counts, per step:

- AS241: the share of warp-draws (one warp, one step, one normal factor)
  whose lanes take both branches (central ``|u - 0.5| <= 0.425`` and tail);
- K3c's inversion walk (``Pension<kSV=false, kInversion=true>``, the main
  path's variant, on chip_smoke.py's grid: T = 10, dt = 0.01, seed 1234):
  trips per warp-step (the largest count of its lanes) against trips per
  lane (the mean), and the part of the warp's count that comes from
  saturating lanes (the reference's f32 CDF plateau: all 128 trips), without
  and with the stuck-cdf exit of ``sde.kernels.binomial_inversion_deaths``;
- QE-M (``HestonQE``, chip_smoke.py's ``HestonConfig()`` grid, dt = 1/364,
  seed 4321): the share of lane-steps in the quadratic branch and of
  warp-steps that take both branches.

A lane's trip count is its death count ``D`` (the walk runs trip ``k`` while
``cdf_{k-1} < u``); a saturating lane (``D = 128``) stops, with the stuck
exit, at the first trip that leaves its cdf unchanged while the next
multiplier is at most 1/2. The counts come from the plain version's own
deaths. Prints one JSON object. A property of the paths, not a
device metric: ``--device cuda`` counts the card's paths, whose f32 ``exp``
moves the saturation plateau.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
WARP = 32

PENSION = dict(mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597, n0=10000.0, y0=1.0)
HESTON = dict(mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6)
PSI_C = 1.5


def as241_tail(u):
    """The AS241 branch of each uniform: True where ``|u - 0.5| > 0.425`` (the tail)."""
    return (u - 0.5).abs() > 0.425


def warp_groups(x, n_paths: int, fill):
    """``(n,)`` -> ``(n_warps, 32)``; a partial last warp is padded with ``fill``."""
    import torch

    pad = (-n_paths) % WARP
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=x.device)])
    return x.view(-1, WARP)


def mixed_warps(flag, active, n_paths: int) -> tuple[int, int]:
    """``(warps whose active lanes hold both values of flag, warps with an active lane)``."""
    f = warp_groups(flag & active, n_paths, False)
    g = warp_groups(~flag & active, n_paths, False)
    a = warp_groups(active, n_paths, False)
    return int((f.any(1) & g.any(1)).sum()), int(a.any(1).sum())


class Tally:
    def __init__(self):
        self.c = {}

    def add(self, key: str, num: float, den: float = 0.0) -> None:
        n, d = self.c.get(key, (0.0, 0.0))
        self.c[key] = (n + num, d + den)

    def ratio(self, key: str) -> float | None:
        n, d = self.c.get(key, (0.0, 0.0))
        return n / d if d else None

    def total(self, key: str) -> float:
        return self.c.get(key, (0.0, 0.0))[0]

    def mixed(self, key: str, flag, active, n_paths: int) -> None:
        """Count the warps of one draw whose active lanes take both AS241 branches,
        under ``key`` and under the total ``as241``."""
        for k in (key, "as241"):
            self.add(k, *mixed_warps(flag, active, n_paths))

    def as241(self) -> dict:
        keys = sorted(k[6:] for k in self.c if k.startswith("as241_"))
        return {"as241_warp_draws_mixed": self.ratio("as241"),
                "as241_warp_draws": int(self.c.get("as241", (0, 0))[1]),
                "as241_warp_draws_mixed_by_factor": {k: self.ratio("as241_" + k)
                                                     for k in keys}}


def walk_trips(u, pop, q, pmf0, z):
    """One step of K3c's inversion thinning: ``(deaths, trips, trips with the
    stuck exit, saturating lanes)``. A lane walks one trip per death where its
    mean death count is at most 45 and none where it draws the CLT normal; a
    saturating lane (128 deaths) stops, with the stuck exit, at the trip
    ``binomial_inversion_deaths`` marks it stuck (128 where it never is)."""
    import torch

    from orp_tpu_torch.sde.kernels import (_INVERSION_K, _INVERSION_MEAN_MAX,
                                           binomial_inversion_deaths)

    stuck_at = torch.full_like(pop, float(_INVERSION_K))
    deaths = binomial_inversion_deaths(u, pop, q, pmf0, z, stuck_at=stuck_at)
    walking = pop * q <= _INVERSION_MEAN_MAX
    trips = torch.where(walking, deaths, torch.zeros_like(deaths))
    sat = walking & (deaths == _INVERSION_K)
    return deaths, trips, torch.where(sat, stuck_at, trips), sat


def pension_census(n_paths: int, n_steps: int, device) -> dict:
    """K3c's main variant (constant vol, inversion) on T = 10 over ``n_steps``."""
    import torch

    from orp_tpu_torch.qmc.fused_gbm import ndtri_as241
    from orp_tpu_torch.qmc.fused_mf import PENSION_FACTORS, _raw_last_factor
    from orp_tpu_torch.sde import TimeGrid, kernels
    from orp_tpu_torch.sde.kernels import _INVERSION_MEAN_MAX

    dt = 10.0 / n_steps
    tally = Tally()

    def inverse_normal(u):
        active = torch.ones(n_paths, dtype=torch.bool, device=u.device)
        for f in (0, 1):  # the fund's and the mortality's normals (factor 2 unused)
            tally.mixed(f"as241_{f}", as241_tail(u[:, f]), active, n_paths)
        return _raw_last_factor(u)

    def thin(pop, lam, p, u, dt_):
        q = 1.0 - p
        pmf0 = torch.exp(-pop * lam * dt_)
        deaths, trips, exit_trips, sat = walk_trips(u, pop, q, pmf0, ndtri_as241(u))
        clt = ~(pop * q <= _INVERSION_MEAN_MAX)  # only these draw factor 3's AS241 normal
        tally.mixed("as241_3_clt", as241_tail(u), clt, n_paths)
        tally.add("clt_lane_steps", float(clt.sum()))
        live = torch.ones(n_paths, dtype=torch.bool, device=pop.device)
        n_warps = -(-n_paths // WARP)
        for name, tr in (("", trips), ("_exit", exit_trips)):
            w_all = warp_groups(tr, n_paths, 0.0).amax(1)
            w_rest = warp_groups(torch.where(sat, 0.0, tr), n_paths, 0.0).amax(1)
            tally.add("warp_trips" + name, float(w_all.double().sum()), n_warps)  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
            tally.add("sat_part" + name, float((w_all - w_rest).double().sum()), n_warps)  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
            tally.add("lane_trips" + name, float(tr.double().sum()), n_paths)  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
        tally.add("sat_lane_steps", float(sat.sum()), n_paths)
        tally.add("walk_warps_mixed", *mixed_warps(trips > 0, live, n_paths))
        return torch.clamp(pop - deaths, min=0.0)

    step = kernels.pension_step(mu=PENSION["mu"], sigma=PENSION["sigma"],
                                mort_c=PENSION["mort_c"], eta=PENSION["eta"],
                                sdt=math.sqrt(dt), thin=thin)
    state0 = kernels.pension_state0(n_paths, y0=PENSION["y0"], l0=PENSION["l0"],
                                    n0=PENSION["n0"], sv=False, v0=0.0, dtype=torch.float32,
                                    device=device)
    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    _, traj = kernels.scan_sde(step, state0, kernels._stack_state, idx,
                               TimeGrid(n_steps * dt, n_steps), PENSION_FACTORS, 1234,
                               store_every=n_steps, inverse_normal=inverse_normal)
    n_t = traj[:, -1, 2].double()  # orp: noqa[ORP001] -- a check's reduction in f64 on the host, not a path's dtype
    return {"paths": n_paths, "steps": n_steps, "dt": dt,
            **tally.as241(),
            "clt_lane_steps": int(tally.total("clt_lane_steps")),
            "walk_trips_per_warp_step": tally.ratio("warp_trips"),
            "walk_trips_per_lane_step": tally.ratio("lane_trips"),
            "walk_trips_per_warp_step_from_saturating_lanes": tally.ratio("sat_part"),
            "with_stuck_exit": {"walk_trips_per_warp_step": tally.ratio("warp_trips_exit"),
                                "walk_trips_per_lane_step": tally.ratio("lane_trips_exit"),
                                "walk_trips_per_warp_step_from_saturating_lanes":
                                    tally.ratio("sat_part_exit")},
            "saturating_lane_steps": int(tally.total("sat_lane_steps")),
            "warp_steps_with_walking_and_idle_lanes": tally.ratio("walk_warps_mixed"),
            "mean_N_T": float(n_t.mean())}


def heston_census(n_paths: int, n_steps: int, device) -> dict:
    """K3b (QE-M) on T = 1 over ``n_steps``: AS241 and variance-branch mixing."""
    import torch

    from orp_tpu_torch.qmc.fused_mf import N_FACTORS, _as241_first, _exact_complement
    from orp_tpu_torch.sde import TimeGrid, kernels

    dt = 1.0 / n_steps
    C = kernels.qe_step_constants(HESTON["kappa"], HESTON["theta"], HESTON["xi"],
                                  HESTON["rho"], dt)
    theta = HESTON["theta"]

    def quadratic(v):  # the kernel's branch test psi <= psi_c
        m = theta + (v - theta) * C["E"]
        return (v * C["c1"] + C["c2"]) / torch.clamp(m * m, min=1e-12) <= PSI_C

    tally = Tally()
    live = torch.ones(n_paths, dtype=torch.bool, device=device)
    state0 = kernels._heston_state0(n_paths, HESTON["v0"], torch.float32, device)
    branch = {"quad": quadratic(state0[1])}  # step t's branch, from the state before it

    def inverse_normal(u):
        quad = branch["quad"]
        tally.add("quad_lane_steps", float(quad.sum()), n_paths)
        tally.add("branch_mixed", *mixed_warps(quad, live, n_paths))
        tally.mixed("as241_0", as241_tail(u[:, 0]), live, n_paths)
        # the variance's AS241 runs only in the quadratic branch
        tally.mixed("as241_1", as241_tail(u[:, 1]), quad, n_paths)
        return _as241_first(u)

    inner = kernels.heston_qe_step(mu=HESTON["mu"], kappa=HESTON["kappa"], theta=theta,
                                   xi=HESTON["xi"], rho=HESTON["rho"], dt=dt, psi_c=PSI_C,
                                   variance_draw=_exact_complement)

    def step(state, z, t, dt_):
        out = inner(state, z, t, dt_)
        branch["quad"] = quadratic(out[1])
        return out

    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    kernels.scan_sde(step, state0, kernels._stack_state, idx, TimeGrid(n_steps * dt, n_steps),
                     N_FACTORS, 4321, store_every=n_steps, inverse_normal=inverse_normal)
    return {"paths": n_paths, "steps": n_steps, "dt": dt,
            **tally.as241(),
            "quadratic_share_of_lane_steps": tally.ratio("quad_lane_steps"),
            "warp_steps_with_both_qe_branches": tally.ratio("branch_mixed")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    ap.add_argument("--paths", type=int, default=4096)
    ap.add_argument("--pension-steps", type=int, default=1000)
    ap.add_argument("--heston-steps", type=int, default=364)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from orp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    out = {"device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "warp": WARP,
           "pension": pension_census(args.paths, args.pension_steps, dev),
           "heston_qe": heston_census(args.paths, args.heston_steps, dev)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
