"""Fused multi-factor path generators: 2-factor Heston and the 4-factor
pension system (counterpart of ``orp_tpu/qmc/pallas_mf.py``).

Per path and step each factor ``f`` draws Sobol dimension
``(t-1)*n_factors + f`` of the path's own index (scrambled as in
``qmc/fused_gbm.py``); the state advances in registers and only the
rebalance knots are stored. The functions return the JAX functions' dicts
of ``(n_paths, n_knots)`` tensors: Heston ``{"S": s0 * exp(logs), "v": v}``
(the kernel stores ``S`` itself), the pension ``{"Y", "lam", "N"}`` (+
``"v"`` with ``sv``).

- :func:`heston_log_fused` / :func:`heston_qe_fused` / :func:`pension_fused`
  are the wrappers: the CUDA kernel (``csrc/fused_mf.cu``, the templated
  driver with the ``HestonEuler`` / ``HestonQE`` / ``Pension`` steps) for a
  CUDA device, the plain version for the CPU. On the card they launch the
  kernel or raise; they never fall back.
- :func:`heston_log_plain` / :func:`heston_qe_plain` / :func:`pension_plain`
  are the same arithmetic in plain PyTorch: ``sde.kernels.scan_sde`` with
  AS241 as the inverse normal and the shared steps; QE's variance factor and
  the pension's inversion factor are the raw uniform (the exact complement
  ``1 - u``; the inversion without the ``ndtri``/``ndtr`` round trip).

The knots are stored knot-major, ``(n_knots, n_paths)``; the wrappers return
transposed views.
"""

from __future__ import annotations

import ctypes
import math

import torch

from orp_tpu_torch.qmc.fused_gbm import ndtri_as241
from orp_tpu_torch.qmc.sobol import N_DIMS, direction_numbers
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.device import resolve_device

N_FACTORS = 2
PENSION_FACTORS = 4  # fund, mortality, CIR vol (sv only), population


def _check(n_paths: int, n_steps: int, store_every: int, n_factors: int = N_FACTORS) -> int:
    if not 1 <= n_paths <= 1 << 32:
        raise ValueError(f"n_paths {n_paths} must be in [1, 2^32] (uint32 path index)")
    if n_steps < 1 or n_steps % store_every:
        raise ValueError(f"store_every={store_every} must divide n_steps={n_steps}")
    if n_steps * n_factors > N_DIMS:
        raise ValueError(f"n_steps*n_factors = {n_steps * n_factors} exceeds the "
                         f"{N_DIMS}-dimension Sobol direction table")
    return n_steps // store_every + 1


def _as241_first(u: torch.Tensor) -> torch.Tensor:
    """Factor 0 through AS241, factor 1 left as the raw uniform (QE's draw)."""
    return torch.stack([ndtri_as241(u[:, 0]), u[:, 1]], dim=1)


def _exact_complement(u: torch.Tensor):
    return ndtri_as241(u), torch.clamp(1.0 - u, min=1e-12)


def _plain(step, n_paths, n_steps, s0, v0, dt, seed, store_every, device, inverse_normal):
    from orp_tpu_torch.sde import TimeGrid, kernels  # sde imports qmc when it loads

    _check(n_paths, n_steps, store_every)
    dev = torch.device(device)
    idx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    _, traj = kernels.scan_sde(
        step, kernels._heston_state0(n_paths, v0, torch.float32, dev), kernels._stack_state,
        idx, TimeGrid(n_steps * dt, n_steps), N_FACTORS, seed,
        store_every=store_every, inverse_normal=inverse_normal)
    return kernels._heston_out(s0, traj)


def heston_log_plain(n_paths: int, n_steps: int, *, s0: float, mu: float, v0: float,
                     kappa: float, theta: float, xi: float, rho: float, dt: float,
                     seed: int = 1234, store_every: int = 1, device="cpu") -> dict:
    """Plain version of the Euler kernel: ``{"S", "v"}`` of ``(n_paths, n_knots)``."""
    from orp_tpu_torch.sde.kernels import heston_euler_step

    step = heston_euler_step(mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho,
                             sdt=math.sqrt(dt))
    return _plain(step, n_paths, n_steps, s0, v0, dt, seed, store_every, device, ndtri_as241)


def heston_qe_plain(n_paths: int, n_steps: int, *, s0: float, mu: float, v0: float,
                    kappa: float, theta: float, xi: float, rho: float, dt: float,
                    seed: int = 1234, store_every: int = 1, psi_c: float = 1.5,
                    device="cpu") -> dict:
    """Plain version of the QE-M kernel: ``{"S", "v"}`` of ``(n_paths, n_knots)``."""
    from orp_tpu_torch.sde.kernels import heston_qe_step

    step = heston_qe_step(mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho, dt=dt,
                          psi_c=psi_c, variance_draw=_exact_complement)
    return _plain(step, n_paths, n_steps, s0, v0, dt, seed, store_every, device, _as241_first)


def _thin_raw_inversion(pop, lam, p, u, dt):
    """The kernel's inversion thinning: ``u`` is factor 3's raw uniform,
    ``pmf(0) = p^n = exp(-n lam dt)`` needs no log, the CLT normal is AS241(u)."""
    from orp_tpu_torch.sde.kernels import binomial_inversion_deaths

    q = 1.0 - p
    pmf0 = torch.exp(-pop * lam * dt)
    deaths = binomial_inversion_deaths(u, pop, q, pmf0, ndtri_as241(u))
    return torch.clamp(pop - deaths, min=0.0)


def _raw_last_factor(u: torch.Tensor) -> torch.Tensor:
    """Factors 0-2 through AS241, factor 3 left as the raw uniform (the inversion's)."""
    return torch.cat([ndtri_as241(u[:, :3]), u[:, 3:]], dim=1)


def _check_pension(sigma, sv: bool, binomial_mode: str, name: str) -> None:
    from orp_tpu_torch.sde.kernels import check_binomial_mode

    if not sv and sigma is None:
        raise ValueError(f"{name}: sigma is required when sv=False (constant-vol fund)")
    check_binomial_mode(binomial_mode, name, exact=False)


def pension_plain(n_paths: int, n_steps: int, *, y0: float, mu: float, sigma: float | None,
                  l0: float, mort_c: float, eta: float, n0: float, dt: float, seed: int = 1234,
                  store_every: int = 1, sv: bool = False, v0: float = 0.0, cir_a: float = 0.0,
                  cir_b: float = 0.0, cir_c: float = 0.0, cir_drift_times_dt: bool = False,
                  binomial_mode: str = "normal", device="cpu") -> dict:
    """Plain version of the pension kernel: ``{"Y", "lam", "N"}`` (+ ``"v"``)
    of ``(n_paths, n_knots)``. In ``inversion`` mode factor 3 is the raw
    uniform, with ``pmf0 = exp(-pop lam dt)`` and the CLT normal ``AS241(u)``."""
    from orp_tpu_torch.sde import TimeGrid, kernels  # sde imports qmc when it loads

    _check_pension(sigma, sv, binomial_mode, "pension_plain")
    _check(n_paths, n_steps, store_every, PENSION_FACTORS)
    inversion = binomial_mode == "inversion"
    dev = torch.device(device)
    step = kernels.pension_step(
        mu=mu, sigma=sigma, mort_c=mort_c, eta=eta, sdt=math.sqrt(dt),
        thin=_thin_raw_inversion if inversion else kernels.thin_normal, sv=sv, cir_a=cir_a,
        cir_b=cir_b, cir_c=cir_c, cir_drift_times_dt=cir_drift_times_dt)
    state0 = kernels.pension_state0(n_paths, y0=y0, l0=l0, n0=n0, sv=sv, v0=v0,
                                    dtype=torch.float32, device=dev)
    idx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    _, traj = kernels.scan_sde(step, state0, kernels._stack_state, idx,
                               TimeGrid(n_steps * dt, n_steps), PENSION_FACTORS, seed,
                               store_every=store_every,
                               inverse_normal=_raw_last_factor if inversion else ndtri_as241)
    return kernels.pension_out(traj, y0=y0, sv=sv)


def _kernel() -> ctypes.CDLL:
    """The built library with its launch functions' C signatures declared."""
    lib = cuda_build.load("fused_mf")
    head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)]
    lib.orp_heston_euler_launch.argtypes = head + [ctypes.c_void_p]
    lib.orp_heston_qe_launch.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
    lib.orp_pension_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    for fn in (lib.orp_heston_euler_launch, lib.orp_heston_qe_launch, lib.orp_pension_launch):
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, consts: list[float], extra: tuple, n_paths, n_steps, s0, seed,
            store_every, dev) -> dict:
    n_knots = _check(n_paths, n_steps, store_every)
    lib = _kernel()
    consts = [*consts, s0]  # the kernel stores S = s0 * exp(log-return)
    c = (ctypes.c_float * len(consts))(*consts)  # host f64 -> f32, rounded once
    with torch.cuda.device(dev):
        dirs = direction_numbers(n_steps * N_FACTORS, device=dev, dtype=torch.int32)
        s = torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
        v = torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
        rc = getattr(lib, name)(dirs.data_ptr(), s.data_ptr(), v.data_ptr(), n_paths,
                                n_steps, store_every, int(seed) & 0xFFFFFFFF, c, *extra,
                                torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, name)
    return {"S": s.t(), "v": v.t()}


def _device(device, name: str) -> torch.device:
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def heston_log_fused(n_paths: int, n_steps: int, *, s0: float, mu: float, v0: float,
                     kappa: float, theta: float, xi: float, rho: float, dt: float,
                     seed: int = 1234, store_every: int = 1, device=None) -> dict:
    """Fused full-truncation-Euler Heston, ``{"S", "v"}`` of ``(n_paths, n_knots)``.

    Same semantics as ``heston_log_pallas`` (and ``simulate_heston_log`` with
    Owen scrambling). ``device=None`` is the card; a CPU device runs
    :func:`heston_log_plain`."""
    dev = _device(device, "heston_log_fused")
    kw = dict(s0=s0, mu=mu, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho, dt=dt,
              seed=seed, store_every=store_every)
    if dev.type == "cpu":
        return heston_log_plain(n_paths, n_steps, device=dev, **kw)
    consts = [v0, mu, kappa, theta, xi, rho, math.sqrt(1.0 - rho * rho), dt, math.sqrt(dt)]
    out = _launch("orp_heston_euler_launch", consts, (), n_paths, n_steps, s0, seed,
                  store_every, dev)
    heston_log_fused.launches += 1
    return out


def heston_qe_fused(n_paths: int, n_steps: int, *, s0: float, mu: float, v0: float,
                    kappa: float, theta: float, xi: float, rho: float, dt: float,
                    seed: int = 1234, store_every: int = 1, psi_c: float = 1.5,
                    device=None) -> dict:
    """Fused Andersen QE-M Heston, ``{"S", "v"}`` of ``(n_paths, n_knots)``.

    Same semantics as ``heston_qe_pallas``: the host-f64 ``qe_step_constants``,
    the raw-uniform variance factor with the exact complement ``1 - u``, and
    the martingale correction where ``A <= 0`` (plain-QE drift otherwise).
    ``device=None`` is the card; a CPU device runs :func:`heston_qe_plain`."""
    from orp_tpu_torch.sde.kernels import qe_step_constants

    dev = _device(device, "heston_qe_fused")
    kw = dict(s0=s0, mu=mu, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho, dt=dt,
              seed=seed, store_every=store_every, psi_c=psi_c)
    if dev.type == "cpu":
        return heston_qe_plain(n_paths, n_steps, device=dev, **kw)
    C = qe_step_constants(kappa, theta, xi, rho, dt)
    consts = [v0, theta, C["E"], C["c1"], C["c2"], C["k1"], C["k2"], C["k3"], C["k4"],
              C["A"], C["k1"] + 0.5 * C["k3"], mu * dt, -rho * kappa * theta * dt / xi, psi_c]
    out = _launch("orp_heston_qe_launch", consts, (int(C["A"] <= 0.0),), n_paths, n_steps,
                  s0, seed, store_every, dev)
    heston_qe_fused.launches += 1
    return out


def pension_fused(n_paths: int, n_steps: int, *, y0: float, mu: float, sigma: float | None,
                  l0: float, mort_c: float, eta: float, n0: float, dt: float, seed: int = 1234,
                  store_every: int = 1, sv: bool = False, v0: float = 0.0, cir_a: float = 0.0,
                  cir_b: float = 0.0, cir_c: float = 0.0, cir_drift_times_dt: bool = False,
                  binomial_mode: str = "normal", device=None) -> dict:
    """Fused coupled pension system, ``{"Y", "lam", "N"}`` (+ ``"v"`` with
    ``sv``) of ``(n_paths, n_knots)``: the semantics of ``pension_pallas``
    (and of ``simulate_pension`` in ``normal`` / ``inversion`` mode). Raises
    for ``sigma=None`` without ``sv`` and for ``binomial_mode="exact"``.
    ``device=None`` is the card; a CPU device runs :func:`pension_plain`."""
    dev = _device(device, "pension_fused")
    kw = dict(y0=y0, mu=mu, sigma=sigma, l0=l0, mort_c=mort_c, eta=eta, n0=n0, dt=dt,
              seed=seed, store_every=store_every, sv=sv, v0=v0, cir_a=cir_a, cir_b=cir_b,
              cir_c=cir_c, cir_drift_times_dt=cir_drift_times_dt, binomial_mode=binomial_mode)
    if dev.type == "cpu":
        return pension_plain(n_paths, n_steps, device=dev, **kw)
    _check_pension(sigma, sv, binomial_mode, "pension_fused")
    n_knots = _check(n_paths, n_steps, store_every, PENSION_FACTORS)
    sdt = math.sqrt(dt)
    consts = [y0, v0, l0, n0, 1 + mu * dt, (sigma or 0.0) * sdt, mu, sdt, cir_a, cir_b, cir_c,
              dt if cir_drift_times_dt else 1.0, mort_c, dt, eta * sdt]
    lib = _kernel()
    c = (ctypes.c_float * len(consts))(*consts)  # host f64 -> f32, rounded once
    with torch.cuda.device(dev):
        dirs = direction_numbers(n_steps * PENSION_FACTORS, device=dev, dtype=torch.int32)
        slots = [torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
                 for _ in range(4 if sv else 3)]
        ptrs = [t.data_ptr() for t in slots] + [None] * (4 - len(slots))
        rc = lib.orp_pension_launch(dirs.data_ptr(), *ptrs, n_paths, n_steps, store_every,
                                    int(seed) & 0xFFFFFFFF, c, int(sv),
                                    int(binomial_mode == "inversion"),
                                    torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "orp_pension_launch")
    pension_fused.launches += 1
    if sv:
        logy, v, lam, pop = (t.t() for t in slots)
        return {"Y": y0 * torch.exp(logy), "v": v, "lam": lam, "N": pop}
    y, lam, pop = (t.t() for t in slots)
    return {"Y": y, "lam": lam, "N": pop}


heston_log_fused.launches = 0
heston_qe_fused.launches = 0
pension_fused.launches = 0
