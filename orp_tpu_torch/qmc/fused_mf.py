"""Fused 2-factor Heston path generators (counterpart of ``orp_tpu/qmc/pallas_mf.py``).

Per path and step each factor ``f`` draws Sobol dimension ``(t-1)*2 + f`` of
the path's own index (scrambled as in ``qmc/fused_gbm.py``); the state
``(log-return, variance)`` advances in registers and only the rebalance knots
are stored. Both functions return ``{"S": s0 * exp(logs), "v": v}`` of
``(n_paths, n_knots)``, the JAX functions' shapes.

- :func:`heston_log_fused` / :func:`heston_qe_fused` are the wrappers: the
  CUDA kernel (``csrc/fused_mf.cu``, the templated driver with the
  ``HestonEuler`` / ``HestonQE`` steps) for a CUDA device, the plain version
  for the CPU. On the card they launch the kernel or raise; they never fall
  back.
- :func:`heston_log_plain` / :func:`heston_qe_plain` are the same arithmetic
  in plain PyTorch: ``sde.kernels.scan_sde`` with AS241 as the inverse normal
  and the shared Heston steps; for QE the variance factor is the raw uniform,
  so the exponential branch's complement is the exact ``1 - u``.

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


def _check(n_paths: int, n_steps: int, store_every: int) -> int:
    if not 1 <= n_paths <= 1 << 32:
        raise ValueError(f"n_paths {n_paths} must be in [1, 2^32] (uint32 path index)")
    if n_steps < 1 or n_steps % store_every:
        raise ValueError(f"store_every={store_every} must divide n_steps={n_steps}")
    if n_steps * N_FACTORS > N_DIMS:
        raise ValueError(f"n_steps*n_factors = {n_steps * N_FACTORS} exceeds the "
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


def _kernel() -> ctypes.CDLL:
    """The built library with its launch functions' C signatures declared."""
    lib = cuda_build.load("fused_mf")
    head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)]
    lib.orp_heston_euler_launch.argtypes = head + [ctypes.c_void_p]
    lib.orp_heston_qe_launch.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
    lib.orp_heston_euler_launch.restype = ctypes.c_int
    lib.orp_heston_qe_launch.restype = ctypes.c_int
    return lib


def _launch(name: str, consts: list[float], extra: tuple, n_paths, n_steps, s0, seed,
            store_every, dev) -> dict:
    n_knots = _check(n_paths, n_steps, store_every)
    lib = _kernel()
    c = (ctypes.c_float * len(consts))(*consts)  # host f64 -> f32, rounded once
    with torch.cuda.device(dev):
        dirs = direction_numbers(n_steps * N_FACTORS, device=dev, dtype=torch.int32)
        logs = torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
        v = torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
        rc = getattr(lib, name)(dirs.data_ptr(), logs.data_ptr(), v.data_ptr(), n_paths,
                                n_steps, store_every, int(seed) & 0xFFFFFFFF, c, *extra,
                                torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, name)
    return {"S": (s0 * torch.exp(logs)).t(), "v": v.t()}


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


heston_log_fused.launches = 0
heston_qe_fused.launches = 0
