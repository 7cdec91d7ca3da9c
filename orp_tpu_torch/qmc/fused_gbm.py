"""Fused scrambled-Sobol -> AS241 inverse normal -> log-GBM path generator.

Counterpart of ``orp_tpu/qmc/pallas_sobol.py::gbm_log_pallas``. Per path and
step it forms the Sobol word (32-term XOR of direction row ``t-1``), Owen
scrambles it (Laine-Karras keyed by ``hash(seed, t-1)`` between bit
reversals), maps it to the centre of one of 2^23 buckets in (0, 1), inverts
the normal CDF with AS241 in f32 and advances ``logs += c0 + vol_sdt * z``.
Only the rebalance knots are stored, as ``s0 * exp(logs)``.

- :func:`gbm_log_fused` is the wrapper: the CUDA kernel (``csrc/fused_mf.cu``,
  the multi-factor kernel ``mf_kernel`` with its one-factor ``GbmLog`` step)
  for a CUDA device, :func:`gbm_log_plain` for the CPU. On the card it
  launches the kernel or raises; it never falls back.
- :func:`gbm_log_plain` is the same arithmetic in plain PyTorch: the scan
  path (``sde.kernels.scan_sde`` over ``qmc.sobol.sobol_uniform``) with AS241
  as its inverse normal. It is the CPU tests' subject and the card's
  yardstick of correctness.

The knots are stored knot-major, ``(n_knots, n_paths)``, so each knot is one
contiguous row; the wrapper returns the ``(n_paths, n_knots)`` transposed
view, the JAX function's shape.
"""

from __future__ import annotations

import ctypes

import torch

from orp_tpu_torch.qmc.sobol import N_DIMS, direction_numbers
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.device import resolve_device


def ndtri_as241(u: torch.Tensor) -> torch.Tensor:
    """AS241 (PPND7-grade) inverse normal CDF in f32, both branches evaluated
    and selected, exactly as ``pallas_sobol._ndtri_f32`` writes it."""
    q = u - 0.5
    r_c = 0.180625 - q * q
    num_c = (((2.5090809287301226727e3 * r_c + 3.3430575583588128105e4) * r_c
              + 6.7265770927008700853e4) * r_c + 4.5921953931549871457e4)
    num_c = ((num_c * r_c + 1.3731693765509461125e4) * r_c + 1.9715909503065514427e3)
    num_c = (num_c * r_c + 1.3314166789178437745e2) * r_c + 3.3871328727963666080e0
    den_c = (((5.2264952788528545610e3 * r_c + 2.8729085735721942674e4) * r_c
              + 3.9307895800092710610e4) * r_c + 2.1213794301586595867e4)
    den_c = ((den_c * r_c + 5.3941960214247511077e3) * r_c + 6.8718700749205790830e2)
    den_c = (den_c * r_c + 4.2313330701600911252e1) * r_c + 1.0
    central = q * num_c / den_c

    p_tail = torch.minimum(u, 1.0 - u)
    rt = torch.sqrt(-torch.log(torch.clamp(p_tail, min=1e-38)))
    r1 = rt - 1.6
    num_m = (((7.74545014278341407640e-4 * r1 + 2.27238449892691845833e-2) * r1
              + 2.41780725177450611770e-1) * r1 + 1.27045825245236838258e0)
    num_m = ((num_m * r1 + 3.64784832476320460504e0) * r1 + 5.76949722146069140550e0)
    num_m = (num_m * r1 + 4.63033784615654529590e0) * r1 + 1.42343711074968357734e0
    den_m = (((1.05075007164441684324e-9 * r1 + 5.47593808499534494600e-4) * r1
              + 1.51986665636164571966e-2) * r1 + 1.48103976427480074590e-1)
    den_m = ((den_m * r1 + 6.89767334985100004550e-1) * r1 + 1.67638483018380384940e0)
    den_m = (den_m * r1 + 2.05319162663775882187e0) * r1 + 1.0
    r2 = rt - 5.0
    num_f = (((2.01033439929228813265e-7 * r2 + 2.71155556874348757815e-5) * r2
              + 1.24266094738807843860e-3) * r2 + 2.65321895265761230930e-2)
    num_f = ((num_f * r2 + 2.96560571828504891230e-1) * r2 + 1.78482653991729133580e0)
    num_f = (num_f * r2 + 5.46378491116411436990e0) * r2 + 6.65790464350110377720e0
    den_f = (((2.04426310338993978564e-15 * r2 + 1.42151175831644588870e-7) * r2
              + 1.84631831751005468180e-5) * r2 + 7.86869131145613259100e-4)
    den_f = ((den_f * r2 + 1.48753612908506148525e-2) * r2 + 1.36929880922735805310e-1)
    den_f = (den_f * r2 + 5.99832206555887937690e-1) * r2 + 1.0
    tail = torch.where(rt <= 5.0, num_m / den_m, num_f / den_f)
    tail = torch.where(q < 0.0, -tail, tail)
    return torch.where(torch.abs(q) <= 0.425, central, tail)


def _check(n_paths: int, n_steps: int, store_every: int) -> int:
    if not 1 <= n_paths <= 1 << 32:
        raise ValueError(f"n_paths {n_paths} must be in [1, 2^32] (uint32 path index)")
    if n_steps < 1 or n_steps % store_every:
        raise ValueError(f"store_every={store_every} must divide n_steps={n_steps}")
    if n_steps > N_DIMS:
        raise ValueError(
            f"n_steps={n_steps} exceeds the {N_DIMS}-dimension Sobol direction table")
    return n_steps // store_every + 1


def _constants(drift: float, sigma: float, dt: float) -> tuple[float, float]:
    # host f64, rounded once to f32 at use: the Pallas kernel's c0 / vol_sdt
    return float((drift - 0.5 * sigma * sigma) * dt), float(sigma * dt ** 0.5)


def gbm_log_plain(n_paths: int, n_steps: int, *, s0: float, drift: float, sigma: float,
                  dt: float, seed: int = 1234, store_every: int = 1,
                  device="cpu") -> torch.Tensor:
    """Plain version of the fused kernel, ``(n_paths, n_knots)`` f32: the scan
    path (``sde.kernels.scan_sde``) with AS241 as its inverse normal and the
    kernel's step constants."""
    from orp_tpu_torch.sde import TimeGrid, scan_sde  # sde imports qmc when it loads

    _check(n_paths, n_steps, store_every)
    dev = torch.device(device)
    c0, vol_sdt = _constants(drift, sigma, dt)

    def step(logs, z, t, _dt):
        return logs + c0 + vol_sdt * z[:, 0]

    _, logs = scan_sde(step, torch.zeros(n_paths, dtype=torch.float32, device=dev),
                       lambda x: x, torch.arange(n_paths, dtype=torch.int64, device=dev),
                       TimeGrid(n_steps * dt, n_steps), 1, seed, store_every=store_every,
                       inverse_normal=ndtri_as241)
    return torch.tensor(s0, dtype=torch.float32) * torch.exp(logs)


def _kernel() -> ctypes.CDLL:
    """The built library with its launch function's C signature declared."""
    lib = cuda_build.load("fused_mf")
    fn = lib.orp_fused_gbm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gbm_log_fused(n_paths: int, n_steps: int, *, s0: float, drift: float, sigma: float,
                  dt: float, seed: int = 1234, store_every: int = 1,
                  device=None) -> torch.Tensor:
    """Fused log-GBM knots ``(n_paths, n_steps // store_every + 1)`` f32.

    Same semantics as ``gbm_log_pallas`` (and ``simulate_gbm_log`` with Owen
    scrambling): Sobol point ``i`` is path ``i``, dimension ``t-1`` is step
    ``t``. ``device=None`` is the card; a CPU device runs :func:`gbm_log_plain`.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return gbm_log_plain(n_paths, n_steps, s0=s0, drift=drift, sigma=sigma, dt=dt,
                             seed=seed, store_every=store_every, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"gbm_log_fused runs on cuda or cpu, not {dev}")
    n_knots = _check(n_paths, n_steps, store_every)
    c0, vol_sdt = _constants(drift, sigma, dt)
    lib = _kernel()
    with torch.cuda.device(dev):
        dirs = direction_numbers(n_steps, device=dev, dtype=torch.int32)
        out = torch.empty((n_knots, n_paths), dtype=torch.float32, device=dev)
        rc = lib.orp_fused_gbm_launch(
            dirs.data_ptr(), out.data_ptr(), n_paths, n_steps, store_every,
            int(seed) & 0xFFFFFFFF, c0, vol_sdt, float(s0),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "orp_fused_gbm_launch")
    gbm_log_fused.launches += 1
    return out.t()


gbm_log_fused.launches = 0
