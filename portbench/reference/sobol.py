"""Owen-scrambled Sobol uniforms and the AS241 inverse normal, in plain PyTorch.

A frozen, independent statement of the path generator the program's kernels
implement: point ``i`` of dimension ``d`` is ``XOR_{k: bit k of i} V[d, k]``
over the Joe-Kuo direction numbers (``joe_kuo_4096x32.npy`` beside this
file: the first 4,096 dimensions of the published table, equal to the table
SciPy builds from its own initial numbers: ``test_portbench_sobol.py``), Owen-scrambled by
the Laine-Karras hash between two bit reversals keyed by ``hash(seed, d)``
(Burley 2020), mapped to the centre of one of 2^23 buckets of (0, 1) and
inverted by AS241 in f32. Every row carries its own seed, so the rows of
many jobs are generated in one pass.

The bit arithmetic runs in int64 holding 32-bit words, masked after every
``+``, ``*`` and ``<<``.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

MASK = 0xFFFFFFFF
BUCKET_BITS = 23  # f32: the largest bucket count whose top centre stays below 1.0
TABLE = pathlib.Path(__file__).with_name("joe_kuo_4096x32.npy")


@functools.cache
def _table_host() -> np.ndarray:
    return np.load(TABLE).astype(np.int64)


@functools.cache
def directions(device: str) -> torch.Tensor:
    """The direction words ``(4096, 32)`` as int64 on ``device``."""
    return torch.from_numpy(_table_host()).to(device)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = a ^ ((b + 0x9E3779B9 + ((a << 6) & MASK) + (a >> 2)) & MASK)
    x = (x * 0x85EBCA6B) & MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK) | (x >> 16)


def owen(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    x = reverse_bits(x)
    x = (x + key) & MASK
    x = x ^ ((x * 0x6C50B47C) & MASK)
    x = x ^ ((x * 0xB82F1E52) & MASK)
    x = x ^ ((x * 0xC7AFE638) & MASK)
    x = x ^ ((x * 0x8D22F6E6) & MASK)
    return reverse_bits(x)


class Points:
    """Uniforms of fixed rows ``idx (n,)`` with per-row seeds ``seeds (n,)``;
    the index bits are split once and reused for every dimension."""

    def __init__(self, idx: torch.Tensor, seeds: torch.Tensor):
        self.idx = idx.to(torch.int64)
        self.seeds = seeds.to(device=self.idx.device, dtype=torch.int64) & MASK
        top = int(self.idx.max()) if self.idx.numel() else 0
        self.bits = [((self.idx >> k) & 1).bool()[:, None] for k in range(top.bit_length())]
        self.dirs = directions(str(self.idx.device))

    def uniforms(self, dims) -> torch.Tensor:
        """``(n, len(dims))`` uniforms of (0, 1) in f32."""
        dims_t = torch.as_tensor(dims, dtype=torch.int64, device=self.idx.device)
        rows = self.dirs[dims_t]                                    # (d, 32)
        acc = torch.zeros((self.idx.shape[0], dims_t.shape[0]), dtype=torch.int64,
                          device=self.idx.device)
        for k, bit in enumerate(self.bits):
            acc ^= torch.where(bit, rows[:, k][None, :], 0)
        key = hash_combine(self.seeds[:, None], dims_t[None, :] & MASK)
        x = owen(acc, key)
        u = (x >> (32 - BUCKET_BITS)).to(torch.float32)
        return (u + 0.5) * (2.0 ** -BUCKET_BITS)


def ndtri_as241(u: torch.Tensor) -> torch.Tensor:
    """AS241 (Wichura 1988, PPND16 coefficients) inverse normal CDF in f32,
    both branches evaluated and selected."""
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
