"""Owen-scrambled Sobol quasi-Monte-Carlo in plain PyTorch.

Counterpart of ``orp_tpu/qmc/sobol.py`` with the same integers, bit for bit:

- direction numbers: the packed Joe-Kuo ``V[16384, 32]`` table (this package's
  own copy under ``_data/``);
- point evaluation: ``x_i = XOR_{k : bit k of i} V[dim, k]``, index-addressed,
  so any index range is generated without the points before it;
- scrambling: hash-based Owen scrambling (Laine-Karras permutation between bit
  reversals, Burley 2020) keyed per dimension by ``hash(seed, dim)``, or a
  plain digital shift;
- normal transform: ``torch.special.ndtri`` (the JAX scan path's
  ``jax.scipy.special.ndtri``). The fused kernel uses AS241 instead
  (``qmc/fused_gbm.ndtri_as241``).

Integer width: PyTorch's ``uint32`` supports few operations, so the bit
arithmetic runs in int64 holding 32-bit words, masked with ``& 0xFFFFFFFF``
after every ``+``, ``*`` and ``<<``. Right shifts of masked, non-negative
values are then logical, and an int64 product of two 32-bit words keeps its
low 32 bits right even where the 64-bit product wraps.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from orp_tpu_torch.utils.device import resolve_device

N_DIMS = 16384
N_BITS = 32
MASK = 0xFFFFFFFF
# min(31, mantissa bits): the largest bucket count whose top centre stays
# below 1.0 after rounding in that dtype
_BUCKET_BITS = {torch.float32: 23, torch.float64: 31, torch.bfloat16: 7}  # orp: noqa[ORP001] -- the bucket table must name every dtype a caller may ask for


@functools.cache
def _directions_host() -> np.ndarray:
    path = pathlib.Path(__file__).parent / "_data" / f"joe_kuo_{N_DIMS}x{N_BITS}.npy"
    return np.load(path)


@functools.cache
def _directions_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    host = _directions_host()
    if dtype == torch.int32:
        return torch.from_numpy(np.ascontiguousarray(host).view(np.int32)).to(device)
    return torch.from_numpy(host.astype(np.int64)).to(device)


def direction_numbers(max_dim: int | None = None, *, device="cpu",
                      dtype=torch.int64) -> torch.Tensor:
    """Packed Joe-Kuo direction numbers ``(max_dim, 32)`` as 32-bit words,
    uploaded once per device.

    ``dtype=torch.int64`` (the plain versions' word type) or ``torch.int32``
    (the same bits reinterpreted, for the CUDA kernel's ``uint32`` input)."""
    if dtype not in (torch.int64, torch.int32):
        raise ValueError(f"direction words are int64 or int32, not {dtype}")
    table = _directions_on(torch.device(device), dtype)
    return table if max_dim is None else table[:max_dim]


# ---------------------------------------------------------------------------
# Hashing / scrambling primitives (32-bit words held in int64)
# ---------------------------------------------------------------------------


def _hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One round of a Wang/PCG-style integer mix of two 32-bit words."""
    x = a ^ ((b + 0x9E3779B9 + ((a << 6) & MASK) + (a >> 2)) & MASK)
    x = (x * 0x85EBCA6B) & MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK) | (x >> 16)


def _laine_karras_permutation(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen-scramble the bit tree of the bit-reversed word (Burley 2020)."""
    x = (x + seed) & MASK
    x = x ^ ((x * 0x6C50B47C) & MASK)
    x = x ^ ((x * 0xB82F1E52) & MASK)
    x = x ^ ((x * 0xC7AFE638) & MASK)
    return x ^ ((x * 0x8D22F6E6) & MASK)


def owen_scramble(x: torch.Tensor, dim_seed: torch.Tensor) -> torch.Tensor:
    """Hash-based Owen scramble of Sobol words (per-dimension seed)."""
    return _reverse_bits32(_laine_karras_permutation(_reverse_bits32(x), dim_seed))


def digital_shift(x: torch.Tensor, dim_seed: torch.Tensor) -> torch.Tensor:
    """Plain random digital shift (XOR with a per-dimension word)."""
    return x ^ dim_seed


SCRAMBLES = {"owen": owen_scramble, "shift": digital_shift, "none": None}


# ---------------------------------------------------------------------------
# Core point evaluation
# ---------------------------------------------------------------------------


def _sobol_uint32(indices: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Unscrambled Sobol words for ``indices (n,)``: ``dirs (32,)`` gives
    ``(n,)``, ``dirs (d, 32)`` gives ``(n, d)``. XOR over the 32 bit positions."""
    single = dirs.ndim == 1
    dmat = dirs[None, :] if single else dirs
    acc = torch.zeros((indices.shape[0], dmat.shape[0]), dtype=torch.int64,
                      device=indices.device)
    for k in range(N_BITS):
        bit = ((indices >> k) & 1).bool()
        acc ^= torch.where(bit[:, None], dmat[:, k][None, :], 0)
    return acc[:, 0] if single else acc


def _to_unit_interval(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """32-bit word -> (0, 1), centred in each of 2^b buckets so 0 and 1 are
    unattainable after rounding: b = 23 for f32, 31 for f64."""
    bits = _BUCKET_BITS[dtype]
    u = (x >> (32 - bits)).to(dtype)
    return (u + 0.5) * (2.0 ** -bits)


def _dim_seeds(seed: int, dims: torch.Tensor) -> torch.Tensor:
    s = torch.full(dims.shape, int(seed) & MASK, dtype=torch.int64, device=dims.device)
    return _hash_combine(s, dims.to(torch.int64) & MASK)


def _as_words(t, device=None) -> torch.Tensor:
    t = torch.as_tensor(t, device=device)
    return t.to(torch.int64) & MASK


def sobol_uniform(indices, dims, seed: int = 0, *, scramble: str = "owen",
                  dtype=torch.float32) -> torch.Tensor:
    """Scrambled Sobol points in (0, 1): ``(n, d)`` for ``indices (n,)``, ``dims (d,)``.

    ``indices`` are global point indices and ``dims`` global dimension indices
    (time-step indices in the SDE layer)."""
    indices = _as_words(indices)
    dims = torch.atleast_1d(_as_words(dims, indices.device))
    dirs = direction_numbers(device=indices.device)[dims]
    x = _sobol_uint32(indices, dirs)
    fn = SCRAMBLES[scramble]
    if fn is not None:
        x = fn(x, _dim_seeds(seed, dims)[None, :])
    return _to_unit_interval(x, dtype)


def sobol_normal(indices, dims, seed: int = 0, *, scramble: str = "owen",
                 dtype=torch.float32) -> torch.Tensor:
    """Sobol-QMC N(0, 1) draws through ``ndtri`` (the scan path's inverse normal)."""
    return torch.special.ndtri(sobol_uniform(indices, dims, seed, scramble=scramble,
                                             dtype=dtype))


def sobol_normal_matrix(m: int, d: int, seed: int = 1234, *, scramble: str = "owen",
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """The reference's ``sobol_norm(m, d, seed)`` in shape: ``(2^m, d)`` standard
    normals, points ``0 .. 2^m - 1`` in dimensions ``0 .. d - 1``, on ``device``
    (``None`` is the card)."""
    dev = resolve_device(device)
    idx = torch.arange(2 ** m, dtype=torch.int64, device=dev)
    return sobol_normal(idx, torch.arange(d, device=dev), seed, scramble=scramble,
                        dtype=dtype)
