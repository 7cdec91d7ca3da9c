"""Shared helpers: device resolution, the full-f32 guard, the BS oracle, the kernel build."""

from orp_tpu_torch.utils.black_scholes import bs_call
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.precision import full_f32

__all__ = ["bs_call", "full_f32", "resolve_device"]
