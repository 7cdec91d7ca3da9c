"""Shared helpers: device resolution, the full-f32 guard, the BS and Heston oracles, the kernel build."""

from orp_tpu_torch.utils.black_scholes import bs_call
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.heston import heston_call, heston_put
from orp_tpu_torch.utils.precision import full_f32

__all__ = ["bs_call", "full_f32", "heston_call", "heston_put", "resolve_device"]
