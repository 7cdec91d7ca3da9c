"""Shared helpers: device resolution, the full-f32 guard, the BS, basket, Heston and CRR oracles, the kernel build, checkpoints, run fingerprints, tracing and timing, NaN sanitizers and FLOP accounting."""

from orp_tpu_torch.utils.basket import basket_call_mm
from orp_tpu_torch.utils.black_scholes import bs_call, bs_greeks, bs_put
from orp_tpu_torch.utils.checkpoint import (latest_complete_step, latest_step, load_checkpoint,
                                            load_checkpoints, save_checkpoint, state_digest)
from orp_tpu_torch.utils.crr import crr_price
from orp_tpu_torch.utils.device import resolve_device
from orp_tpu_torch.utils.fingerprint import (check_fingerprint, policy_fingerprint,
                                             read_fingerprint, verify_fingerprint,
                                             verify_policy_compat, write_fingerprint)
from orp_tpu_torch.utils.heston import heston_call, heston_put
from orp_tpu_torch.utils.precision import full_f32
from orp_tpu_torch.utils.profiling import timed, trace

__all__ = ["basket_call_mm", "bs_call", "bs_greeks", "bs_put", "check_fingerprint", "crr_price",
           "full_f32", "heston_call", "heston_put", "latest_complete_step", "latest_step",
           "load_checkpoint", "load_checkpoints", "policy_fingerprint", "read_fingerprint", "resolve_device",
           "save_checkpoint", "state_digest", "timed", "trace", "verify_fingerprint",
           "verify_policy_compat", "write_fingerprint"]
