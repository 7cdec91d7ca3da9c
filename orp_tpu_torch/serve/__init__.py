"""Serving: framework-neutral policy bundles, the bucketed evaluation engine and
its precision tiers."""

from orp_tpu_torch.serve.bundle import (PolicyBundle, load_bundle, policy_from_numpy,
                                        save_bundle)
from orp_tpu_torch.serve.engine import HedgeEngine, PendingEval, next_bucket
from orp_tpu_torch.serve.megakernel import (loop_of_buckets, mixed_head_forward,
                                            mixed_head_plain)
from orp_tpu_torch.serve.precision import TIERS, PrecisionPolicy, normalize_precision

__all__ = ["TIERS", "HedgeEngine", "PendingEval", "PolicyBundle", "PrecisionPolicy",
           "load_bundle", "loop_of_buckets", "mixed_head_forward", "mixed_head_plain",
           "next_bucket", "normalize_precision", "policy_from_numpy", "save_bundle"]
