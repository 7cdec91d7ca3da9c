"""Serving: framework-neutral policy bundles and the bucketed evaluation engine."""

from orp_tpu_torch.serve.bundle import (PolicyBundle, load_bundle, policy_from_numpy,
                                        save_bundle)
from orp_tpu_torch.serve.engine import HedgeEngine, PendingEval, next_bucket
from orp_tpu_torch.serve.megakernel import (loop_of_buckets, mixed_head_forward,
                                            mixed_head_plain)

__all__ = ["HedgeEngine", "PendingEval", "PolicyBundle", "load_bundle", "loop_of_buckets",
           "mixed_head_forward", "mixed_head_plain", "next_bucket", "policy_from_numpy",
           "save_bundle"]
