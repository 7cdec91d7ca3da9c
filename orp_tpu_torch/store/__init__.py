"""The bundle plane's tiering (counterpart of ``orp_tpu/store``): ``tier.py``
gives ``ServeHost`` its hot/warm/cold activation ladder. The content-addressed
store and catalog (``cas.py``, ``catalog.py``) come with the network and fleet
plane."""

from orp_tpu_torch.store.tier import (COLD, DEFAULT_MAX_WARM, HOT, WARM, TierManager,
                                      prefetch_assigned)

__all__ = ["COLD", "DEFAULT_MAX_WARM", "HOT", "TierManager", "WARM", "prefetch_assigned"]
