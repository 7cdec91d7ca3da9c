"""The bundle plane (counterpart of ``orp_tpu/store``): ``cas.py`` holds every
bundle file exactly once (sha256-addressed, atomic, tamper-refusing, gc'd
against the catalog closure); ``catalog.py`` turns a bundle into a versioned
manifest of CAS pointers per tenant and speaks the ``store://<root>#<tenant>``
URIs ``load_bundle`` resolves; ``tier.py`` gives ``ServeHost`` its
hot/warm/cold activation ladder and the fleet its predictive warm-prefetch."""

from orp_tpu_torch.store.cas import CasIntegrityError, CasStore, blob_digest
from orp_tpu_torch.store.catalog import (STORE_URI_PREFIX, BundleStore, open_store,
                                         parse_store_uri)
from orp_tpu_torch.store.tier import (COLD, DEFAULT_MAX_WARM, HOT, WARM, TierManager,
                                      prefetch_assigned)

__all__ = ["BundleStore", "CasIntegrityError", "CasStore", "COLD", "DEFAULT_MAX_WARM", "HOT",
           "STORE_URI_PREFIX", "TierManager", "WARM", "blob_digest", "open_store",
           "parse_store_uri", "prefetch_assigned"]
