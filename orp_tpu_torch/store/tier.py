"""Hot/warm/cold tenant tiering for the serve plane (counterpart of
``orp_tpu/store/tier.py``).

Three tiers, three activation costs:

- **hot** - live engine + batcher in ``ServeHost``; a submit routes
  straight to the card.
- **warm** - no engine, but the deserialized policy is retained with its
  params ON THE CARD (the engine's ``ResidentParams``, the mixed-date
  kernel's packed params included): re-activation builds the engine only,
  with no kernel build and no host-to-device copy of params.
- **cold** - nothing retained; activation pays a full ``load_bundle`` and
  the params' copy to the card.

``TierManager`` owns the bookkeeping: which registered tenant sits where,
an LRU bound on the warm set (``max_warm`` bounds the device memory warm
tenants hold), and the ``store/tier{level}`` gauges. ``ServeHost`` drives
it: eviction demotes hot to warm, and past ``max_warm`` the coldest warm
tenant loses its retained policy and device params.

``prefetch_assigned`` is the predictive half: given a routing table that
names which replica owns which tenant, the mapped replica can warm its
working set before the first request arrives. (The fleet's routing table
comes with the network and fleet plane.)
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from orp_tpu_torch.obs.spans import count as obs_count
from orp_tpu_torch.obs.spans import set_gauge as obs_set_gauge

HOT = "hot"
WARM = "warm"
COLD = "cold"

#: default warm-retention bound: generous for a density bench, small
#: against a million-tenant catalog (the point of having a cold tier)
DEFAULT_MAX_WARM = 256


class TierManager:
    """Per-tenant tier bookkeeping with a bounded, LRU-ordered warm set.

    Thread-safe under its own lock (ServeHost calls in under the host
    lock, prefetch calls in from arbitrary threads). The manager tracks
    NAMES only — the retained policy objects live on the host's tenants;
    ``note_warm``'s return value tells the host whose retained policy to
    drop when the warm set overflows."""

    def __init__(self, *, max_warm: int = DEFAULT_MAX_WARM):
        if max_warm < 0:
            raise ValueError(f"max_warm={max_warm} must be >= 0")
        self.max_warm = int(max_warm)
        self._lock = threading.Lock()
        self._tier: dict[str, str] = {}
        self._warm: OrderedDict[str, None] = OrderedDict()

    # -- transitions ---------------------------------------------------------

    def note_hot(self, name: str) -> None:
        """An engine went live for ``name`` (activation)."""
        with self._lock:
            self._warm.pop(name, None)
            self._tier[name] = HOT
            self._publish_locked()

    def note_warm(self, name: str) -> list[str]:
        """``name`` holds a retained policy but no engine — eviction's
        hot→warm demotion, or a prefetch's cold→warm promotion. Returns
        the names LRU-dropped past ``max_warm``; the caller must release
        their retained policies (they are cold now)."""
        with self._lock:
            self._warm.pop(name, None)
            self._warm[name] = None
            self._tier[name] = WARM
            dropped = []
            while len(self._warm) > self.max_warm:
                victim, _ = self._warm.popitem(last=False)
                self._tier[victim] = COLD
                dropped.append(victim)
            if dropped:
                obs_count("store/tier_demote", n=len(dropped), to=COLD)
            self._publish_locked()
            return dropped

    def note_cold(self, name: str) -> None:
        """``name`` lost its retained policy (explicit drop)."""
        with self._lock:
            self._warm.pop(name, None)
            self._tier[name] = COLD
            self._publish_locked()

    def forget(self, name: str) -> None:
        """``name`` left the host entirely (unregister)."""
        with self._lock:
            self._warm.pop(name, None)
            self._tier.pop(name, None)
            self._publish_locked()

    # -- queries -------------------------------------------------------------

    def tier_of(self, name: str) -> str:
        with self._lock:
            return self._tier.get(name, COLD)

    def counts(self) -> dict:
        with self._lock:
            out = {HOT: 0, WARM: 0, COLD: 0}
            for tier in self._tier.values():
                out[tier] += 1
            return out

    def _publish_locked(self) -> None:
        counts = {HOT: 0, WARM: 0, COLD: 0}
        for tier in self._tier.values():
            counts[tier] += 1
        for level, n in counts.items():
            obs_set_gauge("store/tier", n, level=level)


def prefetch_assigned(host, table, tenants, replica: str) -> list:
    """Predictively warm ``host`` (the in-process ServeHost of ``replica``)
    with every tenant the routing ``table`` maps to it.

    Call on fleet bring-up and from ``ReplicaHealth.on_change`` — a
    replica-set change remaps the rendezvous assignment, and the tenants
    that just landed on this replica should be warm before their rerouted
    first request arrives. Returns the newly-warmed tenant names."""
    mine = table.assigned(tenants, replica)
    return host.prefetch(mine)
