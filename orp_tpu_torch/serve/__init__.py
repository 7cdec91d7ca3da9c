"""Serving: framework-neutral policy bundles, the bucketed evaluation engine and
its precision tiers, and the single-host serve path on top of them:

- ``bundle``  - ``save_bundle`` / ``export_bundle`` / ``load_bundle``
  (numpy params + JSON metadata + the run-fingerprint guard + the
  model-health baseline);
- ``engine``  - ``HedgeEngine``: ``evaluate`` / ``evaluate_async`` per date in
  power-of-two buckets, ``evaluate_mixed_async`` one date per row through the
  mixed-date kernel, the guard's fault sites and the watchdog's breaker;
- ``batcher`` - ``MicroBatcher``: continuous double-buffered batching under an
  optional ``GuardPolicy`` (deadlines, watermark, retries, the watchdog),
  block coalescing, ragged planning and the mixed-date lane;
- ``ingest``  - the columnar block lane (``submit_block`` -> ``BlockResult``
  with a per-row status column);
- ``wire``    - the ``orp-ingest-v2`` frame codec, byte-identical to the JAX
  package's;
- ``ragged``  - ``BucketPlanner``, the pad-waste cost model;
- ``health``  - ``DispatchWatchdog``;
- ``metrics`` - ``ServingMetrics``;
- ``host``    - ``ServeHost``: many tenants under an LRU engine cap with a
  warm tier, quotas, SLO burn rates, canary-gated hot reload and tier
  promotion through the quality band;
- ``gateway`` - ``ServeGateway``: the ``orp-ingest`` TCP front over a host
  (sessions, the dedup window and reply cache, the frame deadline, BUSY,
  drain-and-redirect, METRICS / HEALTH), and ``GatewayClient`` (v1);
- ``client``  - ``ResilientGatewayClient``: the v2 producer (send window,
  reconnect with backoff, RESUME and replay, REDIRECT);
- ``shm``     - ``RingPair`` / ``RingServer`` / ``RingClient``: the same frames
  through a shared-memory ring (imported from its module);
- ``scrape``  - ``MetricsServer`` (the HTTP scrape) and the exposition's read
  side (``parse_prometheus``, ``top_snapshot``, ``render_top``);
- ``fleet``   - ``FleetHost`` and its rendezvous ``RoutingTable`` (imported
  from its module, which loads standalone with the stdlib alone);
- ``bench``   - the precision-tier sweep with its promotion drill, the
  mixed-date A/B, and the network plane's phases (the ingest lanes, the
  gateway-kill drill, the fleet).
"""

from orp_tpu_torch.serve.batcher import MicroBatcher, SlimFuture
from orp_tpu_torch.serve.bundle import (PolicyBundle, export_bundle, load_bundle,
                                        policy_from_numpy, save_bundle)
from orp_tpu_torch.serve.client import ResilientGatewayClient
from orp_tpu_torch.serve.engine import HedgeEngine, PendingEval, ResidentParams, next_bucket
from orp_tpu_torch.serve.gateway import FrameStall, GatewayClient, GatewayError, ServeGateway
from orp_tpu_torch.serve.health import DispatchWatchdog
from orp_tpu_torch.serve.host import CanaryRejected, ServeHost, SloPolicy, burn_rate
from orp_tpu_torch.serve.ingest import (SERVED, SHED_DEADLINE, SHED_QUOTA, SHED_WATERMARK,
                                        STATUS_NAMES, BlockResult, concat_results)
from orp_tpu_torch.serve.megakernel import (loop_of_buckets, mixed_head_forward,
                                            mixed_head_plain)
from orp_tpu_torch.serve.metrics import ServingMetrics
from orp_tpu_torch.serve.precision import TIERS, PrecisionPolicy, normalize_precision
from orp_tpu_torch.serve.ragged import BucketPlanner
from orp_tpu_torch.serve.scrape import MetricsServer, parse_prometheus, render_top, top_snapshot

__all__ = ["BlockResult", "BucketPlanner", "CanaryRejected", "DispatchWatchdog", "FrameStall",
           "GatewayClient", "GatewayError", "HedgeEngine", "MetricsServer", "MicroBatcher",
           "PendingEval", "PolicyBundle", "PrecisionPolicy", "ResidentParams",
           "ResilientGatewayClient", "SERVED", "SHED_DEADLINE", "SHED_QUOTA", "SHED_WATERMARK",
           "STATUS_NAMES", "ServeGateway", "ServeHost", "ServingMetrics", "SloPolicy",
           "SlimFuture", "TIERS", "burn_rate", "concat_results", "export_bundle",
           "load_bundle", "loop_of_buckets", "mixed_head_forward", "mixed_head_plain",
           "next_bucket", "normalize_precision", "parse_prometheus", "policy_from_numpy",
           "render_top", "save_bundle", "top_snapshot"]
