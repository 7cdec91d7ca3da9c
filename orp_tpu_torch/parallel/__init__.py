"""The paths mesh over ``torch.distributed`` and reductions over the path axis."""

from orp_tpu_torch.parallel.mesh import (MeshSpec, as_mesh, join_submesh, largest_submesh,
                                         make_mesh, pad_to_mesh, path_indices, path_sharding,
                                         replicated_sharding, shard_paths, spec_of,
                                         topology_fingerprint)
from orp_tpu_torch.parallel.multihost import initialize_multihost
from orp_tpu_torch.parallel.quantiles import histogram_quantile, quantile, sort_quantile

__all__ = ["MeshSpec", "as_mesh", "histogram_quantile", "initialize_multihost",
           "join_submesh", "largest_submesh", "make_mesh", "pad_to_mesh", "path_indices",
           "path_sharding", "quantile", "replicated_sharding", "shard_paths", "sort_quantile",
           "spec_of", "topology_fingerprint"]
