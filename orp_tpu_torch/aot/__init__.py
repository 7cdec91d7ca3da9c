"""orp_tpu_torch.aot: builds and captures as explicit, cached, shippable artifacts (counterpart of ``orp_tpu/aot``).

The port's one-time costs are the ``nvcc`` builds of its ``sm_90a`` libraries
and the CUDA-graph captures of its hot programs. This package owns them:

- ``cache``       - the one persistent kernel-build-cache entry point
  (``enable_persistent_cache``; env ``ORP_TORCH_CACHE_DIR``), the directory
  ``utils/cuda_build`` builds into and loads from;
- ``compile``     - one CUDA graph of a program captured on static inputs,
  with its walls and analytic cost in obs (``aot_compile``), the
  ``CompileTimeMonitor`` build-and-capture wall splitter, and
  ``warm_fused_walk`` (the fused walk's library into the cache, its
  programs captured on empty tensors to time the captures);
- ``bundle_exec`` - per-bucket sets inside policy bundles (``export_aot``):
  the card's libraries under their source digest, and each bucket's graph,
  captured again by ``load_aot`` when a ``HedgeEngine`` is built from the
  bundle, so a cold process runs ``nvcc`` 0 times; a warn-once eager
  fallback on any mismatch.
"""

from orp_tpu_torch.aot.bundle_exec import AOT_FORMAT, AotExecutable, export_aot, load_aot
from orp_tpu_torch.aot.cache import (DEFAULT_CACHE_DIR, enable_from_env, enable_persistent_cache,
                                     resolve_cache_dir)
from orp_tpu_torch.aot.compile import (AotUnsupported, CompileTimeMonitor, aot_compile,
                                       cost_summary, device_fingerprint, warm_fused_walk)

__all__ = [
    "AOT_FORMAT",
    "AotExecutable",
    "AotUnsupported",
    "CompileTimeMonitor",
    "DEFAULT_CACHE_DIR",
    "aot_compile",
    "cost_summary",
    "device_fingerprint",
    "enable_from_env",
    "enable_persistent_cache",
    "export_aot",
    "load_aot",
    "resolve_cache_dir",
    "warm_fused_walk",
]
