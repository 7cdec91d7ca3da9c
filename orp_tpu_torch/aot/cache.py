"""The one persistent kernel-build-cache entry point (counterpart of ``orp_tpu/aot/cache.py``).

What the JAX package points at XLA's persistent compilation cache, the port
points at the directory ``utils/cuda_build`` builds its ``sm_90a`` libraries
into and loads them from (``lib<name>-<digest>.so``). The directory is
resolved at every build and load (``cuda_build.build_dir``), so a redirect
mid-process takes effect for every later build: the counterpart of the
reference's ``reset_cache`` concern.

Resolution order for the directory:

1. the explicit ``directory`` argument;
2. env ``ORP_TORCH_CACHE_DIR`` (the counterpart of ``ORP_JAX_CACHE_DIR``);
3. ``build/orp_tpu_torch/`` at the root of the checkout (``.gitignore``
   lists it), :data:`DEFAULT_CACHE_DIR`.

``ORP_TESTS_NO_COMPILE_CACHE=1`` turns every call into a no-op, as in the
JAX package: the builds then keep whatever directory was in effect.
``min_compile_secs`` is accepted for the reference's signature and ignored:
every build is cached (a library is never cheap to rebuild).
"""

from __future__ import annotations

import os
import pathlib

from orp_tpu_torch.utils import cuda_build

ENV_CACHE_DIR = cuda_build.ENV_CACHE_DIR
ENV_DISABLE = "ORP_TESTS_NO_COMPILE_CACHE"

DEFAULT_CACHE_DIR = cuda_build.BUILD_DIR


def resolve_cache_dir(directory: str | pathlib.Path | None = None) -> pathlib.Path | None:
    """The directory :func:`enable_persistent_cache` would use, or None when
    the ``ORP_TESTS_NO_COMPILE_CACHE`` kill-switch is set."""
    if os.environ.get(ENV_DISABLE):
        return None
    if directory is not None:
        return pathlib.Path(directory)
    env = os.environ.get(ENV_CACHE_DIR)
    return pathlib.Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache(directory: str | pathlib.Path | None = None, *,
                            min_compile_secs: float | None = None) -> pathlib.Path | None:
    """Point the kernel-build cache at ``directory`` (resolution in the module
    docstring) for the rest of the process; returns the directory in effect,
    or None when the kill-switch disabled the call."""
    d = resolve_cache_dir(directory)
    if d is None:
        return None
    cuda_build.set_build_dir(d)
    return d


def enable_from_env() -> pathlib.Path | None:
    """Enable the cache only when ``ORP_TORCH_CACHE_DIR`` asks for it."""
    if not os.environ.get(ENV_CACHE_DIR):
        return None
    return enable_persistent_cache()
