"""Persistent XLA compilation cache setup.

The reference caches FFTW plans in a wisdom file (lib/FDR_impl.cc:142-150);
the equivalent here is JAX's persistent compilation cache. The directory is
$JAX_COMPILATION_CACHE_DIR when set, else the fixed ``<repo>/.jax_cache``
(a fixed path, because the path is part of the cache key). Call before the
first jit execution.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2]
                        / ".jax_cache")


def enable_compile_cache(directory: str | None = None) -> str:
    """Point JAX's persistent compilation cache at ``directory``.

    Default: ``<repo>/.jax_cache`` (or $JAX_COMPILATION_CACHE_DIR if set).
    Safe to call multiple times; returns the directory used.
    """
    import jax

    directory = (directory
                 or os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or DEFAULT_CACHE_DIR)
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return directory


__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]
