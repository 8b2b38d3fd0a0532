"""Persistent compilation cache location for scripts and tools.

``enable()`` leaves JAX's own setting alone when
``JAX_COMPILATION_CACHE_DIR`` is set, and otherwise points the cache at
``<repo root>/.jax_cache`` — a fixed path, since the path is part of the
cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os

__all__ = ["enable", "cache_dir"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return cache_dir()
