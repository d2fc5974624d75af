"""Persistent XLA compilation cache, set up in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and JAX
reads it itself; nothing here overrides it. Otherwise the cache lives at a
fixed directory inside the checkout (``.jax_cache``, git-ignored): the
path is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Cache every compiled program (no size or compile-time floor) in
    ``cache_dir()``; returns that directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
