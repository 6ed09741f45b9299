"""Persistent XLA compile cache location (one helper for every entry point).

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins: the
cache lives there and nothing else is configured.  Otherwise the cache goes
to the fixed ``<repo>/.jax_cache`` (git-ignored).  An entry is keyed by the
computation, the compile options, the backend and the JAX version, not by
where it lives; a fixed directory is what lets a later process look where an
earlier one wrote.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or REPO_CACHE


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
