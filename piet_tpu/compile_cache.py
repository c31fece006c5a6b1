"""JAX's persistent compilation cache, at one fixed place per checkout."""

from __future__ import annotations

import os

#: The default cache directory: ``.jax_cache`` at the repository root
#: (listed in .gitignore).  A fixed path, because the path is part of the
#: cache key: a directory that moves never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``DEFAULT_DIR``.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
