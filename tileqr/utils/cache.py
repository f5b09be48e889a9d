"""Where compiled programs are cached between processes."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def configure_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set in code. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (gitignored): the path is part of the cache's
    key, so a directory that moves would never hit. Programs that compiled
    faster than ``min_compile_secs`` are not written."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    path = os.environ.get(ENV)
    if path:
        return path
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
