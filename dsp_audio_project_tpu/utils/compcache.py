"""Persistent XLA compilation cache.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set
(JAX reads that variable itself, and nothing here overrides it); otherwise
at the fixed path ``<repo>/.jax_cache``.  The path is part of the cache
key, so it never depends on a temporary name, a pid or the time.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on for every compile; return its path."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    configured = jax.config.jax_compilation_cache_dir
    if configured != path:
        raise RuntimeError(
            f"compile cache configured at {configured!r}, expected {path!r}"
        )
    return path
