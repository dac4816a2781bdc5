"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins and JAX reads it itself.
Otherwise the cache sits at a fixed `.jax_cache/` in the checkout root:
the directory is part of the cache key, so a path that moved from run to
run (a temp dir, a pid) would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir().

    Called once at start-up by every tool, the bench and the chip smoke
    run; returns the directory."""
    import jax

    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
