"""JAX's persistent compilation cache, pointed at one place.

Every entry point that compiles device code (the corpus CLI, bench.py,
chip_smoke.py, the test suite) calls ``enable_compile_cache`` before its
first compile. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this sets no directory; otherwise the cache goes to
``.jax_cache/`` at the root of the checkout (listed in .gitignore). The
directory is part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
