"""JAX's persistent compilation cache, set up the same way by every entry
point (the CLI, ``bench.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """The fixed cache path inside the checkout (listed in .gitignore)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to
    ``default_cache_dir()``.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    path = default_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
