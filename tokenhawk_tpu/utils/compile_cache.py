"""Persistent XLA compile cache for the entry points.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here.  Otherwise, on an accelerator, the cache lives in one fixed,
git-ignored directory inside the checkout (`.jax_cache/`): the cache key
includes the path, so a directory that moves never hits.  CPU runs
(tests) compile quickly and keep no cache.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at its directory; returns it
    (None on the CPU)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if jax.default_backend() == "cpu":
        return None
    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
