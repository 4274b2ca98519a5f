"""Where the persistent XLA compilation cache lives.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache is
the fixed directory `.jax_cache/` at the root of the checkout (listed in
.gitignore).  A fixed path matters: the directory is part of the
cache's key, so a cache that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; returns
    the directory.  Graphs that compile in under a second stay out."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
