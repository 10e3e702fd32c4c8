"""Where JAX keeps its persistent compilation cache.

One fixed directory per checkout, so a later process (a test worker, the
next benchmark mode, a rerun) finds what an earlier one compiled. The
directory is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it: that
    directory is used and nothing is set. Otherwise the cache goes to the
    checkout's `.jax_cache/` (listed in `.gitignore`)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
