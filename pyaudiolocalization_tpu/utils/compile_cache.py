"""Persistent XLA compilation cache location.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives in ``.jax_cache/`` at the root of the checkout (git-ignored).  The
path is fixed: it is part of the cache key, so a directory that moves
between runs never hits.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(subdir: Optional[str] = None,
                         min_compile_time_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at its directory and return
    it.  ``subdir`` names a sub-directory of the default ``.jax_cache/``
    (ignored when ``JAX_COMPILATION_CACHE_DIR`` is set, which then receives
    the cache alone)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT_ROOT, ".jax_cache", subdir or "")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
