"""JAX persistent compilation cache location.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set;
otherwise in the checkout's `.jax_cache/` (gitignored).  The path is
part of the cache's key, so it is fixed rather than per-run.  Setting
the environment variable after `import jax` has no effect, so the
location is applied through jax.config.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
