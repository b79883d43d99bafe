"""One fixed home for JAX's persistent compilation cache.

The cache key includes the directory, so a path that moves between
runs (a temporary or per-process directory) never hits.  Entry points
(the CLI, bench.py, chip_smoke.py) call `enable_compile_cache` once,
before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

#: <checkout>/.jax_cache — listed in .gitignore.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point the persistent compile cache at a fixed directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache is kept at
    `CHECKOUT_CACHE_DIR`.  Returns the directory in use.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
