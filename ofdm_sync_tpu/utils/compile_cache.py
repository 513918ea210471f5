"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os
from pathlib import Path

#: the fixed default: a moving directory would never hit (the path is part
#: of the cache key), and `.gitignore` lists it
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_compile_cache"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads the
    variable itself, so nothing else is set), otherwise `DEFAULT_DIR`.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_DIR)
