"""Persistent XLA compilation cache for the entry scripts.

Every scan program (engine rollouts, suite, planners, training chunks)
compiles on first use.  Scripts call :func:`enable_compile_cache` once at
start so a second run loads those executables from disk instead of
recompiling them.  The library itself never calls it: importing
``pymgrid_tpu`` changes no JAX configuration.
"""
import os
from pathlib import Path

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

# fixed path inside the checkout: the directory is part of the cache key, so
# a temporary or per-process path would never hit
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``.
    Returns the directory in use.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
