"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and this
module sets nothing else. Otherwise the cache lives in a fixed `.jax_cache/`
at the root of the checkout, derived from this file's location, so every
process of one checkout (chip_smoke.py, bench.py, the examples) shares it
and the path, which is part of the cache key, never moves.
"""

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
