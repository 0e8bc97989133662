"""Persistent JAX compilation cache for the entry points.

The first compile of a 64k-particle step takes tens of seconds; a
persistent cache makes repeat runs of the same program start at once.
"""

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

# fixed path inside the checkout (listed in .gitignore): the directory is
# part of the cache's key, so a path that moves never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache():
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
