"""Persistent XLA compilation cache at a fixed place.

A cold process recompiles every program; JAX's persistent cache keeps the
compiled executables on disk so the next process finds them.  The cache
directory is part of the lookup, so it must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is configured here.  Otherwise the cache lives in ``.jax_cache``
    at the root of the checkout.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
