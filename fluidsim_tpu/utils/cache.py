"""Persistent XLA compilation cache.

Compiling the FLIP step at 129^3 takes far longer than a frame; the
reference pays nothing comparable (g++ -O3 once, ``run.sh:3-5``).  JAX's
persistent compilation cache lets every process after the first load the
compiled programs from disk.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no other directory.  Otherwise the cache lives at the
fixed path ``<checkout>/.jax_cache``: the path is part of the cache key, so
a directory that moved would never hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Enable the on-disk compile cache (safe before or after importing jax).

    Returns the directory in use.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every compile, however small: disk is cheap next to a recompile.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
