"""JAX's persistent compilation cache at one fixed place.

The cache key includes the cache directory, so a directory that moves
between runs never hits.  :func:`enable_compile_cache` is called by the
programs (``cgx.cli.main``, ``bench.py``, ``chip_smoke.py``), never at
``import cgx``.
"""
from __future__ import annotations

import os

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

# <checkout>/.cache/jax — the checkout is the directory holding the package.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache", "jax")


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself; nothing is set here), else ``<checkout>/.cache/jax``.  Returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
