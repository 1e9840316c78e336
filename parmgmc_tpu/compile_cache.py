"""Persistent XLA compilation cache for the repository's entry points.

A cold process compiles every program it runs; at the flagship sizes
that is most of a short run.  ``chip_smoke.py``, ``bench.py`` and the
examples call :func:`enable_compile_cache` from their ``__main__``
blocks, so repeated runs in one checkout reuse what an earlier run
compiled.  Importing the package sets nothing.
"""

from __future__ import annotations

import os

__all__ = ["REPO_CACHE_DIR", "cache_dir", "enable_compile_cache"]

# a fixed path: JAX keys cache entries on it, so a moving directory
# would never hit
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir(environ=os.environ) -> "str | None":
    """The directory this module would set, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``<repo>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` already names a directory.
    Returns the directory in use."""
    import jax

    path = cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
