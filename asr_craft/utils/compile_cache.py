"""One place that decides where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
else is set.  Otherwise the cache lives at ``<checkout>/.jax_cache`` (listed
in ``.gitignore``): a fixed path, because the path is part of the cache key
and a directory that moves never hits.  Both CLIs, ``bench.py`` and
``chip_smoke.py`` call :func:`enable_compile_cache` before they compile.
"""
from __future__ import annotations

import os

import jax

_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(environ=os.environ) -> str:
    """Apply the rule above; returns the directory in use."""
    if environ.get(_ENV):
        return environ[_ENV]
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
