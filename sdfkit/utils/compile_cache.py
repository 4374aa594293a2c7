"""Where the entry points (chip_smoke.py, bench.py, tools/view.py) keep JAX's
persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at start-up and
nothing here overrides it. Otherwise the cache goes to one fixed directory
inside the checkout, ``.jax_cache/`` (listed in ``.gitignore``): the path is
part of the cache key, so it must not vary between runs.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def use_compile_cache(environ=os.environ) -> str:
    """Point JAX at the compile cache; returns the directory in use."""
    configured = environ.get("JAX_COMPILATION_CACHE_DIR")
    if configured:
        return configured
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
