"""Compile-cache placement of the entry points (sdfkit/utils/compile_cache)."""

import jax

from sdfkit.utils import compile_cache


def _restore(value):
    jax.config.update("jax_compilation_cache_dir", value)


def test_variable_set_is_left_alone():
    before = jax.config.jax_compilation_cache_dir
    used = compile_cache.use_compile_cache(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    )
    assert used == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_variable_unset_uses_the_fixed_checkout_path():
    before = jax.config.jax_compilation_cache_dir
    try:
        used = compile_cache.use_compile_cache({})
        assert used == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == used
        # One fixed directory inside the checkout: no temp name, no PID.
        assert used.endswith("/.jax_cache")
        assert used.startswith(compile_cache.CHECKOUT)
        assert compile_cache.use_compile_cache({}) == used
    finally:
        _restore(before)
