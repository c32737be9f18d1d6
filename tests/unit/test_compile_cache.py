"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR when set, and nothing
else set; otherwise <checkout>/.jax_cache."""
import os

import jax
import pytest

from asr_craft.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_wins_and_nothing_is_set(restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert cc.enable_compile_cache(env) == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_default_is_fixed_dir_in_checkout(restore_cache_dir, env):
    path = cc.enable_compile_cache(env)
    assert path == os.path.join(cc.CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(cc.CHECKOUT, "chip_smoke.py"))
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_is_gitignored():
    with open(os.path.join(cc.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
