"""
Where the persistent compilation cache lives: ``JAX_COMPILATION_CACHE_DIR``
when it is set (nothing else is set), otherwise the fixed
``<checkout>/.jax_cache`` — for library entry points and the CLI alike.
"""

import os

import pytest

import jax

from beat_tpu import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cache_dir(monkeypatch):
    """No cache chosen yet: env unset, config cleared (restored after)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_default_is_checkout_dot_jax_cache():
    assert compile_cache.default_cache_dir() == os.path.join(CHECKOUT,
                                                             ".jax_cache")


def test_env_set_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "mine"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_compile_cache() == str(
        tmp_path / "mine")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "mine").exists()


def test_env_unset_uses_checkout(no_cache_dir):
    assert compile_cache.enable_persistent_compile_cache() == \
        compile_cache.default_cache_dir()
    assert jax.config.jax_compilation_cache_dir == \
        compile_cache.default_cache_dir()


def test_cli_enables_the_same_cache(no_cache_dir, capsys):
    from beat_tpu.apps import cli

    assert cli.main([]) == 1       # no subcommand: help, exit 1
    assert jax.config.jax_compilation_cache_dir == \
        compile_cache.default_cache_dir()
