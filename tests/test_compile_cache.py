"""The one compilation-cache location (utils/cache.py)."""

import os

import jax

from argon_monte_carlo_tpu.utils import cache


def test_env_var_wins_and_code_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper must not override it.
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(repo, ".jax_cache")
    assert cache.compile_cache_dir() == expected
    assert cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert str(os.getpid()) not in expected


def test_default_path_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = {ln.strip() for ln in f}
    assert ".jax_cache/" in ignored
