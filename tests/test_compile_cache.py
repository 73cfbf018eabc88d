"""The persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says, or else at a fixed path in the checkout — never a temporary one."""

import os

import jax

from parallel_nbody_tpu.utils import compile_cache


def _cache_dir():
    return jax.config.jax_compilation_cache_dir


def test_env_variable_wins_and_nothing_is_configured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = _cache_dir()
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert _cache_dir() == before


def test_unset_variable_points_at_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = _cache_dir()
    try:
        path = compile_cache.enable_compile_cache()
        assert path == _cache_dir()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
