"""The persistent compilation cache's choice of directory."""

import os

import jax

from htk_jax.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    assert cc.cache_dir() == cc.DEFAULT_DIR == os.path.join(REPO,
                                                            ".jax_cache")


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)


def test_enable_sets_jax_only_without_env(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setenv(cc.ENV, str(tmp_path))
        assert cc.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None
        monkeypatch.delenv(cc.ENV)
        assert cc.enable_compile_cache() == cc.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
