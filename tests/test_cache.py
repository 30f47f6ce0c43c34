"""utils/cache.py: where the persistent compilation cache lives."""

import os

import jax
import pytest

from dsp_asr.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path,
                                         restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_fixed_checkout_dir(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_default_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_empty_env_value_means_unset(monkeypatch, restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
