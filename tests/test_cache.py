"""Persistent compile cache location: ``JAX_COMPILATION_CACHE_DIR`` when set
(and then no directory is set in code), else ``<checkout>/.jax_cache``."""

import os

import jax
import pytest

from fluidsim_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_dir_is_used_and_not_overridden(monkeypatch, tmp_path, updates):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "cc"))
    assert cache.enable_compilation_cache() == str(tmp_path / "cc")
    assert "jax_compilation_cache_dir" not in updates


def test_default_dir_is_the_checkout(monkeypatch, updates):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.enable_compilation_cache()
    assert path == cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == path


@pytest.mark.parametrize("env_set", [True, False])
def test_every_compile_is_cached(monkeypatch, tmp_path, updates, env_set):
    if env_set:
        monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
    cache.enable_compilation_cache()
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0
    assert updates["jax_persistent_cache_min_entry_size_bytes"] == -1
