"""Persistent compile cache wiring (common/cache.py): where the cache
lives and how it is turned off."""

import jax

from dorylus_tpu.common import cache as cache_mod
from dorylus_tpu.common.cache import DEFAULT_DIR, enable_compile_cache


def test_enable_sets_jax_config(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to the one fixed,
    gitignored directory inside the checkout."""
    monkeypatch.setattr(cache_mod, "_enabled_path", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache()
    assert got == str(DEFAULT_DIR)
    assert DEFAULT_DIR.parent == cache_mod.Path(__file__).resolve().parents[1]
    assert jax.config.jax_compilation_cache_dir == got
    assert jax.config.jax_enable_compilation_cache
    assert not jax.config.jax_raise_persistent_cache_errors
    gitignore = (DEFAULT_DIR.parent / ".gitignore").read_text().split()
    assert f"{DEFAULT_DIR.name}/" in gitignore
    # Idempotent: a second call is a no-op.
    assert enable_compile_cache() == got


def test_off_disables(monkeypatch, tmp_path):
    monkeypatch.setattr(cache_mod, "_enabled_path", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache(False) is None
    assert not jax.config.jax_enable_compilation_cache
    # Turning it back on restores it.
    assert enable_compile_cache(True) == str(tmp_path)
    assert jax.config.jax_enable_compilation_cache


def test_env_dir_resolution(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the directory used."""
    monkeypatch.setattr(cache_mod, "_enabled_path", None)
    d = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    assert enable_compile_cache() == d
    assert jax.config.jax_compilation_cache_dir == d
