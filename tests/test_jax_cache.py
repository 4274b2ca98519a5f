"""The persistent compile cache's location rule (jax_cache.py)."""

from pathlib import Path

import jax

from galileo_sdr_sim_tpu import jax_cache

REPO = Path(__file__).resolve().parent.parent


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.cache_dir() == str(tmp_path)


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert Path(jax_cache.cache_dir()) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_enable_points_jax_at_the_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert jax_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
