"""The entry points' compile-cache rule (utils/compile_cache.py)."""

from pathlib import Path

import jax

from tokenhawk_tpu.utils import compile_cache


def _capture(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    return updates


def test_environment_directory_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    updates = _capture(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == []


def test_gpu_without_environment_uses_the_checkout_directory(monkeypatch,
                                                             tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", tmp_path / ".jax_cache")
    updates = _capture(monkeypatch)
    got = compile_cache.enable_compile_cache()
    assert got == str(tmp_path / ".jax_cache") and Path(got).is_dir()
    assert updates == [("jax_compilation_cache_dir", got)]


def test_cpu_keeps_no_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _capture(monkeypatch)
    assert compile_cache.enable_compile_cache() is None
    assert updates == []


def test_default_directory_is_in_the_checkout_and_ignored():
    root = Path(__file__).resolve().parents[1]
    assert compile_cache.DEFAULT_DIR == root / ".jax_cache"
    ignored = (root / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored
