"""The compile-cache helper shared by every entry point
(mixlab_tpu/utils/platform.py)."""

import sys
import types

import pytest

from mixlab_tpu.utils import platform


@pytest.fixture
def fake_jax(monkeypatch):
    """A stand-in for an imported jax that records config updates, so the
    test process's own compile cache is left alone."""
    updates = {}
    fake = types.SimpleNamespace(config=types.SimpleNamespace(
        update=lambda name, value: updates.__setitem__(name, value)))
    monkeypatch.setitem(sys.modules, "jax", fake)
    return updates


def test_compile_cache_follows_the_variable(monkeypatch, fake_jax, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert fake_jax == {"jax_compilation_cache_dir": str(tmp_path)}
    assert platform.os.environ["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)


def test_compile_cache_defaults_to_the_checkout(monkeypatch, fake_jax):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(platform.CHECKOUT / ".jax_cache")
    assert platform.enable_compile_cache() == want
    assert fake_jax == {"jax_compilation_cache_dir": want}
    # exported, so fleet workers started from here inherit the same cache
    assert platform.os.environ["JAX_COMPILATION_CACHE_DIR"] == want
    assert (platform.CHECKOUT / "mixlab_tpu").is_dir()
