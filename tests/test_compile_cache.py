"""Persistent compilation cache wiring (utils/compile_cache.py).

Rule under test: with ``JAX_COMPILATION_CACHE_DIR`` set the cache lands
there and nowhere else; unset, it lands at one fixed directory inside the
checkout.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu.utils import compile_cache


@pytest.fixture(autouse=True)
def _pristine_cache_singleton():
    """Fully tear down the persistent cache after each test.

    Resetting ``jax_compilation_cache_dir`` to None is NOT enough: jax keeps
    a module-level cache singleton that, once initialized, keeps attempting
    writes for every later compile in the process — against this test's
    now-deleted tmp_path.  In an in-process full-suite run (the coverage
    gate's ``-n 0``) one of those stray ``executable.serialize()`` calls
    segfaults inside jaxlib.
    """
    yield
    jax.config.update("jax_compilation_cache_dir", None)
    from jax._src import compilation_cache as _cc

    _cc.reset_cache()


def _compile_something():
    @jax.jit
    def f(x):
        return jnp.sin(x) @ x.T

    f(jnp.ones((64, 64))).block_until_ready()


def test_enable_sets_config_and_persists(monkeypatch, tmp_path):
    d = str(tmp_path / "jaxcache")
    monkeypatch.setenv(compile_cache.ENV_VAR, d)
    got = compile_cache.enable_compilation_cache()
    assert got == d and os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d
    _compile_something()
    assert os.listdir(d), "compiled executable was not persisted"


def test_default_dir_honors_env(monkeypatch, tmp_path):
    """With the variable set, the in-checkout directory is never touched."""
    env_dir = str(tmp_path / "envcache")
    repo_dir = str(tmp_path / "repo_cache")
    monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    monkeypatch.setattr(compile_cache, "REPO_CACHE_DIR", repo_dir)
    assert compile_cache.enable_compilation_cache() == env_dir
    _compile_something()
    assert os.listdir(env_dir)
    assert not os.path.exists(repo_dir)


def test_unset_env_uses_checkout_dir(monkeypatch, tmp_path):
    """Unset, the cache goes to the fixed ``<checkout>/.jax_cache``."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))
    assert compile_cache.REPO_CACHE_DIR == os.path.join(os.path.dirname(repo_root), ".jax_cache")
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    repo_dir = str(tmp_path / "repo_cache")
    monkeypatch.setattr(compile_cache, "REPO_CACHE_DIR", repo_dir)
    assert compile_cache.enable_compilation_cache() == repo_dir
    assert jax.config.jax_compilation_cache_dir == repo_dir
    _compile_something()
    assert os.listdir(repo_dir)
