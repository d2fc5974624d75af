"""The compilation-cache rule: JAX_COMPILATION_CACHE_DIR when set, else the
fixed in-checkout .jax_cache."""

import os
import subprocess
import sys

from grace_jax.utils import compile_cache


def test_cache_dir_uses_env_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
    assert os.path.isdir(os.path.join(compile_cache.CHECKOUT, "grace_jax"))


def test_enable_keeps_the_env_directory(tmp_path):
    """With the variable set, enabling the cache sets no other directory."""
    code = ("import jax; from grace_jax.utils.compile_cache import "
            "enable_compilation_cache as e; p = e(); "
            "print(p, jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=compile_cache.CHECKOUT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]
