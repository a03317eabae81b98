"""Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when it is
set (JAX reads it itself and nothing is set in code), otherwise the fixed
``.jax_cache/`` of the checkout (``gsmvi_jax.config.use_compile_cache``,
used by ``bench.py`` and ``chip_smoke.py``)."""

import os
import subprocess
import sys

import jax
import pytest

from gsmvi_jax.config import use_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = """
import sys
import jax, jax.numpy as jnp
from gsmvi_jax.config import use_compile_cache
print(use_compile_cache(sys.argv[1]))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((8, 8))))
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_lands_only_in_its_one_place(tmp_path, env_set):
    root = tmp_path / "checkout"
    env_dir = tmp_path / "env_cache"
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _COMPILE, str(root)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    local = root / ".jax_cache"
    if env_set:
        assert out.stdout.split()[0] == str(env_dir)
        assert any(env_dir.iterdir())
        assert not local.exists()
    else:
        assert out.stdout.split()[0] == str(local)
        assert any(local.iterdir())
        assert not env_dir.exists()


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_returned_and_nothing_is_set(monkeypatch, tmp_path,
                                                restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_the_checkouts_jax_cache(monkeypatch, tmp_path,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = use_compile_cache(str(tmp_path))
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_bench_uses_the_checkout_cache(monkeypatch):
    import bench
    import gsmvi_jax.config as cfg

    roots = []
    monkeypatch.setattr(cfg, "use_compile_cache", roots.append)
    monkeypatch.setattr(jax.config, "update", lambda *args: None)
    bench._setup_cache()
    assert roots == [REPO]
