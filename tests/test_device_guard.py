"""CPU tests of the device plumbing: the compile-cache rule and the
chip smoke test's refusal to run anywhere but on a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_jax_env():
    import aom_av1_lavish_tpu as pkg
    assert pkg.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    assert pkg.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere",
         "JAX_PLATFORMS": "cuda"}) is None


def test_cache_dir_default_is_checkout():
    import aom_av1_lavish_tpu as pkg
    assert pkg.compile_cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    assert pkg.compile_cache_dir({"JAX_PLATFORMS": "cuda"}) == \
        pkg.DEFAULT_CACHE_DIR


def test_cache_dir_none_for_cpu_runs():
    """CPU runs (the tests) leave no entries in the checkout."""
    import jax
    import aom_av1_lavish_tpu as pkg
    assert pkg.compile_cache_dir({"JAX_PLATFORMS": "cpu"}) is None
    assert jax.config.jax_compilation_cache_dir != pkg.DEFAULT_CACHE_DIR


def test_chip_smoke_guard_refuses_cpu():
    import jax
    import chip_smoke
    with pytest.raises(SystemExit):
        chip_smoke.check_device(jax.devices(), 1)


def test_chip_smoke_fails_without_gpu():
    """Run as the driver runs it: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
