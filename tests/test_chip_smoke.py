"""The GPU entry points' host-side behaviour: the compile-cache location
and chip_smoke.py's refusal of a non-GPU backend and phase selection."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from top_down_renderer_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert p.returncode != 0
    assert "not the GPU" in p.stderr
    for line in p.stdout.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line)


def test_chip_smoke_phase_selection():
    assert chip_smoke.phases_for(1) == ["device", "parity", "node"]
    # the four-device option runs the mesh path and nothing else
    assert chip_smoke.phases_for(4) == ["mesh"]
    with pytest.raises(SystemExit):
        chip_smoke.main(["--devices", "2"])
