"""Test environment: virtual 8-device CPU mesh.

JAX_PLATFORMS=cpu keeps the suite off any accelerator; the config is
also forced after importing jax (before any backend use), in case the
environment variable was already read otherwise.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent compilation cache: repeated suite runs skip XLA compiles
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: at-scale tests (hundreds of MB of IO)"
    )
