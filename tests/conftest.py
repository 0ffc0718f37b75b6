"""Test harness config: an 8-device virtual CPU platform by default.

Per SURVEY.md §4 item 4, sharding/mesh logic is tested on a virtual CPU mesh
(`xla_force_host_platform_device_count=8`). The CUDA kernels have no
interpret mode: their tests carry the ``gpu`` marker and skip here. On a
machine with a card, ``NADAVCA_TEST_PLATFORM=gpu python -m pytest -m gpu
tests/test_cuda_dp.py`` runs them (chip_smoke.py does).

JAX_PLATFORMS is overwritten, not defaulted, and the config is updated after
import as well, so an environment that presets another platform cannot
silently move the suite off the CPU.
"""

import os

PLATFORM = os.environ.get("NADAVCA_TEST_PLATFORM", "cpu")
# JAX names the platform "cuda" when choosing it and "gpu" when reporting it
JAX_PLATFORM = {"gpu": "cuda"}.get(PLATFORM, PLATFORM)
os.environ["JAX_PLATFORMS"] = JAX_PLATFORM
if PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", JAX_PLATFORM)

import numpy as np
import pytest

from nadavca_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

assert jax.default_backend() == PLATFORM, jax.default_backend()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
