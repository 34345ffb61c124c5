"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-chip sharded paths can be exercised without a TPU pod.  Must set the
environment before the first jax import."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the shell may pin a TPU here
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the env var alone can be overridden by preinstalled TPU plugins; the
# config update is authoritative
jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spasm_tpu.utils.hostmem import tune_host_malloc

# this VM's first-touch page faults are ~1000x slower than warm pages;
# keep large temporaries heap-resident (utils/hostmem.py)
tune_host_malloc()

import numpy as np
import pytest

# persistent XLA compilation cache: dense-kernel compiles dominate test time
jax.config.update("jax_compilation_cache_dir", "/tmp/spasm_tpu_jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skipped without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
