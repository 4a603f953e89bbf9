"""Test harness: run everything on the CPU backend with a virtual
8-device mesh (SURVEY.md §4 'distributed testing without a cluster'),
mirroring the reference's CuDevice CPU fallback that lets its whole test
suite run GPU-less (ref: src/cudamatrix/cu-device.cc).  The CPU backend
policy (core.backend.backend_policy) keeps float32 storage and default
precision, so the tests are exact oracles.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# pinned in config as well as by JAX_PLATFORMS; must precede backend
# init.  The persistent compile cache stays off: an entry point called
# in-process (cli.main) must not make tests depend on cache state.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
