"""Pytest root conftest.

Tests run on the CPU with 8 virtual XLA host devices so the multi-chip
sharding paths (tyleri_tpu.parallel) are exercised without a GPU.  These env
vars must be set before the first ``import jax`` anywhere in the test
process, which is why this lives in the repo-root conftest.

Tests marked ``gpu`` need an NVIDIA GPU (the compiled visibility kernel has
no CPU form); they skip elsewhere.  Run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Persistent compile cache (the framework's pipeline-cache analog) so repeated
# test runs skip XLA compilation: JAX_COMPILATION_CACHE_DIR when set, else
# the checkout's .jax_cache.
import jax  # noqa: E402

from tyleri_tpu.device.pipeline_cache import default_directory  # noqa: E402
from tyleri_tpu.utils.cache_hardening import install as _harden_cache  # noqa: E402

jax.config.update("jax_compilation_cache_dir", default_directory())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# jax's cache writer is not atomic; concurrent test workers sharing the
# cache directory can tear entries.  Harden it.
_harden_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other backends")


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")
