"""Test session config: force an 8-virtual-device CPU JAX backend.

Per SURVEY.md §4, mesh/sharding tests run deterministically on a fake
8-device CPU platform; kernels are parity-tested on the same backend
(the GPU is exercised by chip_smoke.py, not the unit suite).
Must run before anything imports jax.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: the suite is dominated by XLA compiles of the
# fixpoint kernels; cache across runs.
from particle_col_image_segmentation_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

# Pin the CPU backend in the config too, so the suite stays hermetic and the
# 8-virtual-device mesh works even where a GPU plugin is installed.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live compiled executables between test modules.

    One pytest process accumulates every module's jitted executables; at
    roughly the full suite's compile count the jaxlib 0.9.0 CPU compiler
    segfaults nondeterministically inside ``backend_compile_and_load``
    (reproduced twice at the same test with a fresh on-disk cache; any
    alphabetical half of the suite passes).  Clearing per module keeps the
    live-executable population bounded; the persistent on-disk cache makes
    the recompiles cheap."""
    yield
    jax.clear_caches()
