"""Test configuration: CPU with an 8-device virtual mesh by default.

Sharding paths are validated on a virtual host-platform mesh. Tests marked
`gpu` need the card; run them there with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` (one process, no -n).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)

# persistent compile cache: makes reruns and cross-worker recompiles cheap
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

# VMA-exhaustion guard: one pytest process compiling the whole suite
# accumulates ~350 VMAs per live executable (XLA CPU code pages + mmap'd
# allocations) and can cross the kernel's vm.max_map_count (65,530
# default) — mmap starts failing and XLA segfaults mid-compile. Dropping
# each module's executables caps the live set; the persistent cache makes
# any cross-module recompiles cheap.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
