import os

# Tests run on JAX's CPU backend with an 8-device virtual mesh, so
# multi-device sharding is checked without cards; the GPU path is checked
# by chip_smoke.py. XLA_FLAGS must be set before the first backend init.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# persistent compile cache (see compile_cache.py): test reruns skip XLA
# recompiles of anything that took at least half a second
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

from manticoresearch_tpu.compile_cache import configure_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
configure_compile_cache()


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free compiled executables after each module.

    Every XLA:CPU JIT executable pins ~3 small mmaps while jax's caches
    keep it alive; a full-suite run accumulates tens of thousands,
    crosses vm.max_map_count (65530), LLVM's section mmap fails
    ("Cannot allocate memory"), and the failed-compile path leaves a
    stale eh_frame registration that segfaults the next C++ unwind
    (observed: deterministic libgcc crash ~250 tests in). Clearing per
    module keeps the map count bounded; the persistent compile cache
    makes recompiles cheap."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: opt-in scale tests (deselect by default)")


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest
    if config.getoption("-m"):
        return
    skip = _pytest.mark.skip(reason="slow scale test: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
