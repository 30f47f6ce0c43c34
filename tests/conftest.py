"""Test configuration.

Tests run on CPU with 8 fake XLA devices so the multi-device sharding
paths (SURVEY.md §4.4) are exercised without several GPUs.  Must set
the environment before jax is first imported anywhere.

Set DSP_ASR_DEVICE_TESTS=1 to keep the real backend instead (for the
``gpu``-marked tests, tests/test_gpu_device.py, on a GPU).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("DSP_ASR_DEVICE_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    # pin the platform in jax's config too, in case jax was imported
    # (and its backend chosen) before this file ran
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402

# Every XLA:CPU executable JIT-compiled in this single pytest process
# holds several mmap regions until it is freed; at the round-5 suite
# size (~489 tests) the process crosses vm.max_map_count (65,530 here)
# near the 90% mark and the NEXT compile segfaults inside XLA
# (measured: maps grow 27k -> 42k between 14% and 58% of the run, and
# three consecutive full-suite runs died at the same innocent test).
# Dropping jax's executable caches every N tests keeps the map count
# bounded; the handful of recompiles costs ~1 min suite-wide.
_CLEAR_EVERY = 40
_test_counter = [0]


@pytest.fixture(autouse=True)
def _bound_xla_mmap_growth():
    yield
    _test_counter[0] += 1
    if _test_counter[0] % _CLEAR_EVERY == 0:
        import jax

        if jax.default_backend() == "cpu":
            jax.clear_caches()
