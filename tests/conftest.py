"""Test configuration: run everything on a virtual 8-device CPU mesh.

XLA_FLAGS must carry the virtual device count before the CPU client first
initializes, and the platform is pinned with ``jax.config.update`` as well as
the ``JAX_PLATFORMS=cpu`` environment the suite is run with.

float64 is enabled so oracle tests can compare against numpy references at
full precision; library code never assumes x64.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# --- default-loop taming ------------------------------------------------------
# Everything measured >10 s on a 4-core CPU is marked `slow` here (one place,
# param-granular) so `-m "not slow"` is a fast default loop. Every engine
# family keeps at least one fast parity representative in the default set —
# the marked ids below are the heavier params of families still covered by
# a cheaper sibling (e.g. Wcycle parity is slow, test/Vcycle/VcycleTrigger
# parity stay).

# whole functions (every param >10 s)
_SLOW_FUNCS = frozenset({
    "test_block_partition.py::test_fmg_block_sharded_matches_single",
    "test_refine3.py::test_refine3_checkpoint_resume",
    "test_orbax_checkpoint.py::test_refine3_resume_through_orbax",
    "test_refine.py::test_tw32_checkpoint_resume_keeps_all_words",
    "test_refine.py::test_bf16_inner_cycles_converge",
    "test_refine.py::test_full_weighting_matches_manual",
})

# single parametrizations (their siblings are fast and stay default)
_SLOW_IDS = frozenset({
    "test_reference_parity.py::test_final_error_matches_reference[Wcycle.txt]",
    "test_dtypes.py::test_both_engines_converge_per_dtype[bfloat16-0.005]",
    "test_compiled.py::test_compiled_matches_interpreted[<lambda>2]",
})


def pytest_collection_modifyitems(items):
    for item in items:
        nodeid = item.nodeid.split("/")[-1]          # strip tests/ prefix
        func = nodeid.split("[")[0]
        if nodeid in _SLOW_IDS or func in _SLOW_FUNCS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _hang_guard():
    """Best-effort watchdog: fail one hung test after 10 minutes instead of
    hanging the whole suite. Python-level waits are signal-interruptible in
    the main thread; C-level blocks may not be, so this is a net, not a
    guarantee."""
    import signal

    if not hasattr(signal, "SIGALRM"):
        yield
        return

    def _raise(signum, frame):
        raise TimeoutError("test exceeded the 600 s hang guard "
                           "(tests/conftest.py::_hang_guard)")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(600)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
