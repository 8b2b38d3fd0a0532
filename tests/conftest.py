"""Test configuration: an 8-device virtual CPU platform, so sharding
tests run without accelerators (the multi-device JAX testing recipe).

``MF_TEST_DEVICE=gpu`` (set by chip_smoke.py, which runs the ``gpu``
tests and the golden replay in its own process on the card) leaves the
platform alone.  Whether a card exists is decided inside the ``gpu``
fixture, never at import or collection time.
"""

import os

_ON_DEVICE = os.environ.get("MF_TEST_DEVICE") == "gpu"

if not _ON_DEVICE:
    # must be set before jax is imported anywhere
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test runs on; skips where there is
    none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run through chip_smoke.py on the card")
    return dev


# ---------------------------------------------------------------------------
# Per-module compiled-program release.  The full suite compiles thousands of
# XLA:CPU executables (460+ tests, 8-device meshes);
# each loaded executable holds mmapped JIT code regions, and the process
# crossed the kernel's vm.max_map_count (65530 mappings) at ~test 461 —
# reproducibly segfaulting inside backend_compile_and_load (VERDICT r3
# weakness 1; telemetry in tests/.resource_log.jsonl at MF_TEST_MONITOR=1).
# Dropping the jit caches after each module releases the dead executables
# (later modules recompile what they share — a few small helpers);
# malloc_trim returns the freed arena pages.  MF_TEST_KEEP_CACHES=1
# disables the release for A/B telemetry runs.
# ---------------------------------------------------------------------------
_MONITOR = bool(os.environ.get("MF_TEST_MONITOR"))

if _MONITOR:
    import json
    import threading
    import time

    _t0 = time.time()
    _log_path = os.path.join(os.path.dirname(__file__), ".resource_log.jsonl")

    def _proc_stats():
        rss_kb = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
                    break
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
        n_fds = len(os.listdir("/proc/self/fd"))
        return {
            "rss_mb": rss_kb // 1024,
            "maps": n_maps,
            "fds": n_fds,
            "threads": threading.active_count(),
            "live_arrays": len(jax.live_arrays()),
            "t": round(time.time() - _t0, 1),
        }

    def _log_stats(module, **extra):
        rec = {"module": module, **extra, **_proc_stats()}
        with open(_log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


if not os.environ.get("MF_TEST_KEEP_CACHES"):

    @pytest.fixture(autouse=True, scope="module")
    def _release_compiled_programs(request):
        yield
        if _MONITOR:
            _log_stats(request.module.__name__)
        jax.clear_caches()
        try:
            import ctypes
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except Exception:
            pass
        if _MONITOR:
            _log_stats(request.module.__name__, post_clear=True)

elif _MONITOR:

    @pytest.fixture(autouse=True, scope="module")
    def _resource_monitor(request):
        yield
        _log_stats(request.module.__name__)
