"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled, so golden tests compare against the NumPy/SciPy oracle at
full precision (SURVEY.md §4).  The GPU path is exercised by chip_smoke.py
and bench.py, not the unit suite."""

import gc
import hashlib
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)

from pyaudiolocalization_tpu.utils.compile_cache import enable_compile_cache


def _cpu_fingerprint() -> str:
    """Hash of the host CPU's feature flags.  XLA:CPU cache entries are AOT
    machine code, and loading a blob compiled on a different
    microarchitecture SEGFAULTED the suite (exit 139 inside
    backend_compile_and_load, "Machine type used for XLA:CPU compilation
    doesn't match"), so the default cache directory is per microarch."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(" ".join(sorted(
                        line.split()[2:])).encode()).hexdigest()[:10]
    except OSError:
        return "noinfo"
    return "noflags"


# Persistent compile cache: the suite is compile-dominated (big prefix-scan
# filter graphs, sweep pipelines) and re-runs identical shapes, so cached
# reruns cut wall time several-fold.  JAX_COMPILATION_CACHE_DIR wins when
# set; otherwise .jax_cache/cpu-<fingerprint> in the checkout.  0.1 s: the
# 0.1-0.3 s compiles also become disk loads — the module-boundary
# jax.clear_caches() below re-pays them otherwise.
enable_compile_cache(subdir=f"cpu-{_cpu_fingerprint()}",
                     min_compile_time_secs=0.1)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multihost: two-process distributed tests (run with -m multihost)")


def pytest_collection_modifyitems(config, items):
    # The multihost tests spawn two cold JAX processes (~1 min); keep them
    # out of the default suite — select explicitly with `-m multihost`.
    if "multihost" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(reason="multihost: run with -m multihost")
    for item in items:
        if "multihost" in item.keywords:
            item.add_marker(skip)


def _raise_map_count_limit() -> bool:
    """Every XLA:CPU JIT'd executable costs several mmaps, and the full
    suite compiles enough of them to EXHAUST the kernel's default
    vm.max_map_count (65,530) — at which point LLVM segfaults on a failed
    mmap: exit 139 at ~93% of the suite, inside backend_compile_and_load
    of a trivial eager op, with /proc/<pid>/maps measured at 64,341 lines
    right before death (2026-08-19; adding any ~4 tests tipped it over,
    which is why the crash first looked correlated with one test file).
    Raise the limit when the container allows it (root namespaces do);
    _maps_guard is the fallback."""
    try:
        with open("/proc/sys/vm/max_map_count", "r+") as f:
            if int(f.read().strip()) < 1 << 20:
                f.seek(0)
                f.write(str(1 << 20))
        return True
    except (OSError, ValueError):
        return False


_MAPS_RAISED = _raise_map_count_limit()


@pytest.fixture(scope="module", autouse=True)
def _gc_freeze_between_modules():
    """Bound Python GC cost: by late modules the process holds millions of
    long-lived objects (jaxprs, compiled executables, test-module constants),
    and every gen-2 collection rescans them all — measured +76 s over the
    full suite (684 s -> 608 s with gc off).  Instead of disabling the
    collector, collect at each module boundary and freeze the survivors into
    the permanent generation, so gen-2 scans only ever cover the current
    module's allocations.

    Also drop jax's executable caches once the process carries too many
    LIVE compiled executables — measured 2026-08-21: XLA:CPU per-compile
    cost GROWS with the live-executable count (165 -> 313 ms/compile from
    0 to 1200 live in a minimal loop; in the full suite the late modules'
    compile-heavy tests inflated 3-7x, 82 s -> 257 s for the worst), and
    jax.clear_caches() restores it.  The map count is the proxy (each
    executable costs ~10 maps); 25k maps ~ 2k live executables, the point
    where inflation passes ~+50%.  Re-compiles after a clear are mostly
    persistent-cache disk loads (min_compile_time lowered to 0.1 s).  The
    same check at the old 48k wall doubles as the mmap-exhaustion guard
    when the limit could not be raised (_raise_map_count_limit)."""
    try:
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
    except OSError:
        n_maps = 0
    if n_maps > 25_000:
        jax.clear_caches()
    gc.collect()
    gc.freeze()
    yield


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
