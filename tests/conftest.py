"""Test configuration: run everything on the CPU, as a virtual 8-device mesh.

The suite runs with `JAX_PLATFORMS=cpu`. Multi-device sharding logic is
tested the standard JAX way — with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (see SURVEY.md §4) — so
the mesh, shard_map and collective paths run without a multi-GPU host.
The program itself runs on the GPU through `python chip_smoke.py` (one
card) and `python chip_smoke.py --cards 4` (the four-card mesh).

Markers (registered below):
- `requires_reference`: needs the reference repository's data under
  /root/reference (FLIR frames, stored calibrations); skipped inside a
  fixture when that directory is absent.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# pinned at the config level too, so a preset JAX_PLATFORMS in the caller's
# environment cannot move unplaced arrays off the CPU mesh
jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: XLA:CPU compiles dominate the suite, and a
# warm cache cuts reruns to a fraction. JAX_COMPILATION_CACHE_DIR wins
# when set; otherwise the cache lives under the system temp directory.
import tempfile  # noqa: E402

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(tempfile.gettempdir(), "stereomatch_jax_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables when a module finishes.

    XLA:CPU's backend_compile has been seen to segfault deep into a
    long single-process run (a compile-state accumulation bug in the
    backend, not in this code). Modules share almost no jitted programs,
    so dropping the caches between modules costs little and keeps the
    per-process accumulation far from the crash threshold."""
    yield
    import gc

    import jax as _jax

    _jax.clear_caches()
    gc.collect()  # drop executables still held via module-level jits


@pytest.fixture()
def rng():
    """Function-scoped: every test gets the SAME fresh stream, so inputs
    do not depend on which other tests ran first (a session-scoped shared
    generator made one banded-SGBM near-tie input appear only in full-suite
    order and nowhere else)."""
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_reference: needs the reference repository's data under "
        f"{REFERENCE}; skipped when it is absent",
    )


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


def require_reference() -> None:
    """Skip the calling test or fixture when the reference data is absent.
    Fixtures of module or session scope that load the data call this
    first: they are set up before the function-scoped check below."""
    if not reference_available():
        pytest.skip(f"reference data not mounted at {REFERENCE}")


@pytest.fixture(autouse=True)
def _skip_without_reference(request):
    """Decided per test, at run time: collection is the same on every
    worker whether or not the data is mounted."""
    if request.node.get_closest_marker("requires_reference"):
        require_reference()


@pytest.fixture(scope="session")
def flir_pair():
    """One bundled FLIR stereo pair at reduced resolution (fast tests)."""
    from stereomatch_tpu.io import load_image

    require_reference()
    left = load_image(f"{REFERENCE}/build/000020_191400042.jpg")
    right = load_image(f"{REFERENCE}/build/000020_191400039.jpg")
    # downsample 4x for test speed
    return left[::4, ::4], right[::4, ::4]
