"""Test configuration: run JAX on a virtual 8-device CPU mesh.

JAX_PLATFORMS defaults to cpu, and the CPU backend gets 8 virtual host
devices for the sharding tests. Tests that need the card carry the ``gpu``
marker and the ``gpu`` fixture below, which skips them when JAX finds no
GPU; run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py``.
"""

import os
import pathlib
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# persistent compile cache: decoder programs take minutes to build on the
# CPU backend and dominate suite time; cached recompiles are near-instant
from uwspr_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE_DIR = pathlib.Path("/root/reference")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided
    here, at run time, so every worker collects the same tests."""
    import jax
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return devices[0]


@pytest.fixture(scope="session")
def reference_examples():
    d = REFERENCE_DIR / "examples"
    if not d.exists():
        pytest.skip("reference examples not available")
    return d
