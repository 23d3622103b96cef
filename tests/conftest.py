"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's test strategy of exercising parallel paths without
special hardware (the reference A/Bs threaded-vs-unthreaded on one machine;
we A/B sharded-vs-single-device on virtual devices).
"""

import os

# must be set before jax initializes
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the suite compiles many tiny CPU programs from several workers at once;
# the persistent cache (art_jax._jaxinit) is for device runs, so keep the
# test session from writing into it (tests/test_jaxinit.py checks the
# cache rule in fresh processes)
jax.config.update("jax_enable_compilation_cache", False)

import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
GOLDEN_BUILD = REPO / "tools" / "build_golden.sh"


@pytest.fixture(scope="session")
def golden_bin():
    """Path to the golden_dump harness built against the C reference,
    or skip if the reference/toolchain is unavailable."""
    try:
        out = subprocess.run(["sh", str(GOLDEN_BUILD)], capture_output=True,
                             text=True, check=True).stdout.strip()
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("C reference harness unavailable")
    path = Path(out) / "golden_dump"
    if not path.exists():
        pytest.skip("golden_dump missing")
    return path


@pytest.fixture(scope="session")
def golden_bin64(golden_bin):
    return golden_bin.parent / "golden_dump64"
