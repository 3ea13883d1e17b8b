"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding paths
are validated without accelerators) with float64 enabled so parity
oracles against the reference's f64 NumPy semantics are meaningful.
Production GPU runs use float32 — the library itself is
dtype-polymorphic. Tests marked ``gpu`` start a process of their own on
the card and skip where there is none.
"""

import os
import shutil
import subprocess

# Must be set before jax initialises any backend.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.default_backend() == "cpu", "tests must run on the CPU mesh"
assert jax.device_count() == 8, "tests expect an 8-device virtual CPU mesh"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Golden oracle data (GeoStats.jl ordinary kriging, the Atlantic ellipse
# fits, the known-good non-stationary covariance) is vendored into
# tests/data so the oracle tests can never silently skip.
REFERENCE_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def rng():
    return np.random.default_rng(31900)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU answers ``nvidia-smi -L``; decided when
    the test runs, never at import or collection."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU listed by nvidia-smi")


def reference_data_path(name: str) -> str:
    return os.path.join(REFERENCE_DATA, name)


requires_reference_data = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_DATA),
    reason="golden data not vendored",
)
